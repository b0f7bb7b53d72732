"""Speculative decoding (paper §6.1): a draft model proposes K tokens, the
target verifies them in one pass — lossless for greedy decoding.

  PYTHONPATH=src python -m repro_torch.examples.speculative_decoding \\
      [--device cpu]

The port's ``examples/speculative_decoding.py``: params from
``init_params`` with an explicit seeded generator on the device (seeds 7
and 8, as the JAX script's keys; the numbers differ from JAX's).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.params import init_params
from repro_torch.serving.speculative import SpeculativeDecoder


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device for params, caches and kernels")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_config("granite-3-8b").reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(7),
                         device=dev)
    draft_cfg = cfg.replace(num_layers=1, name="draft-1L")
    draft_params = init_params(
        draft_cfg, torch.Generator(device=dev).manual_seed(8), device=dev)

    rng = np.random.default_rng(2)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, 12)]
    for name, dc, dp in [("perfect draft (self)", cfg, params),
                         ("1-layer draft", draft_cfg, draft_params)]:
        spec = SpeculativeDecoder(cfg, params, dc, dp, k=4)
        with torch.no_grad():
            out = spec.generate(prompt, 16)
        print(f"{name:22s}: acceptance={spec.stats.acceptance:5.1%} "
              f"target_passes={spec.stats.target_steps:2d} "
              f"tokens={out[:8]}...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
