"""Quickstart: serve a small model through the full disaggregated path.

  PYTHONPATH=src python -m repro_torch.examples.quickstart \\
      [--arch granite-3-8b] [--device cpu]

What happens: prompts hit the gateway, an idle prefill accepts (busy ones
reject), the prompt's KVCache is gathered to a contiguous buffer, moved to
a decode instance's paged pool, RecvScatter'd back into blocks, and decode
streams tokens — with real PyTorch compute (the CUDA kernels on the card)
on a reduced config. The port's ``examples/quickstart.py``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.configs import ALIASES, get_config
from repro_torch.device import resolve_device
from repro_torch.serving.cluster import MiniCluster, ServeRequest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=sorted(ALIASES))
    ap.add_argument("--device", default="cuda",
                    help="torch device for params, pools and kernels")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    cfg = get_config(a.arch).reduced()
    print(f"model: {cfg.name} ({cfg.num_layers}L d={cfg.d_model})")

    cluster = MiniCluster(cfg, n_prefill=1, n_decode=1, device=dev)
    rng = np.random.default_rng(0)
    requests = [
        ServeRequest(rid=i,
                     tokens=[int(t) for t in
                             rng.integers(0, cfg.vocab_size, 10 + i)],
                     max_new_tokens=8,
                     on_token=lambda t, i=i: print(f"  [sse rid={i}] {t}"))
        for i in range(3)
    ]
    cluster.run(requests, max_ticks=60)
    for r in requests:
        print(f"request {r.rid}: prompt[{len(r.tokens)}] -> {r.generated}")
    if not all(r.done for r in requests):
        raise RuntimeError("a request did not finish")
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
