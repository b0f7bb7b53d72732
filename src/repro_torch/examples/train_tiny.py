"""Train a ~100M-param llama-like model for a few hundred steps.

  PYTHONPATH=src python -m repro_torch.examples.train_tiny \\
      [--steps 300] [--device cpu]

(The paper is a serving system — disaggregated_serving is the primary
end-to-end example; this exercises the training substrate: data
pipeline, AdamW, remat, checkpointing.)
The port's ``examples/train_tiny.py``: it calls
``repro_torch.launch.train.main`` with the JAX script's settings (12
layers x d512 over the minicpm vocab, batch 8 x 256, lr 1e-3) and exits
with the launcher's code (0 only if the loss fell).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.launch.train import main as train_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--save", default="results/ckpt_tiny.npz")
    ap.add_argument("--device", default="cuda",
                    help="torch device for params, optimizer state and "
                         "kernels")
    a = ap.parse_args(argv)
    # ~100M params: 12 layers x d512 over the minicpm vocab
    return train_main([
        "--arch", "minicpm-2b", "--reduced",
        "--d-model", "512", "--layers", "12",
        "--steps", str(a.steps), "--batch", "8", "--seq", "256",
        "--lr", "1e-3", "--log-every", "25",
        "--save", a.save, "--device", a.device,
    ])


if __name__ == "__main__":
    sys.exit(main())
