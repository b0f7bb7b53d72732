"""Training launcher: real AdamW steps on a seeded synthetic language, in
PyTorch.

Counterpart of ``src/repro/launch/train.py`` with the same arguments and
defaults, plus ``--device`` (default: the card; ``cpu`` runs the plain
kernel versions). It exits 0 only if the loss improved. Example:

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
      --reduced --steps 50 --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.checkpoint import save_params
from repro_torch.configs import ALIASES, get_config
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.params import init_params, param_count_actual
from repro_torch.models.steps import make_train_step
from repro_torch.training.optimizer import AdamWConfig, adamw_init


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b", choices=sorted(ALIASES))
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced same-family variant")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. ~100M model)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--save", default="")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device for params, optimizer state and "
                         "kernels")
    a = ap.parse_args(argv)

    dev = resolve_device(a.device)
    cfg = get_config(a.arch)
    if a.reduced:
        cfg = cfg.reduced()
    if a.d_model:
        cfg = cfg.replace(d_model=a.d_model,
                          head_dim=max(32, a.d_model // max(cfg.num_heads, 1)))
    if a.layers:
        cfg = cfg.replace(num_layers=a.layers)
    n = param_count_actual(cfg)
    print(f"[train] {cfg.name}: {n/1e6:.1f}M params, "
          f"batch={a.batch} seq={a.seq} device={dev}")

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    opt_state = adamw_init(params)
    step_fn = make_train_step(cfg, AdamWConfig(lr=a.lr))
    data = SyntheticLM(cfg.vocab_size, a.seq, a.batch, seed=1)

    t0 = time.time()
    losses = []
    for step in range(a.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % a.log_every == 0 or step == a.steps - 1:
            dt = time.time() - t0
            print(f"  step {step:4d} loss {loss:.4f} "
                  f"grad_norm {float(metrics['grad_norm']):.3f} "
                  f"({dt:.1f}s)")
    if a.save:
        save_params(a.save, params, step=a.steps)
        print(f"[train] saved -> {a.save}")
    improved = losses[-1] < losses[0]
    print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({'improved' if improved else 'NOT improved'})")
    return 0 if improved else 1


if __name__ == "__main__":
    sys.exit(main())
