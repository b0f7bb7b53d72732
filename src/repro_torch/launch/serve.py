"""Serving launcher: run the real-compute mini-cluster on a reduced config
with a batched synthetic workload, in PyTorch.

Counterpart of ``src/repro/launch/serve.py`` with the same arguments and
defaults, plus ``--device`` (default: the card; ``cpu`` runs the plain
kernel versions). Example:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \\
      --requests 16 --prefills 2 --decodes 2
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.configs import ALIASES, get_config
from repro_torch.serving.cluster import MiniCluster, ServeRequest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=sorted(ALIASES))
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prefills", type=int, default=2)
    ap.add_argument("--decodes", type=int, default=2)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--transfer", default="block_free",
                    choices=["block_free", "block_fixed"])
    ap.add_argument("--no-overlap", action="store_true",
                    help="blocking transfer instead of the overlapped "
                         "layer-wise pipeline")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device for params, pools and kernels")
    a = ap.parse_args(argv)

    cfg = get_config(a.arch).reduced()
    print(f"[serve] {cfg.name}: {a.prefills}P/{a.decodes}D "
          f"transfer={a.transfer} device={a.device}")
    mc = MiniCluster(cfg, n_prefill=a.prefills, n_decode=a.decodes,
                     seed=a.seed, transfer_mode=a.transfer,
                     overlap_transfer=not a.no_overlap, device=a.device)
    rng = np.random.default_rng(a.seed)
    reqs = []
    for i in range(a.requests):
        n = int(rng.integers(6, 20))
        reqs.append(ServeRequest(
            rid=i, tokens=list(rng.integers(0, cfg.vocab_size, n)),
            max_new_tokens=a.max_new_tokens))
    t0 = time.time()
    done = mc.run(reqs, max_ticks=500)
    dt = time.time() - t0
    ok = sum(r.done for r in done)
    tf = mc.frontend.groups["default"].transfer_stats()
    n_tf = int(tf["jobs_admitted"])
    path = "overlapped pipeline" if tf["overlapped"] else "blocking"
    print(f"[serve] {ok}/{len(done)} completed in {dt:.1f}s wall; "
          f"gateway rejections={mc.rejections}; "
          f"transfers={n_tf} ({path}) mean_admission_wait="
          f"{tf['admission_wait_mean_s']*1e3:.2f}ms")
    for r in done[:4]:
        print(f"  rid={r.rid} prompt[{len(r.tokens)}] -> {r.generated}")
    return 0 if ok == len(done) else 1


if __name__ == "__main__":
    sys.exit(main())
