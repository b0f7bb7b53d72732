"""End-to-end serving (the paper's kind): a two-scenario workload
through the scenario-aware multi-group frontend (affinity routing +
cross-group fallback), then compare block-free vs block-fixed transfer
on the single-group MiniCluster shim.

  PYTHONPATH=src python -m repro_torch.examples.disaggregated_serving \\
      [--device cpu]

The port's ``examples/disaggregated_serving.py``, on ``--device``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.transfer import LinkModel
from repro_torch.device import resolve_device
from repro_torch.serving.cluster import MiniCluster, ServeRequest
from repro_torch.serving.frontend import ClusterFrontend


def workload(cfg, n, seed=1, *, scenario="default", max_new=6, rid0=0):
    rng = np.random.default_rng(seed)
    return [ServeRequest(rid=rid0 + i, scenario=scenario,
                         tokens=[int(t) for t in rng.integers(
                             0, cfg.vocab_size, int(rng.integers(6, 24)))],
                         max_new_tokens=max_new)
            for i in range(n)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device for params, pools and kernels")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    print(f"arch: {cfg.name} (MoE {cfg.moe.num_experts}e top-{cfg.moe.top_k})")

    # ---- scenario-aware multi-group frontend (paper §3.2 + §3.5)
    fe = ClusterFrontend(cfg, topology={"svcA/chat": (1, 1),
                                        "svcA/summ": (1, 1)},
                         link=LinkModel(), device=dev)
    reqs = (workload(cfg, 5, seed=2, scenario="svcA/chat")
            + workload(cfg, 5, seed=3, scenario="svcA/summ", rid0=100))
    t0 = time.time()
    fe.run(reqs, max_ticks=200)
    print(f"multi-group: {sum(r.done for r in reqs)}/{len(reqs)} done, "
          f"wall {time.time()-t0:.1f}s")
    for sc, st in fe.stats().items():
        print(f"  {sc:12s}: {int(st['n_p'])}P:{int(st['n_d'])}D "
              f"accepted={int(st['accepted'])} "
              f"rejections={int(st['rejections'])}")
    print("zookeeper groups:",
          {gid: {role: fe.meta.group_members(gid, role)
                 for role in ("P", "D")}
           for gid in fe.meta.groups})

    # ---- block-level prefix reuse on the real path (paper §2.2.1)
    cfg_d = get_config("granite-3-8b").reduced()
    fe = ClusterFrontend(cfg_d, topology={"default": (1, 1)},
                         prefill_kwargs={"block_size": 4},
                         decode_kwargs={"block_size": 4}, device=dev)
    rng = np.random.default_rng(4)
    shared = list(map(int, rng.integers(0, cfg_d.vocab_size, 16)))
    for i in range(4):       # same 16-token prefix, distinct suffixes
        tail = list(map(int, rng.integers(0, cfg_d.vocab_size, 5)))
        fe.run([ServeRequest(rid=200 + i, tokens=shared + tail,
                             max_new_tokens=3)], max_ticks=60)
    pf = fe.groups["default"].prefix_stats()
    print(f"prefix reuse: hit_rate={pf['hit_rate']:.0%} "
          f"reused={int(pf['reused_tokens'])}tok "
          f"computed={int(pf['compute_tokens'])}tok "
          f"(cold would compute {4 * 21}tok), "
          f"cow={int(pf['cow_copies'])} evictions={int(pf['evictions'])}")

    # ---- transfer-path comparison on the single-group shim: the
    # overlapped layer-wise pipeline (default) vs the blocking modes
    for label, kw in (("overlapped", dict(overlap_transfer=True)),
                      ("block_free", dict(overlap_transfer=False,
                                          transfer_mode="block_free")),
                      ("block_fixed", dict(overlap_transfer=False,
                                           transfer_mode="block_fixed"))):
        mc = MiniCluster(cfg, n_prefill=2, n_decode=2, link=LinkModel(),
                         device=dev, **kw)
        reqs = workload(cfg, 10)
        t0 = time.time()
        mc.run(reqs, max_ticks=200)
        if label == "overlapped":
            tf = mc.frontend.groups["default"].transfer_stats()
            sim_d2d = tf["admission_wait_mean_s"]
            msgs = int(tf["link_msgs"] / max(tf["jobs_admitted"], 1))
        else:
            xf = mc.xfer.stats
            sim_d2d = float(np.mean([t.time_s for t in xf])) if xf else 0.0
            msgs = int(np.mean([t.n_msgs for t in xf])) if xf else 0
        print(f"  {label:12s}: {sum(r.done for r in reqs)}/{len(reqs)} done, "
              f"wall {time.time()-t0:.1f}s, D2D admission stall "
              f"{sim_d2d*1e3:.2f}ms over {msgs} msgs/transfer, "
              f"gateway rejections={mc.rejections}")
    print("first instance RoCE IPs:",
          mc.meta.instances["P0"].roce_ips[:4], "...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
