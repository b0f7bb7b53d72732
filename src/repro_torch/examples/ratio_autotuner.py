"""P/D ratio auto-adjustment (paper §3.3, Fig. 12): run a decode-heavy
workload on a bad ratio, watch the bottleneck monitor flag it, re-run on
the Eq.1 optimum and compare — then do the adjustment LIVE on real
engines: a ClusterFrontend deployed at a bad ratio flips idle nodes
between P and D roles at runtime until it reaches the optimum.

  PYTHONPATH=src python -m repro_torch.examples.ratio_autotuner \\
      [--device cpu]

The port's ``examples/ratio_autotuner.py``. The simulated part runs on
the host, priced by the port's ``profile_for`` (an 8-GPU instance at the
H100's published rates, not JAX's TPU profile, so its rps differ from
the JAX script's); the live part serves on ``--device``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.cluster_sim import ClusterSim, SimConfig, run_workload
from repro_torch.core.perf_model import (BottleneckMonitor, InstanceProfile,
                                         optimal_ratio)
from repro_torch.core.profiles import profile_for
from repro_torch.core.requests import Scenario, WorkloadGenerator
from repro_torch.device import resolve_device
from repro_torch.serving.cluster import ServeRequest
from repro_torch.serving.frontend import ClusterFrontend


def run_ratio(prof, sc, n_p, n_d, seed=4):
    gen = WorkloadGenerator([sc], base_rps=55.0, seed=seed)
    reqs = gen.arrivals(60.0)
    sim = ClusterSim(SimConfig(profile=prof), n_prefill=n_p, n_decode=n_d,
                     policy="ondemand", seed=seed)
    m = run_workload(sim, reqs, 90.0)
    mon = BottleneckMonitor(window=50)
    for r in sim.completed:
        mon.record(r.ttft, r.e2e)
    return m, mon


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the live part's engines")
    dev = resolve_device(ap.parse_args(argv).device)
    prof = profile_for(get_config("pangu-38b"))
    sc = Scenario("demo/gen", "demo", 1024, 4, 256, 64, 320, 64,
                  slo_ttft=6.0)
    total = 12

    m_bad, mon = run_ratio(prof, sc, 8, 4)
    print(f"8P:4D  -> {m_bad['throughput_rps']:.1f} rps, "
          f"success {m_bad['success_rate']:.2f}, "
          f"monitor says: {mon.recommendation() or 'n/a'}")

    iprof = InstanceProfile(
        ttft_bs=prof.ttft(4 * (sc.prefix_len + sc.query_len_mean), 0),
        b_p=4, r_pre=0.6, tpot_bs=prof.tpot(16), b_d=16,
        gen_tokens=sc.out_tokens_mean, xi=0.02)
    n_p, n_d = optimal_ratio(iprof, total)
    print(f"Eq.1 optimum for this pattern: {n_p}P:{n_d}D")

    m_opt, _ = run_ratio(prof, sc, n_p, n_d)
    gain = (m_opt["throughput_rps"] / max(m_bad["throughput_rps"], 1e-9)
            - 1) * 100
    print(f"{n_p}P:{n_d}D -> {m_opt['throughput_rps']:.1f} rps, "
          f"success {m_opt['success_rate']:.2f}  (+{gain:.0f}% throughput)")

    live_adjustment(dev)
    return 0


def live_adjustment(device):
    """Runtime ratio adjustment on REAL engines: deploy 3P:1D against a
    decode-heavy Eq.1 profile and watch the adjuster flip nodes."""
    cfg = get_config("granite-3-8b").reduced()
    iprof = InstanceProfile(ttft_bs=0.1, b_p=4, r_pre=1.0, tpot_bs=0.05,
                            b_d=8, gen_tokens=100.0, xi=0.0)
    want = optimal_ratio(iprof, 4)
    fe = ClusterFrontend(cfg, topology={"demo/gen": (3, 1)},
                         adjust_ratio=True, adjust_interval=2,
                         profiles={"demo/gen": iprof}, device=device)
    g = fe.groups["demo/gen"]
    print(f"live: deployed {g.ratio[0]}P:{g.ratio[1]}D, "
          f"Eq.1 wants {want[0]}P:{want[1]}D")
    rng = np.random.default_rng(0)
    reqs = [ServeRequest(rid=i, scenario="demo/gen",
                         tokens=[int(t) for t in
                                 rng.integers(0, cfg.vocab_size, 8)],
                         max_new_tokens=6) for i in range(6)]
    fe.run(reqs, max_ticks=60)
    for _ in range(8):      # idle ticks: let the adjuster converge
        fe.tick()
    for t, old, new, kind in g.flips:
        print(f"  t={float(t):7.3f}s: {kind}  {old} -> {new} "
              f"(re-registered in zookeeper)")
    print(f"live: final ratio {g.ratio[0]}P:{g.ratio[1]}D, "
          f"served {sum(r.done for r in reqs)}/{len(reqs)} during flips")


if __name__ == "__main__":
    sys.exit(main())
