"""Cluster-scale day-in-the-life: tidal traffic, group auto-scaling, fault
injection + minimum-cost recovery — the MLOps side of P/D-Serve (Fig. 13).

  PYTHONPATH=src python -m repro_torch.examples.cluster_scale_sim \\
      [--device cpu]

The simulator is host Python (``repro_torch.core``); ``--device`` is
taken as every example takes it, and asking for the card where there is
none raises. The port's ``examples/cluster_scale_sim.py``: the same
timeline, event for event.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core.group import PDGroup
from repro_torch.core.mlops import MLOps, NodeMonitor
from repro_torch.core.requests import tidal_rate
from repro_torch.core.zookeeper import MetaStore
from repro_torch.device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the device of the deployment (the simulation "
                         "itself runs on the host)")
    resolve_device(ap.parse_args(argv).device)
    meta = MetaStore()
    group = PDGroup("svcA/chat#g0", "svcA/chat", meta)
    t = group.setup(0.0, n_prefill=2, n_decode=4)
    print(f"group serving at t={t:.0f}s; workflow:")
    for ev in group.timeline:
        print(f"  t={ev.t:7.1f}s {ev.step:14s} {ev.detail}")

    ml = MLOps(meta, NodeMonitor(seed=4, fault_rate_per_hour=0.03))
    events = []
    while t < 86400.0:
        act = ml.auto_scale(t, group, base_rps=40.0,
                            rps_capacity_per_pair=11.0)
        if act:
            events.append((t, act, group.ratio))
        for rec in ml.check_and_recover(t, group, dt_hours=0.5):
            events.append((t, f"recovered {rec.iid} "
                           f"({rec.level}, {rec.recovery_time:.0f}s)",
                           group.ratio))
        t += 1800.0

    print(f"\nday timeline ({len(events)} events):")
    for tt, what, ratio in events:
        hour = tt / 3600.0
        rate = tidal_rate(40.0, tt)
        print(f"  {hour:5.1f}h rate={rate:5.1f}rps  {what:44s} "
              f"ratio={ratio[0]}:{ratio[1]}")
    print(f"\nfaults recovered: {len(ml.faults)}; "
          f"scaling actions: {len(ml.scale_events)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
