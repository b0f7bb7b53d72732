"""Multi-region organization + request routing (paper §3.7).

A cluster has multiple regions (thousands of NPUs each); P/D groups are
deployed per scenario to any region. The ELB/SLB tier load-balances across
regions; the MSG (model-service gateway) tier inside each region runs the
on-demand forwarding of §3.5. Region-level failures shift traffic to the
surviving regions without service interruption (disaster recovery).
Copied from ``src/repro/core/regions.py``.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

from repro_torch.core.cluster_sim import ClusterSim
from repro_torch.core.requests import Request


@dataclass
class Region:
    name: str
    sims: Dict[str, ClusterSim] = field(default_factory=dict)  # scenario->
    healthy: bool = True

    def capacity_weight(self, scenario: str) -> float:
        sim = self.sims.get(scenario)
        if sim is None or not self.healthy:
            return 0.0
        return float(len(sim.prefills))


class ServiceRouter:
    """ELB/SLB stand-in: weighted routing of scenario traffic to regions,
    with region-failure failover. The per-region MSG behavior (rejection
    retries, SSE accounting) lives inside each ClusterSim."""

    def __init__(self, regions: Sequence[Region], *, seed: int = 0):
        self.regions = list(regions)
        self.rng = random.Random(seed)
        self.routed: Dict[str, int] = {}
        self.dropped = 0

    def route(self, req: Request) -> Optional[Region]:
        weights = [r.capacity_weight(req.scenario) for r in self.regions]
        total = sum(weights)
        if total <= 0:
            self.dropped += 1
            return None
        pick = self.rng.choices(self.regions, weights=weights)[0]
        self.routed[pick.name] = self.routed.get(pick.name, 0) + 1
        pick.sims[req.scenario].submit(req)
        return pick

    def fail_region(self, name: str):
        """Region-level failure: ELB stops routing there immediately."""
        for r in self.regions:
            if r.name == name:
                r.healthy = False

    def restore_region(self, name: str):
        for r in self.regions:
            if r.name == name:
                r.healthy = True

    # ------------------------------------------------------------ run
    def run(self, requests: Sequence[Request], horizon: float,
            *, fail_at: Optional[float] = None,
            fail_region: str = "") -> Dict[str, float]:
        # all regions share one logical clock: interleave by running each
        # region's event loop over the same horizon; arrivals are routed
        # up front (ELB is stateless per request)
        for req in sorted(requests, key=lambda r: r.arrival):
            if fail_at is not None and req.arrival >= fail_at and fail_region:
                self.fail_region(fail_region)
            self.route(req)
        ok = fail = 0
        for r in self.regions:
            for sim in r.sims.values():
                sim.clock.run_until(horizon)
                ok += len(sim.completed)
                fail += len(sim.failed)
        total = ok + fail + self.dropped
        return {
            "completed": ok,
            "failed": fail + self.dropped,
            "success_rate": ok / total if total else 1.0,
            "throughput_rps": ok / horizon,
            "routed": dict(self.routed),
            "dropped": self.dropped,
        }
