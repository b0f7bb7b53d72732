"""Aggregated-serving baseline (the paper's comparison point).

Each instance runs BOTH phases: prefill batches preempt decoding (shared
compute + shared HBM), KVCache stays local (no D2D transfer), and batch
sizes cannot be tuned per phase. This is the pre-disaggregation deployment
the paper reports a 6.7x E2E-throughput improvement over. Copied from
``src/repro/core/aggregated.py``.
"""
from __future__ import annotations

import random
from typing import Dict, List, Sequence

from repro_torch.core.cluster_sim import SimClock
from repro_torch.core.profiles import ServingProfile
from repro_torch.core.requests import Request


class AggregatedInstance:
    def __init__(self, sim: "AggregatedSim", iid: str,
                 profile: ServingProfile, *, b_p: int, b_d: int):
        self.sim = sim
        self.iid = iid
        self.profile = profile
        self.b_p = b_p
        # aggregated deployments keep a smaller decode batch: weights,
        # prefill activations and KV share one HBM
        self.b_d = b_d
        self.queue: List[Request] = []
        self.decoding: Dict[int, List] = {}
        self.prefilling = False
        self._running = False

    @property
    def load(self) -> int:
        return len(self.queue) + len(self.decoding)

    def submit(self, req: Request):
        self.queue.append(req)
        self._kick()

    def _kick(self):
        if not self._running and (self.queue or self.decoding):
            self._running = True
            self.sim.clock.schedule(0.0, self._cycle)

    def _cycle(self):
        """Alternate: one prefill batch (if pending + decode room), then
        decode iterations. Prefill BLOCKS decoding on the shared chips."""
        t = self.sim.clock.t
        if self.queue and len(self.decoding) < self.b_d:
            room = self.b_d - len(self.decoding)
            nmax = min(self.b_p, room, len(self.queue))
            batch = [self.queue.pop(0) for _ in range(nmax)]
            if batch:
                tokens = sum(r.prompt_len for r in batch)
                dt = self.profile.ttft(tokens, 0)

                def done():
                    tt = self.sim.clock.t
                    for r in batch:
                        r.t_prefill_done = tt
                        if r.ttft > r.slo_ttft:
                            r.timed_out = True
                            self.sim.failed.append(r)
                            continue
                        r.t_transfer_done = tt   # local, no D2D
                        self.decoding[r.rid] = [r, r.output_tokens]
                    self._step_decode()

                self.sim.clock.schedule(dt, done)
                return
        self._step_decode()

    def _step_decode(self):
        if not self.decoding:
            if self.queue:
                self.sim.clock.schedule(0.0, self._cycle)
            else:
                self._running = False
            return
        dt = self.profile.tpot(len(self.decoding))

        def fire():
            done_rids = []
            for rid, slot in self.decoding.items():
                slot[1] -= 1
                if slot[1] <= 0:
                    done_rids.append(rid)
            for rid in done_rids:
                req = self.decoding.pop(rid)[0]
                req.t_done = self.sim.clock.t
                self.sim.completed.append(req)
            self.sim.clock.schedule(0.0, self._cycle)

        self.sim.clock.schedule(dt, fire)


class AggregatedSim:
    def __init__(self, profile: ServingProfile, *, n_instances: int,
                 b_p: int = 4, b_d: int = 8, seed: int = 0):
        self.clock = SimClock()
        self.rng = random.Random(seed)
        self.instances = [AggregatedInstance(self, f"A{i}", profile,
                                             b_p=b_p, b_d=b_d)
                          for i in range(n_instances)]
        self.completed: List[Request] = []
        self.failed: List[Request] = []

    def submit(self, req: Request):
        tgt = min(self.instances, key=lambda x: x.load)
        tgt.submit(req)

    def run(self, requests: Sequence[Request], horizon: float
            ) -> Dict[str, float]:
        for r in requests:
            self.clock.schedule(r.arrival - self.clock.t,
                                (lambda rr: (lambda: self.submit(rr)))(r))
        self.clock.run_until(horizon)
        ok = len(self.completed)
        tot = ok + len(self.failed)
        n = len(self.instances)
        return {
            "completed": ok,
            "success_rate": ok / tot if tot else 1.0,
            "throughput_rps": ok / horizon,
            "phi": ok / horizon / n,
        }
