"""MLOps control plane (paper §3.3-3.4): health monitoring, minimum-cost
auto recovery, group-based auto scaling, and P/D ratio recommendation.
Copied from ``src/repro/core/mlops.py``.

The fault path follows the paper exactly: a per-node resident monitor
writes xPU status to a (mounted) file; MLOps polls it, classifies fault
levels, logically removes the instance in the Zookeeper meta (no new
traffic), spawns ONE stateless substitute container, runs dynamic RoCE
construction + model load, and only then re-admits it — no harm to the
running service, and running requests are completed/cleaned by the
protection path (default texts, stop zombie connections).

The serving path reads the substitute-ready timeline (crash recovery in
``serving/faults.py``, scale-up provisioning in ``serving/autoscale.py``)
and the SLO-goodput capacity law of the autoscaler; ``NodeMonitor`` and
``MLOps`` drive the simulator's ``PDGroup``s.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.group import (PDGroup, T_CONNECT, T_HEALTH, T_LOAD_SFS,
                                    T_LOAD_SSD)
from repro_torch.core.perf_model import BottleneckMonitor, InstanceProfile, \
    optimal_ratio
from repro_torch.core.requests import tidal_rate
from repro_torch.core.zookeeper import MetaStore

FAULT_LEVELS = ("recoverable", "device_reset", "node_replace")


def substitute_ready_delay(level: str = "node_replace", *,
                           storage: str = "ssd") -> float:
    """Seconds from fault detection to a substitute taking traffic
    (Fig. 13c/d closed form). The fault controller's reboots
    (serving/faults.py) and the autoscaler's provisioning
    (serving/autoscale.py) charge this timeline on the virtual clock, so
    sim recovery walls and ServeGroup recovery walls are one model:

      * recoverable   — restart in place, only the health check;
      * device_reset  — dynamic RoCE reconstruction + health check;
      * node_replace  — one stateless substitute container: connect +
                        pre-compiled model load (SSD or SFS) + health.
    """
    t_load = T_LOAD_SSD if storage == "ssd" else T_LOAD_SFS
    if level == "recoverable":
        return T_HEALTH
    if level == "device_reset":
        return T_CONNECT + T_HEALTH
    return T_CONNECT + t_load + T_HEALTH


@dataclass(frozen=True)
class SLOSpec:
    """Per-scenario latency targets the goodput model scores against."""
    ttft_s: float
    tpot_s: float


@dataclass
class GoodputModel:
    """DistServe-style SLO goodput: requests/s that meet BOTH the TTFT
    and the TPOT SLO, not raw throughput.

    Fed by the measured ``transfer_stats()`` medians of the live group
    (``prefill_batch_median_s`` / ``decode_step_median_s``), so the
    model tracks the engines as compiled, not a roofline guess. Node
    counts are *effective* counts: a node whose class scales service
    time by ``s`` contributes ``1/s`` node-equivalents, so heterogeneous
    pools fold into the same two capacity formulas.

    Prefill: a node retires ``batch_size`` requests per batch wall
    ``b``. Queueing wait grows like ``b / (1 - rho)``, so holding TTFT
    under the SLO caps utilisation at ``rho_max = 1 - b/ttft_slo`` —
    zero (infeasible) once a single batch alone overruns the budget.

    Decode: a request holds a slot for ``gen_tokens`` steps of wall
    ``d``; TPOT is infeasible when ``d`` exceeds the per-token SLO,
    else a node sustains ``slots / (gen_tokens * d)`` requests/s.
    """
    slo: SLOSpec
    prefill_batch_s: float
    decode_step_s: float
    batch_size: int = 4
    decode_slots: int = 8
    gen_tokens: float = 8.0

    @classmethod
    def from_stats(cls, slo: SLOSpec, stats: Dict[str, float], *,
                   batch_size: int = 4, decode_slots: int = 8,
                   gen_tokens: float = 8.0) -> Optional["GoodputModel"]:
        """Build from a ServeGroup ``transfer_stats()`` dict; None until
        the group has measured at least one batch and one decode step."""
        pb = float(stats.get("prefill_batch_median_s", 0.0) or 0.0)
        ds = float(stats.get("decode_step_median_s", 0.0) or 0.0)
        if pb <= 0.0 or ds <= 0.0:
            return None
        return cls(slo=slo, prefill_batch_s=pb, decode_step_s=ds,
                   batch_size=batch_size, decode_slots=decode_slots,
                   gen_tokens=max(gen_tokens, 1.0))

    # ----------------------------------------------------- capacities
    def prefill_headroom(self) -> float:
        if self.prefill_batch_s <= 0.0:
            return 1.0
        return max(0.0, 1.0 - self.prefill_batch_s / self.slo.ttft_s)

    def prefill_capacity(self, n_eff: float) -> float:
        """Requests/s ``n_eff`` prefill node-equivalents can serve while
        keeping TTFT within SLO."""
        if self.prefill_batch_s <= 0.0:
            return float("inf")
        raw = n_eff * self.batch_size / self.prefill_batch_s
        return raw * self.prefill_headroom()

    def decode_capacity(self, n_eff: float) -> float:
        """Requests/s ``n_eff`` decode node-equivalents can serve while
        keeping TPOT within SLO."""
        if self.decode_step_s <= 0.0:
            return float("inf")
        if self.decode_step_s > self.slo.tpot_s:
            return 0.0
        residency_s = self.gen_tokens * self.decode_step_s
        return n_eff * self.decode_slots / residency_s

    def goodput(self, rate: float, n_p_eff: float, n_d_eff: float) -> float:
        """Requests/s meeting both SLOs at offered ``rate``."""
        return min(rate, self.prefill_capacity(n_p_eff),
                   self.decode_capacity(n_d_eff))

    def nodes_needed(self, rate: float) -> Tuple[int, int]:
        """Smallest (n_p, n_d) balanced-node-equivalents serving ``rate``
        within both SLOs. Infeasible sides report a huge count so the
        caller can detect 'no amount of nodes fixes this SLO'."""
        big = 1 << 20
        per_p = self.prefill_capacity(1.0)
        per_d = self.decode_capacity(1.0)
        n_p = big if per_p <= 0.0 else max(1, math.ceil(rate / per_p))
        n_d = big if per_d <= 0.0 else max(1, math.ceil(rate / per_d))
        return n_p, n_d


@dataclass
class FaultRecord:
    t_detect: float
    iid: str
    level: str
    t_removed: float = -1.0
    t_substitute_ready: float = -1.0

    @property
    def recovery_time(self) -> float:
        return self.t_substitute_ready - self.t_detect


class NodeMonitor:
    """Per-node resident process writing xPU status to a health 'file'."""

    def __init__(self, seed: int = 0, fault_rate_per_hour: float = 0.004):
        self.rng = random.Random(seed)
        self.fault_rate = fault_rate_per_hour
        self.status: Dict[str, str] = {}     # iid -> "ok" | fault level

    def poll(self, t: float, iids: List[str], dt_hours: float
             ) -> Dict[str, str]:
        for iid in iids:
            if self.status.get(iid, "ok") != "ok":
                continue
            if self.rng.random() < self.fault_rate * dt_hours:
                self.status[iid] = self.rng.choice(FAULT_LEVELS)
        return dict(self.status)

    def clear(self, iid: str):
        self.status[iid] = "ok"


class MLOps:
    def __init__(self, meta: MetaStore, monitor: Optional[NodeMonitor] = None):
        self.meta = meta
        self.monitor = monitor or NodeMonitor()
        self.faults: List[FaultRecord] = []
        self.scale_events: List[Tuple[float, str, str]] = []

    # ------------------------------------------------- fault & recovery
    def check_and_recover(self, t: float, group: PDGroup,
                          dt_hours: float = 0.1) -> List[FaultRecord]:
        iids = group.members("P") + group.members("D")
        status = self.monitor.poll(t, iids, dt_hours)
        out = []
        for iid in iids:
            if status.get(iid, "ok") == "ok":
                continue
            rec = self.recover(t, group, iid, status[iid])
            out.append(rec)
        return out

    def recover(self, t: float, group: PDGroup, iid: str,
                level: str) -> FaultRecord:
        """Minimum-cost substitution: exactly ONE new stateless container."""
        rec = FaultRecord(t, iid, level)
        meta = self.meta.instances.get(iid)
        role = meta.role if meta else "P"
        # 1. logical removal: update zk meta -> no further forwarding;
        #    peers are informed so no transfer targets the fault instance
        self.meta.remove_instance(t, iid)
        rec.t_removed = t
        # 2. one substitute container: dynamic RoCE construction + load
        t_ready = t + T_CONNECT + T_LOAD_SSD + T_HEALTH
        new_iid = f"{iid.split('+')[0]}+s{len(self.faults)}"
        self.meta.gather_instance(t_ready, new_iid, role, group.gid)
        self.meta.health_report(t_ready, new_iid)
        rec.t_substitute_ready = t_ready
        self.monitor.clear(iid)
        self.faults.append(rec)
        return rec

    # -------------------------------------------------- group scaling
    def auto_scale(self, t: float, group: PDGroup, base_rps: float,
                   rps_capacity_per_pair: float, *,
                   tidal: bool = True) -> Optional[str]:
        """Time-triggered group-granularity scale in/out (Fig. 13b)."""
        rate = tidal_rate(base_rps, t) if tidal else base_rps
        n_p, n_d = group.ratio
        pairs = max(min(n_p, n_d), 1)
        have = pairs * rps_capacity_per_pair
        if rate > have * 0.9:
            group.adjust_ratio(t, n_p + 1, n_d + 1)
            self.scale_events.append((t, group.gid, "scale_out"))
            return "scale_out"
        if rate < have * 0.45 and min(n_p, n_d) > 1:
            group.adjust_ratio(t, n_p - 1, n_d - 1)
            self.scale_events.append((t, group.gid, "scale_in"))
            return "scale_in"
        return None

    # ------------------------------------------------ ratio adjustment
    def recommend_ratio(self, profile: InstanceProfile, total: int
                        ) -> Tuple[int, int]:
        return optimal_ratio(profile, total)

    def maybe_adjust_ratio(self, t: float, group: PDGroup,
                           monitor: BottleneckMonitor,
                           profile: InstanceProfile) -> Optional[str]:
        """Online path (Fig. 12c): E2E alarm + T_p proportion trend."""
        rec = monitor.recommendation()
        if rec is None:
            return None
        n_p, n_d = group.ratio
        if rec == "more_prefill":
            group.adjust_ratio(t, n_p + 1, max(n_d - 1, 1))
        else:
            group.adjust_ratio(t, max(n_p - 1, 1), n_d + 1)
        return rec
