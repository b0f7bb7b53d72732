"""The serving path's part of the MLOps control plane (paper §3.3-3.4),
copied from ``src/repro/core/mlops.py``: the substitute-ready timeline
that crash recovery and scale-up provisioning charge, the per-scenario
SLOs and the SLO-goodput capacity law of the autoscaler. The
simulator's ``MLOps``, ``NodeMonitor`` and ``PDGroup`` stay in the JAX
package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

# The paper's container-workflow timeline (Fig. 13), in VIRTUAL seconds
# (copied from ``src/repro/core/group.py``): connect, pre-compiled model
# load from SSD or SFS, health check. Nothing here was measured on a card.
T_CONNECT = 5.0
T_LOAD_SFS = 180.0
T_LOAD_SSD = 75.0
T_HEALTH = 1.0


def substitute_ready_delay(level: str = "node_replace", *,
                           storage: str = "ssd") -> float:
    """Seconds from fault detection to a substitute taking traffic
    (Fig. 13c/d closed form). The fault controller's reboots
    (serving/faults.py) and the autoscaler's provisioning
    (serving/autoscale.py) charge this timeline on the virtual clock:

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

