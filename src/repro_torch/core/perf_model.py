"""The paper's E2E performance model (§2.1) and P/D-ratio optimizer (Eq. 1),
copied from ``src/repro/core/perf_model.py`` (pure Python): the part the
RatioAdjuster reads.

    Phi = min(I_t, n_p b_p / T_p, n_d b_d / T_d) / (n_p + n_d)
    T_p = TTFT_bs * r_pre
    T_d = xi + TPOT_bs * G
    optimum:  n_p b_p / T_p  ≈  n_d b_d / T_d            (Eq. 1)
    gateway:  I_t ≈ n_p b_p / T_p                        (Eq. 2)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class InstanceProfile:
    """Profiled per-instance characteristics for one scenario pattern."""
    ttft_bs: float          # prefill batch latency at batch size b_p (s)
    b_p: int                # prefill batch size
    r_pre: float            # prefix-hit speedup factor in (0, 1]
    tpot_bs: float          # decode per-token iteration latency at b_d (s)
    b_d: int                # decode batch size
    gen_tokens: float       # G: mean tokens generated
    xi: float = 0.02        # KVCache transfer time (max sub-transfer, s)

    @property
    def t_p(self) -> float:
        return self.ttft_bs * self.r_pre

    @property
    def t_d(self) -> float:
        return self.xi + self.tpot_bs * self.gen_tokens

    def prefill_capability(self, n_p: int) -> float:
        """Requests/s the prefill side sustains."""
        return n_p * self.b_p / self.t_p

    def decode_capability(self, n_d: int) -> float:
        return n_d * self.b_d / self.t_d


def throughput(profile: InstanceProfile, n_p: int, n_d: int,
               input_rps: float = math.inf) -> float:
    """Phi: average throughput per instance (the paper's cost metric)."""
    if n_p <= 0 or n_d <= 0:
        return 0.0
    cap = min(input_rps,
              profile.prefill_capability(n_p),
              profile.decode_capability(n_d))
    return cap / (n_p + n_d)


def optimal_ratio(profile: InstanceProfile, total: int,
                  *, min_each: int = 1) -> Tuple[int, int]:
    """Integer (n_p, n_d) with n_p + n_d == total maximizing Phi
    (equivalently minimizing the Eq. 1 mismatch at the bottleneck);
    at least `min_each` of each role (single-point-failure avoidance)."""
    best = (min_each, total - min_each)
    best_phi = -1.0
    for n_p in range(min_each, total - min_each + 1):
        n_d = total - n_p
        phi = throughput(profile, n_p, n_d)
        if phi > best_phi:
            best_phi = phi
            best = (n_p, n_d)
    return best
