"""Request model + scenario-structured synthetic workload (paper §2.2.1).

Prompts have a shared scenario prefix (the "setting part": system text,
candidate pools, background facts) and a per-request query part. Scenarios
differ in prefix length, prompt length, and output-token distributions, and
traffic is tidal (Fig. 2a / 13b).

Copied from ``src/repro/core/requests.py``: the same seeded
``random.Random`` draws, so a seed gives the JAX package's requests.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass
class Request:
    rid: int
    scenario: str
    prefix_id: str            # which cached prefix this prompt shares
    prefix_len: int           # tokens coverable by a prefix-KVCache hit
    prompt_len: int           # total prompt tokens (prefix + query)
    output_tokens: int        # tokens to generate in decode
    arrival: float            # seconds
    slo_ttft: float           # TTFT SLO threshold (s)
    # ---- lifecycle (filled by the system) ----
    t_accept: float = -1.0
    t_prefill_done: float = -1.0
    t_prefill_compute: float = 0.0   # batch compute time (overlap model)
    t_transfer_done: float = -1.0
    t_done: float = -1.0
    timed_out: bool = False
    rejections: int = 0
    prefix_hit: bool = False

    @property
    def ttft(self) -> float:
        return self.t_prefill_done - self.arrival

    @property
    def e2e(self) -> float:
        return self.t_done - self.arrival


@dataclass(frozen=True)
class Scenario:
    name: str
    service: str
    prefix_len: int            # tokens in the shared setting part
    num_prefixes: int          # distinct prefixes in this scenario
    query_len_mean: int
    query_len_std: int
    out_tokens_mean: int
    out_tokens_std: int
    slo_ttft: float = 3.0
    weight: float = 1.0        # share of traffic


# Six scenarios from two services, mirroring the paper's Fig. 1a spread:
# short-prefix chat, long candidate-pool ranking, RAG summarization, etc.
DEFAULT_SCENARIOS: Tuple[Scenario, ...] = (
    Scenario("svcA/chat", "svcA", 512, 4, 256, 96, 220, 80, 2.0, 1.5),
    Scenario("svcA/rank", "svcA", 3072, 8, 192, 64, 24, 8, 2.5, 1.2),
    Scenario("svcA/summ", "svcA", 1536, 6, 1024, 256, 330, 96, 4.0, 0.8),
    Scenario("svcB/extract", "svcB", 2048, 10, 512, 128, 48, 16, 2.5, 1.0),
    Scenario("svcB/code", "svcB", 1024, 5, 768, 256, 512, 128, 4.0, 0.7),
    Scenario("svcB/qa", "svcB", 4096, 12, 128, 48, 96, 32, 3.0, 0.8),
)


def tidal_rate(base_rps: float, t: float, *, period: float = 86400.0,
               trough: float = 0.25) -> float:
    """Day/night tidal traffic (Fig. 13b): peak at mid-period."""
    phase = 2 * math.pi * (t % period) / period
    return base_rps * (trough + (1 - trough) * 0.5 * (1 - math.cos(phase)))


class WorkloadGenerator:
    """Poisson arrivals per scenario with shared-prefix structure."""

    def __init__(self, scenarios=DEFAULT_SCENARIOS, *, base_rps: float = 8.0,
                 seed: int = 0, tidal: bool = False):
        self.scenarios = list(scenarios)
        self.base_rps = base_rps
        self.rng = random.Random(seed)
        self.tidal = tidal
        self._rid = 0
        wsum = sum(s.weight for s in self.scenarios)
        self._weights = [s.weight / wsum for s in self.scenarios]

    def _draw_scenario(self) -> Scenario:
        return self.rng.choices(self.scenarios, weights=self._weights)[0]

    def make_request(self, t: float) -> Request:
        sc = self._draw_scenario()
        self._rid += 1
        q = max(16, int(self.rng.gauss(sc.query_len_mean, sc.query_len_std)))
        out = max(1, int(self.rng.gauss(sc.out_tokens_mean, sc.out_tokens_std)))
        pid = f"{sc.name}#p{self.rng.randrange(sc.num_prefixes)}"
        return Request(
            rid=self._rid, scenario=sc.name, prefix_id=pid,
            prefix_len=sc.prefix_len, prompt_len=sc.prefix_len + q,
            output_tokens=out, arrival=t, slo_ttft=sc.slo_ttft)

    def arrivals(self, horizon: float, *, rate: Optional[float] = None
                 ) -> List[Request]:
        """All requests in [0, horizon)."""
        out: List[Request] = []
        t = 0.0
        while True:
            r = rate if rate is not None else self.base_rps
            if self.tidal:
                r = tidal_rate(r, t)
            t += self.rng.expovariate(max(r, 1e-9))
            if t >= horizon:
                return out
            out.append(self.make_request(t))
