"""End-to-end numbers from the stamps of the served requests.

TTFT and TPOT are read on the frontend's virtual timeline, whose every
second is a measured card wall. A request whose arrival falls in the
window counts; one with no first token when the window ends enters with
the wait it has had so far, and one still decoding enters with what it
has done so far, so a stall cannot hide. Percentiles are nearest-rank.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank ``q``-th percentile (0 < q <= 100)."""
    if not xs:
        raise ValueError("percentile of no samples")
    s = sorted(xs)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


@dataclass
class Stamp:
    """What the harness reads of one request at the window's end."""
    arrival: float           # due arrival, virtual s
    first: float             # first token, virtual s (< 0: none yet)
    last: float              # its latest token, virtual s (< 0: none)
    tokens: int              # output tokens so far
    failed: bool = False     # shed at the gateway


def ttft_samples(stamps: List[Stamp], v_end: float) -> List[float]:
    out = []
    for s in stamps:
        if s.failed:
            out.append(math.inf)
        elif s.first >= 0.0:
            out.append(s.first - s.arrival)
        else:
            out.append(max(0.0, v_end - s.arrival))
    return out


def tpot_samples(stamps: List[Stamp]) -> List[float]:
    return [(s.last - s.first) / (s.tokens - 1) for s in stamps
            if not s.failed and s.tokens >= 2 and s.first >= 0.0]


def tokens_per_s(prompt_tokens: int, output_tokens: int,
                 wall_s: float) -> float:
    return (prompt_tokens + output_tokens) / wall_s


