"""One generator for every traffic mix: a mix file's parameters and a
seed in, timed requests out. The seed draws everything: arrival times,
lengths, token ids and the shared system prompts.

The stream comes in blocks of ``BLOCK`` requests, one block to each
``BLOCK / rate`` virtual seconds. A block's arrival times are
``BLOCK`` uniform points in its span: a Poisson process conditioned on
its count there, so a block holds Poisson's bursts and the rate is exact
over every block. A block's prompt and output lengths are drawn one from
each of ``BLOCK`` equal-probability strata of the mix's lognormal (a
median and a sigma), clipped to ``[min, max]``, in an order drawn from
the seed: every request's length has the mix's distribution, and every
block holds the whole range. (Fixing the count and the strata of a block
is what keeps the window's work steady from seed to seed: with free
counts and free draws, the window's tokens spread by ~13% and a cell near
its knee swings in and out of a queue.) With ``shared_prefixes`` the seed
draws ``count`` system prompts of ``tokens`` ids, each leading an equal
share of every block's user turns.

The prelude meets every prefill shape of the mix before the stream
starts: groups of ``b`` requests (``b`` in ``warm_batches``) at each
representative length (the ends of the range and both sides of every
power of two inside it), each twice, with the shortest output; one more
request asks for the longest prompt and the longest output.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Iterator, List

import numpy as np

BLOCK = 32      # requests a block: the arrival count and strata it fixes


@dataclass
class Req:
    rid: int
    at: float               # due arrival, virtual seconds from stream start
    tokens: List[int]
    out_tokens: int         # tokens the request is served (>= 1)


def stratified_lognormal(d: dict, n: int, rng) -> np.ndarray:
    """One length from each of ``n`` equal-probability strata of the
    clipped lognormal ``d``, in an order drawn from ``rng``."""
    inv = NormalDist().inv_cdf
    u = (rng.permutation(n) + rng.random(n)) / n
    x = np.array([d["median"] * math.exp(d["sigma"] * inv(p)) for p in u])
    return np.clip(np.rint(x), d["min"], d["max"]).astype(np.int64)


class Mix:
    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix = mix
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        sp = mix.get("shared_prefixes")
        self.prefixes = [] if not sp else [
            self.rng.integers(0, vocab, sp["tokens"]).tolist()
            for _ in range(sp["count"])]
        self._rid = 0

    def _new(self, at: float, length: int, out: int, prefix: int) -> Req:
        body = self.rng.integers(0, self.vocab, int(length)).tolist()
        tokens = (self.prefixes[prefix % len(self.prefixes)] + body
                  if self.prefixes else body)
        self._rid += 1
        return Req(self._rid, float(at), tokens, int(out))

    def max_prompt(self) -> int:
        return self.mix["prompt_tokens"]["max"] + (
            len(self.prefixes[0]) if self.prefixes else 0)

    def max_total(self) -> int:
        return self.max_prompt() + self.mix["output_tokens"]["max"]

    def blocks(self) -> Iterator[List[Req]]:
        """The stream, one block of requests at a time in order of
        arrival, times from 0, without end (see the module docstring)."""
        m, rng = self.mix, self.rng
        span = BLOCK / m["rate_per_s"]
        pref = np.arange(BLOCK) % max(1, len(self.prefixes))
        t0 = 0.0
        while True:
            at = t0 + np.sort(rng.random(BLOCK)) * span
            lens = stratified_lognormal(m["prompt_tokens"], BLOCK, rng)
            outs = stratified_lognormal(m["output_tokens"], BLOCK, rng)
            yield [self._new(a, ln, o, int(p)) for a, ln, o, p in
                   zip(at, lens, outs, rng.permutation(pref))]
            t0 += span

    def prelude(self) -> List[List[Req]]:
        """Groups of requests, each to be served alone (see the module
        docstring); the first group opens every shared prefix."""
        m = self.mix
        lo, hi = m["prompt_tokens"]["min"], m["prompt_tokens"]["max"]
        o_lo, o_hi = m["output_tokens"]["min"], m["output_tokens"]["max"]
        reps = {lo, hi}
        p = 1
        while p <= hi:
            reps.update(x for x in (p, p + 1) if lo <= x <= hi)
            p *= 2
        groups: List[List[Req]] = []
        if self.prefixes:
            groups.append([self._new(0, lo, o_lo, i)
                           for i in range(len(self.prefixes))])
        groups.append([self._new(0, hi, o_hi, 0)])
        k = 0
        for _ in range(2):
            for ln in sorted(reps):
                for b in m["warm_batches"]:
                    groups.append([self._new(0, ln, o_lo, k + i)
                                   for i in range(b)])
                    k += b
        return groups
