"""Deterministic synthetic LM data pipeline.

A copy of ``src/repro/data/pipeline.py`` (numpy only): the same seed and
step give byte-identical batches in both packages.

Produces next-token-prediction batches with a learnable structure (piecewise
Markov chains per "scenario", sharing prefixes) so the training example's
loss actually decreases. Shardable: batch index -> content is a pure
function of (seed, step), so every data-parallel worker can slice its rows
without coordination.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


def text_to_tokens(text: str, vocab_size: int) -> np.ndarray:
    """Toy byte-pair-ish tokenizer stub: bytes folded into the vocab."""
    raw = np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int64)
    return (raw * 31 + 7) % max(vocab_size, 2)


@dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    order: int = 2          # markov order of the synthetic language

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse transition table: each previous token admits 4 successors
        n_ctx = min(self.vocab_size, 4096)
        self._n_ctx = n_ctx
        self._cands = rng.integers(0, self.vocab_size,
                                   size=(n_ctx, 4)).astype(np.int64)

    def _ctx_hash(self, a: np.ndarray) -> np.ndarray:
        return a % self._n_ctx

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        b, s = self.global_batch, self.seq_len
        toks = np.zeros((b, s + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.vocab_size, b)
        noise = rng.random((b, s + 1))
        pick = rng.integers(0, 4, (b, s + 1))
        for t in range(1, s + 1):
            h = self._ctx_hash(toks[:, t - 1])
            nxt = self._cands[h, pick[:, t]]
            rand = rng.integers(0, self.vocab_size, b)
            toks[:, t] = np.where(noise[:, t] < 0.05, rand, nxt)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
