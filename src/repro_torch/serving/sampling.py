"""Token sampling policies for the decode engines.

Counterpart of ``src/repro/serving/sampling.py``. The parity tests and
the paper's evaluation use greedy; temperature and top-k sampling
complete the serving substrate. Draws come from an explicit
``torch.Generator``, so a seeded run repeats; the stream is torch's, not
JAX's, so draws are never compared across the two stacks.
"""
from __future__ import annotations

from typing import Optional

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, generator: torch.Generator, *,
           temperature: float = 1.0,
           top_k: Optional[int] = None) -> torch.Tensor:
    """logits: (..., vocab). temperature <= 0 falls back to greedy; with
    ``top_k`` only the k largest logits (and ties of the k-th) can be
    drawn."""
    if temperature <= 0.0:
        return greedy(logits)
    l32 = logits.float() / temperature
    if top_k is not None and 0 < top_k < l32.shape[-1]:
        kth = torch.sort(l32, dim=-1).values[..., -top_k][..., None]
        l32 = torch.where(l32 < kth, torch.full_like(l32, -1e30), l32)
    probs = torch.softmax(l32, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draw = torch.multinomial(flat, 1, generator=generator)
    return draw.reshape(probs.shape[:-1]).to(torch.int32)
