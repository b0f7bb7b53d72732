"""Decide ``correct``: the served tokens against the plain reference.

Once the window has closed, a sample of the requests the window finished,
drawn from the seed, with the longest among them, is run once each
through the configuration's reference module (``spec.reference``): the
prompt and the served tokens, teacher-forced. For every served token the
gap by which its reference logit lies below the reference's best at that
position is read; the widest gap of the sample is the number compared.
Greedy decoding serves the best token, so a sound run reads rounding
only. The control reads the same gap for the token that the reference
computed with TF32 matmuls (the next precision below the configuration's
float32) puts first.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Sequence

import numpy as np
import torch

from pdbench import spec


@contextmanager
def tf32(on: bool):
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def sample(finished: Sequence, seed: int, min_tokens: int,
           max_requests: int) -> List:
    """The longest finished request, then others drawn from the seed,
    until ``min_tokens`` served tokens or ``max_requests`` requests."""
    if not finished:
        return []
    by_len = sorted(finished, key=lambda r: (-len(r.generated), r.rid))
    picked = [by_len[0]]
    rest = by_len[1:]
    order = np.random.default_rng(seed).permutation(len(rest))
    n = len(picked[0].generated)
    for i in order:
        if n >= min_tokens or len(picked) >= max_requests:
            break
        picked.append(rest[i])
        n += len(rest[i].generated)
    return picked


def _positions(c: dict, w: dict, prompt: List[int], served: List[int],
               device) -> torch.Tensor:
    seq = torch.tensor(prompt + served[:-1], dtype=torch.long, device=device)
    return spec.reference(c).logits(c, w, seq, len(prompt) - 1)


def gaps(c: dict, w: dict, reqs: Sequence, device, control: bool = False
         ) -> Dict[str, float]:
    """Over ``reqs``: the widest gap of the served tokens, the share of
    served tokens that are not the reference's best, and the number of
    tokens compared; with ``control`` the same two numbers for the tokens
    the TF32 reference puts first at the same positions."""
    widest, miss, n = 0.0, 0, 0
    c_widest, c_miss = 0.0, 0
    for r in reqs:
        served = list(r.generated)
        with tf32(False):
            ref = _positions(c, w, list(r.tokens), served, device)
        best = ref.max(-1).values
        toks = torch.tensor(served, dtype=torch.long, device=device)
        gap = best - ref.gather(1, toks[:, None])[:, 0]
        widest = max(widest, gap.max().item())
        miss += int((gap > 0).sum().item())
        n += len(served)
        if control:
            with tf32(True):
                low = _positions(c, w, list(r.tokens), served, device)
            cg = best - ref.gather(1, low.argmax(-1)[:, None])[:, 0]
            c_widest = max(c_widest, cg.max().item())
            c_miss += int((cg > 0).sum().item())
            del low
        del ref
    out = {"logit_gap_max": widest,
           "mismatch_share": miss / n if n else 1.0,
           "tokens_compared": n}
    if control:
        out["control_gap_max"] = c_widest
        out["control_mismatch_share"] = c_miss / n if n else 1.0
    return out
