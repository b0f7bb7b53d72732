"""Wrapper of the hand-written CUDA kernels ``csrc/paged_attention.cu``.

Replaces ``src/repro/kernels/paged_attention.py:paged_attention_pallas``:
one-query-token GQA attention per sequence over a paged pool. q (B, nq,
hd); kv_pages (NB, BS, 2*kvd), K then V; block_table (B, MAXB) int32, -1
padded; lens (B,) int32 valid tokens. Returns (B, nq, hd) in q's dtype;
rows with no live token are exactly 0.

Split-KV (flash-decoding): the token axis [0, MAXB*BS) is cut into S
ranges of ``split_tokens`` tokens, one CTA per (kv head, sequence,
range), and a second kernel merges the S partial softmax states. The
geometry depends on the shapes alone (``split_plan``), never on ``lens``,
so the launch needs no host synchronisation.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import build

# wrapper calls that launched the kernels; one call is two kernel
# launches (the split kernel, then the merge kernel)
launches = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8   # query heads per kv head handled by one CTA
# tokens per CTA before rounding up to whole blocks: at the main path's
# shape (4 live slots of 250-330 tokens, 8 kv heads, BS 16) this gives
# 8-11 live ranges per slot, 256-352 live CTAs on the 132 SMs
SPLIT_TOKENS = 32


@dataclass(frozen=True)
class SplitPlan:
    split_tokens: int                   # tokens per range, whole blocks
    splits: int                         # S = ceil(MAXB*BS / split_tokens)
    grid: Tuple[int, int, int]          # split kernel: (nkv, B, S)
    part_shape: Tuple[int, int, int, int]   # f32 scratch acc (B, nq, S, hd)
    stat_shape: Tuple[int, int, int]    # f32 scratch m and l (B, nq, S)
    kernel_launches: int                # 2, or 0 when B == 0


def split_plan(B: int, nq: int, nkv: int, hd: int, maxb: int,
               bs: int) -> SplitPlan:
    """Launch geometry and scratch shapes of one call, from shapes only."""
    split = bs * -(-SPLIT_TOKENS // bs)
    S = max(1, -(-(maxb * bs) // split))
    return SplitPlan(split_tokens=split, splits=S, grid=(nkv, B, S),
                     part_shape=(B, nq, S, hd), stat_shape=(B, nq, S),
                     kernel_launches=2 if B > 0 else 0)


def paged_attention_cuda(q: torch.Tensor, kv_pages: torch.Tensor,
                         block_table: torch.Tensor, lens: torch.Tensor
                         ) -> torch.Tensor:
    global launches
    dev = q.device
    if not q.is_cuda or any(t.device != dev
                            for t in (kv_pages, block_table, lens)):
        raise ValueError("paged_attention_cuda takes its tensors on one card")
    if q.dtype not in DTYPE_CODES or kv_pages.dtype != q.dtype:
        raise ValueError(f"q and pages must share a dtype in "
                         f"{list(DTYPE_CODES)}: {q.dtype}, {kv_pages.dtype}")
    if block_table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError("block_table and lens must be int32")
    for name, t in (("q", q), ("kv_pages", kv_pages),
                    ("block_table", block_table), ("lens", lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.data_ptr() % 16 or kv_pages.data_ptr() % 16:
        raise ValueError("q and kv_pages must start on 16-byte boundaries")
    build.refuse_grad("paged_attention_cuda", q, kv_pages)
    B, nq, hd = q.shape
    NB, BS, W = kv_pages.shape
    nkv = (W // 2) // hd
    if hd not in HEAD_DIMS or W != 2 * nkv * hd or nq % max(nkv, 1) \
            or nq // nkv > MAX_GROUP:
        raise ValueError(f"unsupported geometry: q {tuple(q.shape)}, pages "
                         f"{tuple(kv_pages.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(lens.shape) != (B,):
        raise ValueError("block_table must be (B, MAXB) and lens (B,)")
    maxb = block_table.shape[1]
    plan = split_plan(B, nq, nkv, hd, maxb, BS)
    out = torch.empty_like(q)
    if plan.kernel_launches == 0:
        return out
    # one scratch allocation: acc, then m, then l
    n_part, n_stat = math.prod(plan.part_shape), math.prod(plan.stat_shape)
    scratch = torch.empty(n_part + 2 * n_stat, dtype=torch.float32,
                          device=dev)
    part, stat_m, stat_l = scratch.split([n_part, n_stat, n_stat])
    with torch.cuda.device(dev):
        rc = build.library().paged_attention(
            q.data_ptr(), kv_pages.data_ptr(), block_table.data_ptr(),
            lens.data_ptr(), out.data_ptr(), part.data_ptr(),
            stat_m.data_ptr(), stat_l.data_ptr(), B, nq, nkv, hd, NB, BS,
            maxb, plan.split_tokens, plan.splits, DTYPE_CODES[q.dtype],
            build.stream_of(q))
    build.check(rc, "paged_attention")
    launches += 1
    return out
