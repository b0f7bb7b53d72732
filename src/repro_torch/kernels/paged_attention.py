"""Wrapper of the hand-written CUDA kernel ``csrc/paged_attention.cu``.

Replaces ``src/repro/kernels/paged_attention.py:paged_attention_pallas``:
one-query-token GQA attention per sequence over a paged pool. q (B, nq,
hd); kv_pages (NB, BS, 2*kvd), K then V; block_table (B, MAXB) int32, -1
padded; lens (B,) int32 valid tokens. Returns (B, nq, hd) in q's dtype;
rows with no live token are exactly 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = 0   # kernel launches made by this wrapper

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8   # query heads per kv head handled by one CTA


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
    out = torch.empty_like(q)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        rc = build.library().paged_attention(
            q.data_ptr(), kv_pages.data_ptr(), block_table.data_ptr(),
            lens.data_ptr(), out.data_ptr(), B, nq, nkv, hd, NB, BS,
            block_table.shape[1], DTYPE_CODES[q.dtype], build.stream_of(q))
    build.check(rc, "paged_attention")
    launches += 1
    return out
