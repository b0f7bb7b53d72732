"""Wrapper of the hand-written CUDA kernel ``csrc/flash_prefill.cu``.

Replaces ``src/repro/kernels/flash_prefill.py:flash_prefill_pallas``:
causal flash attention with GQA inside the kernel. q (b, s, nq, hd); k,
v (b, P + s, nkv, hd) where P = prefix_pad (or q_offset when prefix_pad
is 0); q_valid (b,) int32 or None. Returns (b, s, nq, hd) in q's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0   # kernel launches made by this wrapper

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


def flash_prefill_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_offset: int = 0, prefix_pad: int = 0,
                       q_valid: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    global launches
    dev = q.device
    if not q.is_cuda or k.device != dev or v.device != dev \
            or (q_valid is not None and q_valid.device != dev):
        raise ValueError("flash_prefill_cuda takes its tensors on one card")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype in {list(DTYPE_CODES)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start on 16-byte boundaries")
    b, s, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    pfx = prefix_pad if prefix_pad else q_offset
    if hd not in HEAD_DIMS or tuple(k.shape) != (b, sk, nkv, hd) \
            or v.shape != k.shape or nq % nkv:
        raise ValueError(f"unsupported geometry: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if pfx < q_offset or sk != pfx + s:
        raise ValueError(f"need prefix_pad >= q_offset and sk == P + s: "
                         f"q_offset={q_offset} prefix_pad={prefix_pad} "
                         f"s={s} sk={sk}")
    if q_valid is not None and (q_valid.dtype != torch.int32
                                or tuple(q_valid.shape) != (b,)
                                or not q_valid.is_contiguous()):
        raise ValueError("q_valid must be a contiguous (b,) int32 tensor")
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    with torch.cuda.device(dev):
        rc = build.library().flash_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if q_valid is None else q_valid.data_ptr(), b, s, sk, nq,
            nkv, hd, int(q_offset), int(pfx), DTYPE_CODES[q.dtype],
            build.stream_of(q))
    build.check(rc, "flash_prefill")
    launches += 1
    return out
