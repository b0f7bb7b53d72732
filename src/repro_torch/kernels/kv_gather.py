"""Wrapper of the hand-written CUDA kernel ``csrc/kv_gather.cu``.

Replaces ``src/repro/kernels/kv_gather.py:kv_gather_pallas``: the pool
blocks named by ``idx`` are copied out of paged storage (L, NB, BS, W)
into one fresh contiguous (L, n*BS, W) buffer, never a view of the pool.
``layer`` selects the single-layer form, which reads that layer where it
lies in the storage (no copy of the slice) and returns (n*BS, W).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0   # kernel launches made by this wrapper


def kv_gather_cuda(storage: torch.Tensor, idx: torch.Tensor,
                   layer: Optional[int] = None) -> torch.Tensor:
    global launches
    if not storage.is_cuda or idx.device != storage.device:
        raise ValueError("kv_gather_cuda takes storage and idx on one card")
    stride = build.layer_stride_bytes(storage)
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous 1-d int32 tensor")
    build.refuse_grad("kv_gather_cuda", storage)
    L, NB, BS, W = storage.shape
    n = idx.shape[0]
    page = BS * W * storage.element_size()
    if layer is None:
        src, layers = storage, L
        out = torch.empty((L, n * BS, W), dtype=storage.dtype,
                          device=storage.device)
    else:
        if not 0 <= layer < L:
            raise IndexError(f"layer {layer} outside [0, {L})")
        src, layers = storage[layer], 1
        out = torch.empty((n * BS, W), dtype=storage.dtype,
                          device=storage.device)
    if n == 0 or W == 0:
        # nothing to copy (an attention-free pool has width 0): launch
        # nothing and count nothing
        return out
    with torch.cuda.device(storage.device):
        rc = build.library().kv_gather(
            src.data_ptr(), idx.data_ptr(), out.data_ptr(), layers, NB, n,
            page, stride, build.stream_of(storage))
    build.check(rc, "kv_gather")
    launches += 1
    return out
