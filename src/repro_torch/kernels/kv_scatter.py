"""Wrapper of the hand-written CUDA kernel ``csrc/kv_scatter.cu``.

Replaces ``src/repro/kernels/kv_scatter.py:kv_scatter_pallas``: a
contiguous (L, n*BS, W) buffer is written into blocks ``idx`` of paged
storage (L, NB, BS, W) IN PLACE. Where JAX aliased the pool to the
kernel's output, here the storage tensor itself is updated: its
``data_ptr()`` never changes and blocks not in ``idx`` are not touched.
``layer`` selects the single-layer form: a (n*BS, W) stripe written into
that layer only.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0   # kernel launches made by this wrapper


def kv_scatter_cuda(storage: torch.Tensor, buf: torch.Tensor,
                    idx: torch.Tensor, layer: Optional[int] = None
                    ) -> torch.Tensor:
    global launches
    if not storage.is_cuda or buf.device != storage.device \
            or idx.device != storage.device:
        raise ValueError("kv_scatter_cuda takes storage, buf and idx on "
                         "one card")
    if storage.dim() != 4 or not storage.is_contiguous():
        raise ValueError(f"storage must be contiguous (L, NB, BS, W), got "
                         f"{tuple(storage.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous 1-d int32 tensor")
    if buf.dtype != storage.dtype or not buf.is_contiguous():
        raise ValueError("buf must be contiguous and of the storage's dtype")
    L, NB, BS, W = storage.shape
    n = idx.shape[0]
    want = (n * BS, W) if layer is not None else (L, n * BS, W)
    if tuple(buf.shape) != want:
        raise ValueError(f"buf shape {tuple(buf.shape)} != {want}")
    if layer is not None and not 0 <= layer < L:
        raise IndexError(f"layer {layer} outside [0, {L})")
    if n == 0 or W == 0:
        # nothing to copy (an attention-free pool has width 0): launch
        # nothing and count nothing
        return storage
    dst = storage if layer is None else storage[layer]
    page = BS * W * storage.element_size()
    with torch.cuda.device(storage.device):
        rc = build.library().kv_scatter(
            dst.data_ptr(), buf.data_ptr(), idx.data_ptr(),
            L if layer is None else 1, NB, n, page, NB * page,
            build.stream_of(storage))
    build.check(rc, "kv_scatter")
    launches += 1
    return storage
