"""Public kernel entry points: the CUDA kernel for a tensor on the card,
the plain PyTorch version for a tensor on the CPU.

Counterpart of ``src/repro/kernels/ops.py``. There is no switch and no
fallback: a CUDA tensor always goes to its hand-written kernel, and a
failed build or launch raises. The plain versions (``ref``) are reached
from here only for CPU tensors, which is how the CPU tests run the port.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_prefill import flash_prefill_cuda
from repro_torch.kernels.kv_gather import kv_gather_cuda
from repro_torch.kernels.kv_scatter import kv_scatter_cuda
from repro_torch.kernels.paged_attention import paged_attention_cuda


def _on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no kernel for device {t.device}")
    return False


def kv_gather(storage: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """storage: (L, NB, BS, W); idx: (n,) int32 -> fresh (L, n*BS, W)."""
    if _on_card(storage):
        return kv_gather_cuda(storage, idx)
    return ref.kv_gather(storage, idx)


def kv_scatter(storage: torch.Tensor, buf: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """Write buf (L, n*BS, W) into blocks idx of storage, in place."""
    if _on_card(storage):
        return kv_scatter_cuda(storage, buf.to(storage.dtype).contiguous(),
                               idx)
    return ref.kv_scatter(storage, buf, idx)


# Per-layer-triggered transfer (paper Fig. 10): one layer's stripe of the
# linearized buffer. The kernels address the layer where it lies in the
# storage, so the layer slice is never copied.

def kv_gather_layer(storage: torch.Tensor, idx: torch.Tensor,
                    layer: int) -> torch.Tensor:
    """storage: (L, NB, BS, W) -> fresh (n*BS, W) stripe of ``layer``."""
    if _on_card(storage):
        return kv_gather_cuda(storage, idx, layer=layer)
    return ref.kv_gather(storage[layer:layer + 1], idx)[0]


def kv_scatter_layer(storage: torch.Tensor, buf: torch.Tensor,
                     idx: torch.Tensor, layer: int) -> torch.Tensor:
    """Scatter one layer's (n*BS, W) stripe into paged storage, in place."""
    if _on_card(storage):
        return kv_scatter_cuda(storage, buf.to(storage.dtype).contiguous(),
                               idx, layer=layer)
    ref.kv_scatter(storage[layer:layer + 1], buf[None], idx)
    return storage


def paged_attention(q: torch.Tensor, kv_pages: torch.Tensor,
                    block_table: torch.Tensor,
                    lens: torch.Tensor) -> torch.Tensor:
    if _on_card(q):
        return paged_attention_cuda(q.contiguous(), kv_pages, block_table,
                                    lens)
    return ref.paged_attention(q, kv_pages, block_table, lens)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_offset: int = 0, prefix_pad: int = 0,
                  q_valid: Optional[torch.Tensor] = None,
                  causal: bool = True) -> torch.Tensor:
    """Prefill attention, causal or not, GQA in the kernel; see
    ref.flash_prefill for the masking contract."""
    if _on_card(q):
        return flash_prefill_cuda(q.contiguous(), k.contiguous(),
                                  v.contiguous(), q_offset=q_offset,
                                  prefix_pad=prefix_pad, q_valid=q_valid,
                                  causal=causal)
    return ref.flash_prefill(q, k, v, q_offset=q_offset,
                             prefix_pad=prefix_pad, q_valid=q_valid,
                             causal=causal)
