"""Public kernel entry points: the CUDA kernel for a tensor on the card,
the plain PyTorch version for a tensor on the CPU.

Counterpart of ``src/repro/kernels/ops.py``. There is no switch and no
fallback: a CUDA tensor always goes to its hand-written kernel, and a
failed build or launch raises. The plain versions (``ref``) are reached
from here only for CPU tensors, which is how the CPU tests run the port.

``flash_prefill`` is differentiable: when grad mode is on and q, k or v
requires grad it goes through ``FlashPrefillFn``, whose forward also
writes the row log-sum-exp and whose backward is the hand-written
``flash_prefill_bwd`` kernel (the plain FlashAttention-2 backward on the
CPU), causal (sk == s) or non-causal (any sk: the whisper encoder and
cross-attention). ``grouped_mm`` (sorted MoE dispatch's ``lax.ragged_dot``) is
differentiable the same way, through ``GroupedMMFn``, whose backward is
the transposed instantiation (the input gradient) and the weight-gradient
kernel. ``skinny_mm`` (a dense product of at most 32 rows, the decode
step's) is reached only where ``skinny_mm_applies`` holds, which leaves
out operands that require grad under grad mode. The other kernels move
or read the serving pools and refuse tensors that require grad
(``build.refuse_grad``).

A tensor on the ``meta`` device runs nothing: inside the cost counter of
``launch/cost.py`` (the planner traces a full-width step on ``meta``) each
kernel call is charged its own work and returns an empty output of the
right shape, and outside it a meta tensor raises. It never reaches a
plain version.
"""
from __future__ import annotations

from typing import List, Optional, Union

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import ref
from repro_torch.kernels import skinny_mm as _skinny
from repro_torch.kernels.flash_prefill import flash_prefill_cuda
from repro_torch.kernels.flash_prefill_bwd import flash_prefill_bwd_cuda
from repro_torch.kernels.grouped_mm import grouped_mm_cuda, grouped_mm_dw_cuda
from repro_torch.kernels.kv_gather import kv_gather_cuda
from repro_torch.kernels.kv_scatter import kv_scatter_cuda
from repro_torch.kernels.paged_attention import paged_attention_cuda


def _on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no kernel for device {t.device}")
    return False


def _is_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def _charge(name: str, *args, **kw):
    """A kernel call on ``meta``: charged to the active cost counter
    (which raises when there is none), nothing computed."""
    from repro_torch.launch import cost
    return cost.charge_kernel(name, *args, **kw)


def kv_gather(storage: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """storage: (L, NB, BS, W); idx: (n,) int32 -> fresh (L, n*BS, W)."""
    if _is_meta(storage):
        return _charge("kv_gather", storage, idx)
    if _on_card(storage):
        return kv_gather_cuda(storage, idx)
    return ref.kv_gather(storage, idx)


def kv_scatter(storage: torch.Tensor, buf: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """Write buf (L, n*BS, W) into blocks idx of storage, in place."""
    if _is_meta(storage):
        return _charge("kv_scatter", storage, buf, idx)
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
    if _is_meta(storage):
        return _charge("kv_gather", storage[layer:layer + 1], idx)[0]
    if _on_card(storage):
        return kv_gather_cuda(storage, idx, layer=layer)
    return ref.kv_gather(storage[layer:layer + 1], idx)[0]


def kv_scatter_layer(storage: torch.Tensor, buf: torch.Tensor,
                     idx: torch.Tensor, layer: int) -> torch.Tensor:
    """Scatter one layer's (n*BS, W) stripe into paged storage, in place."""
    if _is_meta(storage):
        _charge("kv_scatter", storage[layer:layer + 1], buf[None], idx)
        return storage
    if _on_card(storage):
        return kv_scatter_cuda(storage, buf.to(storage.dtype).contiguous(),
                               idx, layer=layer)
    ref.kv_scatter(storage[layer:layer + 1], buf[None], idx)
    return storage


def paged_attention(q: torch.Tensor, kv_pages: torch.Tensor,
                    block_table: torch.Tensor,
                    lens: torch.Tensor) -> torch.Tensor:
    if _is_meta(q):
        return _charge("paged_attention", q, kv_pages, block_table, lens)
    if _on_card(q):
        return paged_attention_cuda(q.contiguous(), kv_pages, block_table,
                                    lens)
    return ref.paged_attention(q, kv_pages, block_table, lens)


class FlashPrefillFn(torch.autograd.Function):
    """Attention with no prefix and every query row real, causal (sk ==
    s) or not (any sk), with its gradient: the forward saves q, k, v, o
    and the row log-sum-exp, the backward recomputes the probabilities
    from them (the kernels on the card, the plain versions on the CPU).
    ``causal`` gets no gradient. Not twice differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True):
        if _is_meta(q):
            o, lse = _charge("flash_prefill", q, k, v, causal=causal,
                             return_lse=True)
        elif _on_card(q):
            o, lse = flash_prefill_cuda(q, k, v, causal=causal,
                                        return_lse=True)
        else:
            o, lse = ref.flash_prefill_fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal = ctx.causal
        if _is_meta(q):
            grads = _charge("flash_prefill_bwd", q, k, v, o, lse, do,
                            causal=causal)
        elif _on_card(q):
            grads = flash_prefill_bwd_cuda(q, k, v, o, lse, do.contiguous(),
                                           causal=causal)
        else:
            grads = ref.flash_prefill_bwd(q, k, v, o, lse, do,
                                          causal=causal)
        return (*grads, None)


def _grad_mask_check(q_offset: Union[int, torch.Tensor], prefix_pad: int,
                     q_valid: Optional[torch.Tensor],
                     window: Optional[int] = None) -> None:
    """The backward covers the training forwards' masks only."""
    if window is not None:
        mask = f"a sliding window (window={window})"
    elif q_offset or prefix_pad:
        mask = f"a prefix (q_offset={q_offset}, prefix_pad={prefix_pad})"
    elif q_valid is not None:
        mask = "padded query rows (q_valid)"
    else:
        return
    raise NotImplementedError(
        f"the gradient of flash prefill under {mask} is not implemented: "
        f"the backward covers causal and non-causal attention with no "
        f"prefix and every query row real, the masks of the training "
        f"forwards")


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_offset: Union[int, torch.Tensor] = 0, prefix_pad: int = 0,
                  q_valid: Optional[torch.Tensor] = None,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """Prefill attention, causal or not, GQA in the kernel, with an
    optional sliding ``window`` (causal only); see ref.flash_prefill for
    the masking contract. ``q_offset`` is an int or a 0-d int32 tensor on
    q's device (JAX's traced prefix length: the kernel reads it there).
    Differentiable (through FlashPrefillFn), causal or not, with no
    prefix, no q_valid and no window."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        # as below, the window masks causal attention only
        _grad_mask_check(q_offset, prefix_pad, q_valid,
                         window if causal else None)
        return FlashPrefillFn.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal)
    if window is not None and int(window) < 1:
        raise ValueError(f"a sliding window takes W >= 1, not {window}")
    # as in JAX's attention_seq, the window masks causal attention only
    kw = dict(q_offset=q_offset, prefix_pad=prefix_pad, q_valid=q_valid,
              causal=causal, window=window if causal else None)
    if _is_meta(q):
        return _charge("flash_prefill", q, k, v, **kw)
    if _on_card(q):
        return flash_prefill_cuda(q.contiguous(), k.contiguous(),
                                  v.contiguous(), **kw)
    return ref.flash_prefill(q, k, v, **kw)


def _grouped(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
             trans: bool = False) -> torch.Tensor:
    if _is_meta(x):
        return _charge("grouped_mm", x, w, offsets, trans=trans)
    if _on_card(x):
        return grouped_mm_cuda(x, w, offsets, trans=trans)
    return ref.grouped_mm(x, w, offsets, trans=trans)


class GroupedMMFn(torch.autograd.Function):
    """``grouped_mm`` with its gradient: dx = grouped_mm(dy, w^T) (the
    transposed instantiation) and dw[e] = x_e^T dy_e (the weight-gradient
    kernel), the kernels on the card and the plain versions on the CPU.
    ``offsets`` gets no gradient. Not twice differentiable."""

    @staticmethod
    def forward(ctx, x, w, offsets):
        ctx.save_for_backward(x, w, offsets)
        return _grouped(x, w, offsets)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w, offsets = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _grouped(dy, w, offsets, trans=True)
        if ctx.needs_input_grad[1]:
            E = w.shape[0]
            if _is_meta(x):
                dw = _charge("grouped_mm_dw", x, dy, offsets, E)
            elif _on_card(x):
                dw = grouped_mm_dw_cuda(x, dy, offsets, E)
            else:
                dw = ref.grouped_mm_dw(x, dy, offsets, E)
        return dx, dw, None


def grouped_mm(x: torch.Tensor, w: torch.Tensor,
               offsets: torch.Tensor) -> torch.Tensor:
    """``lax.ragged_dot(x, w, group_sizes)``: x (M, K) sorted by group, w
    (E, K, N), ``offsets`` (E+1,) int32 the exclusive cumsum of the group
    sizes, on x's device (never read on the host on the card). Operands
    are cast to their promoted dtype first, as ``lax.ragged_dot``
    promotes. Differentiable in x and w (through GroupedMMFn)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    x, w = x.contiguous(), w.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GroupedMMFn.apply(x, w, offsets)
    return _grouped(x, w, offsets)


def skinny_mm_applies(x: torch.Tensor, *ws: torch.Tensor) -> bool:
    """Whether ``[x @ w for w in ws]`` is one launch of ``skinny_mm``: f32
    on one card, at most 32 rows, one to three weights each row-major (K,
    N) or each the transpose of a row-major (N, K), at least 128 columns,
    no operand that requires grad under grad mode
    (``kernels/skinny_mm.applies``)."""
    return _skinny.applies(x, *ws)


def skinny_mm(x: torch.Tensor, *ws: torch.Tensor) -> List[torch.Tensor]:
    """[x (..., K) @ w (K, N) for w in ws] for at most 32 rows: the
    hand-written skinny product on the card, one launch (its operands as
    ``skinny_mm_applies`` asks)."""
    if _is_meta(x):
        return [_charge("skinny_mm", x, w) for w in ws]
    if _on_card(x):
        return _skinny.skinny_mm_cuda(x, *ws)
    return [ref.skinny_mm(x, w) for w in ws]
