"""Wrapper of the hand-written CUDA kernel ``csrc/flash_prefill_bwd.cu``.

The gradient of flash-prefill attention: given q (b, s, nq, hd), k, v
(b, sk, nkv, hd), the forward's output o and row log-sum-exp lse (b, nq,
s) (``flash_prefill_cuda(..., causal=causal, return_lse=True)``) and the
output gradient do, returns (dq, dk, dv) shaped like q, k, v. The JAX
package takes this gradient with ``jax.value_and_grad`` of its jnp
``attention_seq`` (no Pallas kernel). f32 only; no prefix and every query
row real, the masks the training forwards use: causal with sk == s (the
decoder), or non-causal with any sk >= 1 (the whisper encoder, s == sk,
and cross-attention, s decoder tokens against sk encoder frames). The
caller (``kernels.ops.FlashPrefillFn``) refuses other masks.

In the non-causal mode the dQ pass's key range is split when its grid of
(query tile, query head, batch row) CTAs would fill fewer than about
four waves (``dq_split``: ``flash_prefill.key_split`` on the shapes and
the SM count alone): each range writes a partial dQ into scratch
allocated here, and the kernel sums them in range order, so two calls
give the same bits.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_prefill import KeySplit, key_split

# the dQ pass's sum adds partials and reads nothing else again: a split is
# worth a smaller gain than the forward's merge (PERF.md, PR 27)
DQ_SPLIT_SLACK = 0.02

launches = 0   # wrapper calls that launched the kernels (3, or 5 with GQA;
#                 one more with a split dQ pass)
noncausal_launches = 0   # of which in the non-causal mode

HEAD_DIMS = (32, 64, 128)


def dq_split(b: int, s: int, sk: int, nq: int, hd: int, *, causal: bool,
             sms: int) -> KeySplit:
    """The dQ pass's key split, from the shapes and the card's SM count
    alone: none in the causal mode; in the non-causal one its grid is
    b * nq * ceil(s / R) CTAs of R query rows (R = 128 at hd 128, else
    64), held 3, 3 and 1 an SM at hd 32, 64 and 128, streaming key tiles
    of 64 rows at hd 32, else 32 (``Geo`` in csrc/flash_prefill_bwd.cu)."""
    if causal:
        return KeySplit(1, 0)
    rows = 128 if hd == 128 else 64
    tile = 64 if hd == 32 else 32
    per_sm = {32: 3, 64: 3, 128: 1}[hd]
    return key_split(b * nq * -(-s // rows), sk, tile, sms, per_sm,
                     DQ_SPLIT_SLACK)


def flash_prefill_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, o: torch.Tensor,
                           lse: torch.Tensor, do: torch.Tensor,
                           causal: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    global launches, noncausal_launches
    ts = {"q": q, "k": k, "v": v, "o": o, "lse": lse, "do": do}
    dev = q.device
    if not q.is_cuda or any(t.device != dev for t in ts.values()):
        raise ValueError("flash_prefill_bwd_cuda takes its tensors on one "
                         "card")
    for name, t in ts.items():
        if t.dtype != torch.float32:
            raise ValueError(f"flash_prefill_bwd_cuda takes f32 only; {name} "
                             f"is {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and start on a "
                             f"16-byte boundary")
    b, s, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS or tuple(k.shape) != (b, sk, nkv, hd) \
            or (sk != s if causal else sk < 1) \
            or v.shape != k.shape or o.shape != q.shape \
            or do.shape != q.shape or tuple(lse.shape) != (b, nq, s) \
            or nq % nkv:
        raise ValueError(f"unsupported geometry: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, o "
                         f"{tuple(o.shape)}, lse {tuple(lse.shape)}, do "
                         f"{tuple(do.shape)} (causal={causal})")
    build.refuse_grad("flash_prefill_bwd_cuda", *ts.values())
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if b == 0 or s == 0:     # no query row: no key gets a gradient
        return dq, dk.zero_(), dv.zero_()
    d_scratch = torch.empty((b, nq, s), dtype=torch.float32, device=dev)
    # per-query-head partial dK, dV, summed in head order by the kernel
    g = nq // nkv
    part = torch.empty((2, g, b, sk, nkv, hd), dtype=torch.float32,
                       device=dev) if g > 1 else None
    # the dQ pass's partials over key ranges, summed in range order
    plan = dq_split(b, s, sk, nq, hd, causal=causal, sms=build.sm_count(dev))
    part_q = torch.empty((plan.splits, b, s, nq, hd), dtype=torch.float32,
                         device=dev) if plan.splits > 1 else None
    with torch.cuda.device(dev):
        rc = build.library().flash_prefill_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), d_scratch.data_ptr(),
            None if part is None else part.data_ptr(),
            None if part_q is None else part_q.data_ptr(), b, s, sk, nq, nkv,
            hd, int(bool(causal)), plan.keys, build.stream_of(q))
    build.check(rc, "flash_prefill_bwd")
    launches += 1
    if not causal:
        noncausal_launches += 1
    return dq, dk, dv
