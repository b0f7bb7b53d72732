"""Wrapper of the hand-written CUDA kernel ``csrc/flash_prefill.cu``.

Replaces ``src/repro/kernels/flash_prefill.py:flash_prefill_pallas``:
causal flash attention with GQA inside the kernel. q (b, s, nq, hd); k,
v (b, P + s, nkv, hd) where P = prefix_pad (or q_offset when prefix_pad
is 0); q_valid (b,) int32 or None. Returns (b, s, nq, hd) in q's dtype,
and with ``return_lse`` also the (b, nq, s) f32 log-sum-exp of each query
row's scaled scores over its live keys (+inf for a row with none), which
the backward kernel (``flash_prefill_bwd``) recomputes P from.
With ``causal=False`` (the encoder and cross-attention: JAX's
``attention_seq(causal=False)``) every key row is live, there is no
prefix (q_offset = prefix_pad = 0) and k, v may have any length sk.

In the non-causal mode the key range is split (flash-decoding) when the
grid of (query head, batch row, 64-row query tile) CTAs leaves SMs short
of work (``key_split`` says how that is judged): ``split_plan`` picks
the ranges from the shapes and the SM count alone, so a CUDA graph
captures the same launches for every call of a shape; each range writes
its partial output and LSE into scratch allocated here, and a second
kernel merges them in range order (``ref.flash_prefill_combine`` is its
plain version).

``q_offset`` is an int or a 0-d int32 tensor on the card. The tensor form
is JAX's traced ``prefix_len``: the kernel reads it on the device, so the
launch depends on shapes only and a captured prefill graph replays it for
any prefix length of its bucket. Nothing reads it on the host; its value
must lie in [0, P] with P = prefix_pad (or sk - s when prefix_pad is 0),
and the kernel clamps it there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import build

launches = 0   # wrapper calls that launched the kernel (and its merge)
noncausal_launches = 0   # of which in the non-causal mode
window_launches = 0      # of which in the window mode

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
QUERY_TILE = 64        # query rows of a CTA
KEY_TILE = 32          # keys of a streamed tile in the non-causal mode
# CTAs an SM holds at once, by head dim (the launch bounds of
# csrc/flash_prefill.cu's flash_prefill_nc_kernel)
CTAS_PER_SM = {32: 3, 64: 3, 128: 2}
SPLIT_WAVES = 3.5      # split only grids under about 4 waves of CTAs
MIN_SPLIT_TILES = 4    # key tiles a range holds at least: its partial
#                        output is then at most a quarter of its K/V bytes
MIN_CTAS_PER_SM = 2    # a 4-warp CTA alone leaves an SM's tensor cores idle
# a split must bring the busiest SM's load within this share of the best
# split's: the forward's merge reads every range's output again, the dQ
# pass's sum only adds partials (measured on the H100 at whisper's shapes:
# PERF.md, PR 27)
SPLIT_SLACK = 0.05


@dataclass(frozen=True)
class KeySplit:
    splits: int   # key ranges (1: no split, no scratch, no merge)
    keys: int     # keys a range, whole tiles (the last may hold fewer);
    #               0 for one range


def key_split(ctas: int, sk: int, tile: int, sms: int, per_sm: int,
              slack: float = SPLIT_SLACK) -> KeySplit:
    """Cut sk keys (in tiles of ``tile``) into ranges for a grid of
    ``ctas`` CTAs that each walk all of them, on ``sms`` SMs holding
    ``per_sm`` CTAs each. Grids of SPLIT_WAVES waves or more are not cut.
    Below that, n ranges give the busiest SM max(ceil(n ctas / sms),
    MIN_CTAS_PER_SM) CTAs of 1/n the work each: the smallest n within
    ``slack`` of the least such load is taken, with at least
    MIN_SPLIT_TILES tiles a range and every range non-empty."""
    if ctas <= 0 or ctas >= SPLIT_WAVES * sms * per_sm:
        return KeySplit(1, 0)
    tiles = -(-sk // tile)
    counts = sorted({-(-tiles // -(-tiles // n))
                     for n in range(1, -(-tiles // MIN_SPLIT_TILES) + 1)})

    def load(n: int) -> float:
        return max(-(-n * ctas // sms), MIN_CTAS_PER_SM) / n
    best = min(load(n) for n in counts)
    n = min(n for n in counts if load(n) <= best * (1 + slack))
    return KeySplit(1, 0) if n == 1 else KeySplit(n, -(-tiles // n) * tile)


def split_plan(b: int, s: int, sk: int, nq: int, hd: int, *, causal: bool,
               window: Optional[int], sms: int) -> KeySplit:
    """The key split of one call, from its shapes and the card's SM count
    alone: the causal and window modes never split; the non-causal mode
    runs b * nq * ceil(s / 64) CTAs, CTAS_PER_SM[hd] of them an SM."""
    if causal or window is not None:
        return KeySplit(1, 0)
    return key_split(b * nq * -(-s // QUERY_TILE), sk, KEY_TILE, sms,
                     CTAS_PER_SM[hd])


def flash_prefill_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_offset: Union[int, torch.Tensor] = 0,
                       prefix_pad: int = 0,
                       q_valid: Optional[torch.Tensor] = None,
                       causal: bool = True, return_lse: bool = False,
                       window: Optional[int] = None
                       ) -> Union[torch.Tensor,
                                  Tuple[torch.Tensor, torch.Tensor]]:
    global launches, noncausal_launches, window_launches
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
    q_off_dev = None
    if isinstance(q_offset, torch.Tensor):
        if q_offset.device != dev or q_offset.dtype != torch.int32 \
                or q_offset.numel() != 1 or not causal:
            raise ValueError("a tensor q_offset is one int32 on q's card, "
                             "for causal attention")
        q_off_dev, q_offset = q_offset, 0
    # causal with no prefix_pad: sk == q_offset + s
    pfx = prefix_pad if prefix_pad or not causal else sk - s
    if hd not in HEAD_DIMS or tuple(k.shape) != (b, sk, nkv, hd) \
            or v.shape != k.shape or nq % nkv:
        raise ValueError(f"unsupported geometry: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if causal and (pfx < q_offset or sk != pfx + s):
        raise ValueError(f"need prefix_pad >= q_offset and sk == P + s: "
                         f"q_offset={q_offset} prefix_pad={prefix_pad} "
                         f"s={s} sk={sk}")
    if not causal and (q_offset or prefix_pad or sk < 1):
        raise ValueError(f"non-causal attention takes no prefix and sk >= "
                         f"1: q_offset={q_offset} prefix_pad={prefix_pad} "
                         f"sk={sk}")
    if window is not None and (not causal or int(window) < 1):
        raise ValueError(f"the window mode takes causal attention and a "
                         f"window >= 1: causal={causal} window={window}")
    if q_valid is not None and (q_valid.dtype != torch.int32
                                or tuple(q_valid.shape) != (b,)
                                or not q_valid.is_contiguous()):
        raise ValueError("q_valid must be a contiguous (b,) int32 tensor")
    build.refuse_grad("flash_prefill_cuda", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, nq, s), dtype=torch.float32, device=dev) \
        if return_lse else None
    if b == 0 or s == 0:
        return (out, lse) if return_lse else out
    plan = split_plan(b, s, sk, nq, hd, causal=causal, window=window,
                      sms=build.sm_count(dev))
    # each range's output (b, s, nq, hd), then each range's LSE (b, nq, s)
    part = torch.empty(plan.splits * b * s * nq * (hd + 1),
                       dtype=torch.float32, device=dev) \
        if plan.splits > 1 else None
    with torch.cuda.device(dev):
        rc = build.library().flash_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if q_valid is None else q_valid.data_ptr(),
            None if q_off_dev is None else q_off_dev.data_ptr(),
            None if part is None else part.data_ptr(), b, s, sk, nq,
            nkv, hd, int(q_offset), int(pfx), int(bool(causal)),
            0 if window is None else min(int(window), 2**31 - 1),
            DTYPE_CODES[q.dtype], plan.keys, build.stream_of(q))
    build.check(rc, "flash_prefill")
    launches += 1
    if not causal:
        noncausal_launches += 1
    if window is not None:
        window_launches += 1
    return (out, lse) if return_lse else out
