"""Wrapper of the hand-written CUDA kernel ``csrc/skinny_mm.cu``.

``skinny_mm_cuda(x, *ws)`` is ``[x @ w for w in ws]`` for x (..., K) of
at most ``MAX_ROWS`` rows and one to ``MAX_PRODUCTS`` weights w (K, N),
all f32 on one card, in one launch: the dense products of the decode step
(every projection, MLP and head product at one row a slot; q, k and v,
and gate and up, share their x), which are bound by the bytes of w, each
read once. It replaces no TPU kernel (the JAX package leaves dense
products to XLA); see the source for the design. f32-accurate: 3xTF32
products, f32 sums, and the same bits on every call.

w takes one of two layouts: row-major (K, N) (``NN``), or the transpose
of a row-major (N, K) (``T``, a tied head's ``embed.T``), each with any
row stride that keeps whole 16-byte runs. ``applies(x, *ws)`` is the rule
``models/modeling.py`` routes by: CUDA f32 operands on one card, at most
``MAX_ROWS`` rows, every w in one layout (the same for all) and at least
one column tile (``TILE``) wide, nothing that requires grad under grad
mode; everything else (CPU and ``meta`` tensors, other dtypes, more rows,
other strides, a narrower w such as deepseek's 64-expert router,
training) stays ``x @ w``.

``ctas`` picks the grid from the shapes and the card's SM count alone:
RESIDENT CTAs an SM (one for a small product), which share the
(128-column tile, 32-deep K-stage) iterations equally.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build

launches = 0      # kernel launches made by this wrapper

MAX_ROWS = 32     # rows of x the kernel takes (kMaxM)
MAX_PRODUCTS = 3  # products of one x a launch (kMaxSeg)
TILE = 128        # output columns a tile (kBN)
STAGE = 32        # K a pipeline stage (kBK)
RESIDENT = 2      # CTAs an SM holds (__launch_bounds__)
# below this many iterations a CTA at RESIDENT an SM, a product takes one
# CTA an SM: its shared tiles' partial sums cost more than the streams
# gain (measured on the H100 at granite's wk, 4096 x 1024)
MIN_RUN = 4
MAX_TILES = 1 << 16   # column tiles a launch may have (the counters)


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lives on a card (a function of its own, so that the
    CPU tests can route CPU tensors as if they did)."""
    return t.is_cuda


def layout(w: torch.Tensor) -> Optional[Tuple[bool, int]]:
    """(trans, row stride) of a (K, N) weight the kernel reads: row-major
    (K, N) rows ``ldw`` apart (trans False; N a multiple of 4), or the
    transpose of a row-major (N, K) (trans True); K and the row stride
    multiples of 4 and the base 16-byte aligned. None for any other."""
    if w.dim() != 2:
        return None
    K, N = w.shape
    if K < 1 or N < 1 or K % 4 or w.data_ptr() % 16:
        return None
    s0, s1 = w.stride()
    if s1 == 1 and N % 4 == 0 and s0 % 4 == 0 and s0 >= N:
        return False, s0
    if s0 == 1 and s1 % 4 == 0 and s1 >= K:
        return True, s1
    return None


def row_stride(x: torch.Tensor) -> Optional[int]:
    """The row stride of x (..., K) seen as (M, K) without a copy: rows
    whole 16-byte runs, 16-byte aligned. None if it cannot be."""
    K = x.shape[-1]
    try:
        x2 = x.view(-1, K)
    except RuntimeError:
        return None
    if K > 1 and x2.stride(1) != 1:
        return None
    ld = x2.stride(0) if x2.shape[0] > 1 else K
    if ld < K or ld % 4 or x.data_ptr() % 16:
        return None
    return ld


def applies(x: torch.Tensor, *ws: torch.Tensor) -> bool:
    """Whether ``[x @ w for w in ws]`` goes to the kernel in one launch:
    all f32 on one card, x of 1 to MAX_ROWS rows in whole runs, one to
    MAX_PRODUCTS weights in one of the layouts (the same for all), each at
    least TILE columns (a narrower one fills a fraction of a tile:
    measured 3x slower than cuBLAS at N = 64), and no operand that
    requires grad while grad mode is on."""
    if not 1 <= len(ws) <= MAX_PRODUCTS or not on_card(x) \
            or x.dtype != torch.float32 or x.dim() < 1:
        return False
    grad = torch.is_grad_enabled()
    if grad and x.requires_grad:
        return False
    K = x.shape[-1]
    if K < 1 or not 1 <= x.numel() // K <= MAX_ROWS \
            or row_stride(x) is None:
        return False
    lays = set()
    for w in ws:
        if not on_card(w) or w.device != x.device \
                or w.dtype != torch.float32 or (grad and w.requires_grad):
            return False
        if w.dim() != 2 or w.shape[0] != K or w.shape[1] < TILE:
            return False
        lay = layout(w)
        if lay is None:
            return False
        lays.add(lay[0])
    return len(lays) == 1


def tiles(Ns: Sequence[int]) -> int:
    """Column tiles of a launch of products N wide (each its own)."""
    return sum(-(-N // TILE) for N in Ns)


def iterations(K: int, Ns: Sequence[int]) -> int:
    """(column tile, K-stage) iterations of a launch."""
    return tiles(Ns) * -(-K // STAGE)


def ctas(K: int, Ns: Sequence[int], sms: int) -> int:
    """The grid: RESIDENT CTAs an SM; one an SM for a launch of fewer
    than MIN_RUN iterations a CTA at that; one an iteration for a launch
    of fewer iterations than SMs."""
    iters = iterations(K, Ns)
    if iters >= MIN_RUN * RESIDENT * sms:
        return RESIDENT * sms
    return min(sms, iters)


def scratch(Ns: Sequence[int], grid: int) -> int:
    """f32 elements of the partial sums: a MAX_ROWS x TILE slot for each
    (CTA, tile) pair a run can leave unfinished (slot CTA + tile)."""
    return (grid + tiles(Ns)) * MAX_ROWS * TILE


_counters: Dict[int, torch.Tensor] = {}


def _index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def counters(device: torch.device) -> torch.Tensor:
    """The device's per-tile counters (zeros, which every launch leaves
    zero). Made at the device's first launch, which must not be inside a
    graph capture."""
    idx = _index(device)
    c = _counters.get(idx)
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("skinny_mm's first launch on a card must run "
                               "eagerly, not inside a graph capture")
        c = _counters[idx] = torch.zeros(MAX_TILES, dtype=torch.int32,
                                         device=device)
    return c


@functools.lru_cache(maxsize=None)
def _sms(idx: int) -> int:
    return build.sm_count(torch.device("cuda", idx))


def skinny_mm_cuda(x: torch.Tensor, *ws: torch.Tensor) -> List[torch.Tensor]:
    """[x @ w for w in ws] in one launch (see ``applies``); raises for
    operands the kernel does not take."""
    global launches
    if not 1 <= len(ws) <= MAX_PRODUCTS:
        raise ValueError(f"skinny_mm_cuda takes 1 to {MAX_PRODUCTS} weights, "
                         f"got {len(ws)}")
    if not x.is_cuda or any(not w.is_cuda or w.device != x.device
                            for w in ws):
        raise ValueError("skinny_mm_cuda takes x and w on one card")
    if x.dtype != torch.float32 or any(w.dtype != torch.float32 for w in ws):
        raise ValueError(f"skinny_mm_cuda takes f32 operands, got {x.dtype}, "
                         f"{[w.dtype for w in ws]}")
    K = x.shape[-1] if x.dim() else 0
    lays = []
    for w in ws:
        lay = layout(w)
        if lay is None or w.shape[0] != K:
            raise ValueError(f"skinny_mm_cuda: w {tuple(w.shape)} strides "
                             f"{w.stride()} is neither a row-major (K, N) "
                             f"nor the transpose of a row-major (N, K) with "
                             f"K = {K} (and N, row-major) a multiple of 4, "
                             f"16-byte aligned")
        lays.append(lay)
    if len({trans for trans, _ in lays}) != 1:
        raise ValueError("skinny_mm_cuda: the weights of one launch take "
                         "one layout")
    M = x.numel() // K
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"skinny_mm_cuda takes 1 to {MAX_ROWS} rows, got "
                         f"{M}")
    Ns = [w.shape[1] for w in ws]
    if tiles(Ns) > MAX_TILES:
        raise ValueError(f"skinny_mm_cuda takes at most {MAX_TILES} tiles "
                         f"of {TILE} columns, got N = {Ns}")
    ldx = row_stride(x)
    if ldx is None:
        raise ValueError(f"skinny_mm_cuda: x {tuple(x.shape)} strides "
                         f"{x.stride()} is not rows of whole 16-byte runs")
    build.refuse_grad("skinny_mm_cuda", x, *ws)
    grid = ctas(K, Ns, _sms(_index(x.device)))
    ys = [torch.empty(x.shape[:-1] + (N,), dtype=torch.float32,
                      device=x.device) for N in Ns]
    part = torch.empty(scratch(Ns, grid), dtype=torch.float32,
                       device=x.device)
    cnt = counters(x.device)
    n = len(ws)
    with torch.cuda.device(x.device):
        rc = build.library().skinny_mm(
            x.data_ptr(), (ctypes.c_void_p * n)(*[w.data_ptr() for w in ws]),
            (ctypes.c_void_p * n)(*[y.data_ptr() for y in ys]),
            (ctypes.c_int * n)(*Ns),
            (ctypes.c_int * n)(*[ld for _, ld in lays]),
            n, part.data_ptr(), cnt.data_ptr(), M, K, ldx, int(lays[0][0]),
            grid, build.stream_of(x))
    build.check(rc, "skinny_mm")
    launches += 1
    return ys
