"""Wrapper of the hand-written CUDA kernels ``csrc/grouped_mm.cu``.

The grouped matrix product of sorted MoE dispatch, the counterpart of
``lax.ragged_dot`` (which the JAX package's ``_moe_dispatch_sorted``
calls three times; XLA computes it outside any Pallas kernel). x (M, K)
holds the assignments sorted by expert and ``offsets`` (E+1,) int32 on
the card is the exclusive cumsum of the group sizes:

* ``grouped_mm_cuda(x, w, offsets)``: w (E, K, N); row r of the (M, N)
  output is x[r] @ w[e] for offsets[e] <= r < offsets[e+1], zero outside
  every group;
* ``grouped_mm_cuda(x, w, offsets, trans=True)``: w (E, N, K) and
  x[r] @ w[e]^T, the input gradient;
* ``grouped_mm_dw_cuda(x, dy, offsets, E)``: (E, K, N) with dw[e] =
  x_e^T @ dy_e over the group's rows (zeros for an empty group), the
  weight gradient.

f32 or bf16 (x and w of one dtype), f32 accumulation. The group sizes
never reach the host: every launch has a grid fixed by the shapes, so a
step that calls these can be captured in a CUDA graph.

The forward and transposed product take one of two paths, which
``plan`` picks from (M, K, N, E, dtype) alone: the rows path (a few rows
an expert, as at decode: the touched experts' weights streamed once,
split along K, the splits' f32 partials summed in order by a second
pass) or the tiles path (row tiles of each group, as in a prefill
chunk: the tensor cores in bf16, the CUDA cores in f32). The weight
gradient takes the same two paths at the same threshold (``plan_dw``):
slabs of whole dw rows written once as a stream (decode), or output
tiles contracted over the group's rows (a prefill chunk, a training
step: ``wgmma`` in bf16, the CUDA cores in f32).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import build

launches = 0      # forward launches (x @ w[e])
dx_launches = 0   # transposed launches (the input gradient)
dw_launches = 0   # weight-gradient launches

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the constants of csrc/grouped_mm.cu the plan depends on
ROWS_MEAN = 16          # below this many rows an expert on average: rows path
ROW_CHUNK = {False: 8, True: 4}   # group rows a pass (kR, kRT with trans)
X_BYTES = {False: 16384, True: 32768}  # a pass's rows of x (kXBytes, kXTBytes)
FWD_COLS = 2048         # output columns a forward rows-path CTA (kNT)
# rows-path CTAs with work: 6.5 for each SM of an H100, two resident at a
# time, so the last of about three waves is nearly full (measured at
# qwen2-moe's decode: the time rises and falls with that last wave)
CTA_TARGET = 858
MIN_SLAB = 128 << 10    # ... but no fewer weight bytes a CTA than this
# the weight gradient's rows path (csrc/grouped_mm.cu): a CTA's threads
# (a multiple of 32, at most DW_CHUNK, chosen by plan_dw) each own one
# 16-byte piece of a dw row and write it in every row of a slab of kc
# rows, kc a multiple of 4 up to DW_MAX_KC, chosen so that a CTA writes
# about DW_SLAB_BYTES
DW_CHUNK = 512
DW_MAX_KC = 256
DW_SLAB_BYTES = 64 << 10


@dataclass(frozen=True)
class Plan:
    """How one forward or transposed call runs: ``path`` 0 (rows) or 1
    (tiles); for the rows path the K-range of each of ``splits`` CTAs
    along K (``kc``, a multiple of 8) and the output columns of a CTA
    (``nt``)."""
    path: int
    splits: int = 1
    kc: int = 8
    nt: int = FWD_COLS
    trans: bool = False

    def scratch(self, M: int, N: int) -> int:
        """f32 elements of the partial sums the rows path writes (TRANS
        with one K-range writes its output directly)."""
        if self.path == 1 or (self.trans and self.splits == 1):
            return 0
        return self.splits * M * N


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(M: int, K: int, N: int, E: int, dtype: torch.dtype,
         trans: bool) -> Plan:
    """The path, K-splits and tile width of ``grouped_mm_cuda`` from the
    shapes and dtype alone (never from the group sizes, which stay on the
    card). The rows path aims at ``CTA_TARGET`` CTAs with work when
    min(E, M) experts hold rows, each streaming at least ``MIN_SLAB``
    bytes of weights; its K-range is capped so that a pass's rows of x
    fit ``X_BYTES`` (staged as f32 in the forward, in the input dtype
    with ``trans``). With ``trans`` a CTA reads whole rows of w[e] (N,
    K), so it is split along K only when K overflows that buffer."""
    if E == 0 or M >= ROWS_MEAN * E:
        return Plan(1, trans=trans)
    busy = max(1, min(E, M))
    es = torch.empty((), dtype=dtype).element_size()
    xsize = es if trans else 4
    splits = max(1, _cdiv(K, X_BYTES[trans] // (ROW_CHUNK[trans] * xsize)))
    if trans:
        kc = 8 * _cdiv(_cdiv(K, splits), 8)
        tiles = max(1, min(_cdiv(CTA_TARGET, busy * splits),
                           _cdiv(N * kc * es, MIN_SLAB), _cdiv(N, 8)))
        nt = _cdiv(N, tiles)
    else:
        want = min(_cdiv(CTA_TARGET, busy * _cdiv(N, FWD_COLS)),
                   _cdiv(K * min(N, FWD_COLS) * es, MIN_SLAB))
        kc = 8 * _cdiv(_cdiv(K, max(splits, want)), 8)
        nt = FWD_COLS
    kc = max(8, kc)
    return Plan(0, max(1, _cdiv(K, kc)), kc, nt, trans)


@dataclass(frozen=True)
class DwPlan:
    """How one weight-gradient call runs: ``path`` 0 (rows: slabs of
    ``kc`` whole dw rows, ``threads`` 16-byte pieces of a row a CTA) or 1
    (tiles)."""
    path: int
    kc: int = 0
    threads: int = 0


def plan_dw(M: int, K: int, N: int, E: int, dtype: torch.dtype) -> DwPlan:
    """The path and slab of ``grouped_mm_dw_cuda`` from the shapes and
    dtype alone (never from the group sizes, which stay on the card): the
    rows path while M < ROWS_MEAN * E, as the forward's, with slabs of
    about DW_SLAB_BYTES a CTA; else the tiles path."""
    if E == 0 or M >= ROWS_MEAN * E:
        return DwPlan(1)
    es = torch.empty((), dtype=dtype).element_size()
    pieces = min(_cdiv(N, 16 // es), DW_CHUNK)    # of a row, a CTA
    kc = 4 * max(1, round(DW_SLAB_BYTES / (16 * pieces) / 4))
    return DwPlan(0, min(kc, DW_MAX_KC, 4 * _cdiv(max(K, 1), 4)),
                  32 * _cdiv(pieces, 32))


def _vec(*ts: torch.Tensor, dims=()) -> bool:
    """Whole 16-byte runs can go by cp.async: every base 16-byte aligned
    and every row length a multiple of 16 bytes."""
    per = 16 // ts[0].element_size()
    return all(t.data_ptr() % 16 == 0 for t in ts) \
        and all(d % per == 0 for d in dims)


def _check(name: str, a: torch.Tensor, b: torch.Tensor,
           offsets: torch.Tensor, E: int) -> None:
    dev = a.device
    if not a.is_cuda or b.device != dev or offsets.device != dev:
        raise ValueError(f"{name} takes its tensors on one card")
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype:
        raise ValueError(f"{name}: operands must share a dtype in "
                         f"{list(DTYPE_CODES)}, got {a.dtype}, {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (E + 1,) \
            or not offsets.is_contiguous():
        raise ValueError(f"{name}: offsets must be a contiguous ({E + 1},) "
                         f"int32 tensor, got {offsets.dtype} "
                         f"{tuple(offsets.shape)}")


def grouped_mm_cuda(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                    trans: bool = False) -> torch.Tensor:
    global launches, dx_launches
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"grouped_mm_cuda takes x (M, K) and w (E, K, N), "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    M, K = x.shape
    E = w.shape[0]
    N, Kw = (w.shape[1], w.shape[2]) if trans else (w.shape[2], w.shape[1])
    if Kw != K:
        raise ValueError(f"grouped_mm_cuda: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} (trans={trans}) do not chain")
    _check("grouped_mm_cuda", x, w, offsets, E)
    build.refuse_grad("grouped_mm_cuda", x, w)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    p = plan(M, K, N, E, x.dtype, trans)
    part = torch.empty(p.scratch(M, N), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        rc = build.library().grouped_mm(
            x.data_ptr(), w.data_ptr(), offsets.data_ptr(), y.data_ptr(),
            part.data_ptr(), M, K, N, E, int(trans),
            int(_vec(x, w, y, dims=(K, N))), DTYPE_CODES[x.dtype], p.path,
            p.splits, p.kc, p.nt, build.stream_of(x))
    build.check(rc, "grouped_mm")
    if trans:
        dx_launches += 1
    else:
        launches += 1
    return y


def grouped_mm_dw_cuda(x: torch.Tensor, dy: torch.Tensor,
                       offsets: torch.Tensor, E: int) -> torch.Tensor:
    global dw_launches
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"grouped_mm_dw_cuda takes x (M, K) and dy (M, N), "
                         f"got {tuple(x.shape)}, {tuple(dy.shape)}")
    M, K = x.shape
    N = dy.shape[1]
    _check("grouped_mm_dw_cuda", x, dy, offsets, E)
    build.refuse_grad("grouped_mm_dw_cuda", x, dy)
    dw = torch.empty((E, K, N), dtype=x.dtype, device=x.device)
    if E == 0 or K == 0 or N == 0:
        return dw
    p = plan_dw(M, K, N, E, x.dtype)
    with torch.cuda.device(x.device):
        rc = build.library().grouped_mm_dw(
            x.data_ptr(), dy.data_ptr(), offsets.data_ptr(), dw.data_ptr(),
            M, K, N, E, int(_vec(x, dy, dw, dims=(K, N))),
            DTYPE_CODES[x.dtype], p.path, p.kc, p.threads,
            build.stream_of(x))
    build.check(rc, "grouped_mm_dw")
    dw_launches += 1
    return dw
