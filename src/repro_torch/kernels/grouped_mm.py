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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = 0      # forward launches (x @ w[e])
dx_launches = 0   # transposed launches (the input gradient)
dw_launches = 0   # weight-gradient launches

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
    with torch.cuda.device(x.device):
        rc = build.library().grouped_mm(
            x.data_ptr(), w.data_ptr(), offsets.data_ptr(), y.data_ptr(),
            M, K, N, E, int(trans), int(_vec(x, w, y, dims=(K, N))),
            DTYPE_CODES[x.dtype], build.stream_of(x))
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
    with torch.cuda.device(x.device):
        rc = build.library().grouped_mm_dw(
            x.data_ptr(), dy.data_ptr(), offsets.data_ptr(), dw.data_ptr(),
            M, K, N, E, int(_vec(x, dy, dims=(K, N))), DTYPE_CODES[x.dtype],
            build.stream_of(x))
    build.check(rc, "grouped_mm_dw")
    dw_launches += 1
    return dw
