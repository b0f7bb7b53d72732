"""Plain PyTorch versions of the kernels.

Each computes what its CUDA kernel computes, in the simplest tensor code:
the CPU tests run these, and the card compares every kernel with its
plain version on the same inputs. Counterpart of ``src/repro/kernels/
ref.py``, with two differences of contract:

* ``kv_scatter`` writes the storage in place (the pool is mutable here)
  and returns it;
* ``paged_attention`` follows the KERNEL on rows with no live token
  (``lens == 0``, or only -1 table entries): they output exactly 0,
  where the JAX oracle averages V over the clipped block 0. Table entries
  outside [0, NB) are masked, as in the kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch


def _wide(x: torch.Tensor) -> torch.Tensor:
    """The attention versions compute in f32 (f64 inputs stay f64, for
    torch.autograd.gradcheck)."""
    return x if x.dtype == torch.float64 else x.float()


def kv_gather(storage: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """storage: (L, NB, BS, W); idx: (n,) -> fresh (L, n*BS, W)."""
    L, _, bs, w = storage.shape
    return storage[:, idx.long()].reshape(L, idx.shape[0] * bs, w)


def kv_scatter(storage: torch.Tensor, buf: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """storage: (L, NB, BS, W) updated in place from buf (L, n*BS, W)."""
    L, _, bs, w = storage.shape
    storage[:, idx.long()] = buf.reshape(L, idx.shape[0], bs, w).to(
        storage.dtype)
    return storage


def paged_attention(q: torch.Tensor, kv_pages: torch.Tensor,
                    block_table: torch.Tensor, lens: torch.Tensor
                    ) -> torch.Tensor:
    """q: (B, nq, hd); kv_pages: (NB, BS, 2*kvd); block_table: (B, MAXB)
    (-1 padded); lens: (B,). Returns (B, nq, hd) in q's dtype."""
    B, nq, hd = q.shape
    NB, BS, W = kv_pages.shape
    kvd = W // 2
    nkv = kvd // hd
    g = nq // nkv
    maxb = block_table.shape[1]
    bt = block_table.long()
    live_blk = (bt >= 0) & (bt < NB)
    kv = kv_pages[bt.clamp(0, NB - 1)].reshape(B, maxb * BS, W).float()
    k = kv[..., :kvd].reshape(B, maxb * BS, nkv, hd)
    v = kv[..., kvd:].reshape(B, maxb * BS, nkv, hd)
    qg = q.float().reshape(B, nkv, g, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k) / math.sqrt(hd)
    pos = torch.arange(maxb * BS, device=q.device)
    live = (pos[None] < lens.long()[:, None]) \
        & live_blk.repeat_interleave(BS, dim=1)            # (B, S)
    scores = scores.masked_fill(~live[:, None, None], -1e30)
    p = torch.exp(scores - scores.amax(-1, keepdim=True)) \
        * live[:, None, None]
    out = torch.einsum("bkgs,bskd->bkgd", p, v) \
        / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, nq, hd).to(q.dtype)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_offset: Union[int, torch.Tensor] = 0, prefix_pad: int = 0,
                  q_valid: Optional[torch.Tensor] = None,
                  causal: bool = True, window: Optional[int] = None
                  ) -> torch.Tensor:
    """Causal attention. q: (b, s, nq, hd); k/v: (b, P + s, nkv, hd) with
    P = prefix_pad (or q_offset when prefix_pad == 0): query row i sits at
    absolute position q_offset + i; the first P key rows are a reused
    prefix of which only the first q_offset are real. ``q_valid`` (b,)
    marks how many leading query rows per batch row are real; the others
    output exactly 0. ``causal=False``: every one of the sk key rows is
    live for every real query row (no prefix). ``window=W`` (causal
    only, JAX's jnp mask): a query at absolute position p sees only the
    live keys at positions > p - W. ``q_offset`` may be a 0-d int32
    tensor (JAX's traced prefix length), clamped into [0, P] as the
    kernel clamps it. Returns (b, s, nq, hd) in q's dtype."""
    b, s, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    # causal with no prefix_pad: sk == q_offset + s
    pfx = prefix_pad if prefix_pad or not causal else sk - s
    q_offset = torch.as_tensor(q_offset).reshape(()).clamp(0, pfx)
    dev = q.device
    kf = _wide(k).repeat_interleave(g, dim=2)
    vf = _wide(v).repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", _wide(q), kf) / math.sqrt(hd)
    qrel = torch.arange(s, device=dev)
    kj = torch.arange(sk, device=dev)
    is_pfx = kj < pfx
    kpos = torch.where(is_pfx, kj, q_offset + (kj - pfx))
    kvalid = ~is_pfx | (kj < q_offset)
    live = kvalid[None, :]
    if causal:
        qpos = q_offset + qrel[:, None]
        live = live & (kpos[None, :] <= qpos)
        if window is not None:
            live = live & (qpos - kpos[None, :] < window)
    mask = live[None].expand(b, s, sk)
    if q_valid is not None:
        mask = mask & (qrel[None, :] < q_valid.long()[:, None])[..., None]
    scores = scores.masked_fill(~mask[:, None], -1e30)
    probs = torch.softmax(scores, dim=-1) * mask[:, None]
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)


def flash_prefill_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_prefill`` with no prefix and no q_valid, plus the row
    log-sum-exp of the scaled scores over the live keys: (o (b, s, nq,
    hd) in q's dtype, lse (b, nq, s) f32). The training forward: the
    backward recomputes the probabilities from lse."""
    hd = q.shape[-1]
    g = q.shape[2] // k.shape[2]
    s, sk = q.shape[1], k.shape[1]
    kf = _wide(k).repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", _wide(q), kf) / math.sqrt(hd)
    if causal:
        live = torch.ones(s, sk, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~live, -math.inf)
    lse = torch.logsumexp(scores, dim=-1)
    return flash_prefill(q, k, v, causal=causal), lse


def flash_prefill_combine(parts: torch.Tensor, lses: torch.Tensor,
                          q_valid: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge non-causal attention computed over n ranges of the keys:
    parts (n, b, s, nq, hd) each range's output, lses (n, b, nq, s) each
    range's natural-log LSE (``flash_prefill_fwd(..., causal=False)`` on
    the range's keys). Returns (out (b, s, nq, hd) in parts' dtype, lse
    (b, nq, s)) by the log-sum-exp rule; query rows past ``q_valid`` are
    exactly 0 with lse +inf. The plain version of the split kernel's
    merge (csrc/flash_prefill.cu: flash_prefill_combine_kernel)."""
    lse = torch.logsumexp(lses, dim=0)                       # (b, nq, s)
    w = torch.exp(lses - lse).permute(0, 1, 3, 2)[..., None]
    out = (w * _wide(parts)).sum(0)
    if q_valid is not None:
        s = parts.shape[2]
        past = torch.arange(s, device=parts.device)[None] \
            >= q_valid.long()[:, None]                      # (b, s)
        out = out.masked_fill(past[..., None, None], 0.0)
        lse = lse.masked_fill(past[:, None, :], math.inf)
    return out.to(parts.dtype), lse


def flash_prefill_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      causal: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of ``flash_prefill_fwd``'s output, each in
    its input's dtype, by the FlashAttention-2 backward: P recomputed from
    lse, D = rowsum(dO * O), dS = P * (dP - D) with dP = dO V^T; dq = dS K
    and dk = dS^T Q (both times the softmax scale), dv = P^T dO; dk and
    dv summed over the g query heads of each kv head."""
    b, s, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    scale = 1.0 / math.sqrt(hd)
    qf, dof = _wide(q), _wide(do)
    kf = _wide(k).repeat_interleave(g, dim=2)
    vf = _wide(v).repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) / math.sqrt(hd)
    p = torch.exp(scores - lse[..., None])
    if causal:
        live = torch.ones(s, sk, dtype=torch.bool, device=q.device).tril()
        p = torch.where(live, p, 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    d_row = (dof * _wide(o)).sum(-1).transpose(1, 2)          # (b, nq, s)
    ds = p * (dp - d_row[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale

    def per_kv_head(x: torch.Tensor) -> torch.Tensor:
        return x.reshape(b, sk, nkv, g, hd).sum(3)
    return (dq.to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))


def _segments(offsets: torch.Tensor):
    """(expert, first row, end row) of every non-empty group, read on the
    host: the plain version runs on the CPU."""
    bounds = offsets.tolist()
    return [(e, lo, hi) for e, (lo, hi) in enumerate(zip(bounds[:-1],
                                                         bounds[1:]))
            if hi > lo]


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
               trans: bool = False) -> torch.Tensor:
    """``lax.ragged_dot(x, w, group_sizes)`` with ``offsets`` (E+1,) the
    exclusive cumsum of the group sizes: row r gets x[r] @ w[e] (w (E,
    K, N)), or x[r] @ w[e]^T with ``trans`` (w (E, N, K)), for
    offsets[e] <= r < offsets[e+1]; rows outside every group are zero.
    One matmul per expert over its contiguous rows, the sizes read on the
    host."""
    M = x.shape[0]
    N = w.shape[1] if trans else w.shape[2]
    y = torch.zeros((M, N), dtype=x.dtype, device=x.device)
    for e, lo, hi in _segments(offsets):
        we = w[e].t() if trans else w[e]
        y[lo:hi] = x[lo:hi] @ we
    return y


def grouped_mm_dw(x: torch.Tensor, dy: torch.Tensor, offsets: torch.Tensor,
                  E: int) -> torch.Tensor:
    """The weight gradient of ``grouped_mm``: (E, K, N) with dw[e] =
    x_e^T @ dy_e over the group's rows, zeros for an empty group."""
    dw = torch.zeros((E, x.shape[1], dy.shape[1]), dtype=x.dtype,
                     device=x.device)
    for e, lo, hi in _segments(offsets):
        dw[e] = x[lo:hi].t() @ dy[lo:hi]
    return dw


def skinny_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N)."""
    return x @ w
