"""Plain PyTorch versions of the four kernels.

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
from typing import Optional

import torch


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
                  q_offset: int = 0, prefix_pad: int = 0,
                  q_valid: Optional[torch.Tensor] = None,
                  causal: bool = True) -> torch.Tensor:
    """Causal attention. q: (b, s, nq, hd); k/v: (b, P + s, nkv, hd) with
    P = prefix_pad (or q_offset when prefix_pad == 0): query row i sits at
    absolute position q_offset + i; the first P key rows are a reused
    prefix of which only the first q_offset are real. ``q_valid`` (b,)
    marks how many leading query rows per batch row are real; the others
    output exactly 0. ``causal=False``: every one of the sk key rows is
    live for every real query row (no prefix). Returns (b, s, nq, hd) in
    q's dtype."""
    b, s, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    pfx = prefix_pad if prefix_pad else q_offset
    dev = q.device
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(hd)
    qrel = torch.arange(s, device=dev)
    kj = torch.arange(sk, device=dev)
    is_pfx = kj < pfx
    kpos = torch.where(is_pfx, kj, q_offset + (kj - pfx))
    kvalid = ~is_pfx | (kj < q_offset)
    live = kvalid[None, :]
    if causal:
        live = live & (kpos[None, :] <= q_offset + qrel[:, None])
    mask = live[None].expand(b, s, sk)
    if q_valid is not None:
        mask = mask & (qrel[None, :] < q_valid.long()[:, None])[..., None]
    scores = scores.masked_fill(~mask[:, None], -1e30)
    probs = torch.softmax(scores, dim=-1) * mask[:, None]
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)
