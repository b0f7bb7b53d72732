"""Forward passes of the dense decoder-only family, in PyTorch.

Counterpart of the dense subset of ``src/repro/models/modeling.py``:
``forward_prefill`` (the P in P/D: full-sequence forward returning the
first greedy token and the per-layer KV) and ``forward_decode_step`` (the
D: one fused continuous-batching iteration over a paged KV pool).

Layouts follow the JAX package at every public function: activations
(b, s, heads, hd), params as the stacked ``param_specs`` tree, KV caches
(num_blocks, b, s, kv_dim), the pool (attn_layers, NB, BS, 2*kv_dim) with
K and V packed. Differences that come from the framework:

* the layer stack runs as a Python loop, eagerly (no jit); the pool is
  updated IN PLACE by the decode step, where JAX donated and returned it;
* prefill attention goes through ``kernels.ops.flash_prefill`` (GQA in
  the kernel, no K/V repeat), decode attention through
  ``kernels.ops.paged_attention``;
* torch does not promote mixed-dtype matmuls, so ``_mm`` casts both
  operands to JAX's promoted result dtype explicitly.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import block_period, num_blocks, tree_map
from repro_torch.scope import check_dense, unported

Tree = Dict[str, Any]


# ---------------------------------------------------------------- basics

def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in JAX's promoted dtype (f32 @ bf16 -> f32)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    return x @ w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).sum(-1, keepdim=True) / x.shape[-1]
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * w


Rot = Tuple[torch.Tensor, torch.Tensor]


def rope_tables(positions: torch.Tensor, hd: int, theta: float,
                ndim: int) -> Rot:
    """(cos, sin) of the rotary angles at ``positions``, shaped to
    broadcast against an x of ``ndim`` dims: (..., seq, heads, hd) with
    positions (seq,), or (b, heads, hd) with positions (b,). Every layer
    rotates at the same positions, so a forward computes these once."""
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions[..., None].float() * freqs           # (..., half)
    while ang.dim() < ndim:             # broadcast over the heads dim
        ang = ang[..., None, :] if ang.dim() == ndim - 1 else ang[None]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, rot: Rot) -> torch.Tensor:
    cos, sin = rot
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., seq, heads, hd) with positions (seq,), or (b, heads, hd)
    with positions (b,)."""
    return apply_rope(x, rope_tables(positions, x.shape[-1], theta, x.dim()))


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, x.shape[-1] // n))


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))


# ---------------------------------------------------------------- attention

def attention_seq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  nkv: int, *, causal: bool, window: Optional[int] = None,
                  q_offset: int = 0, prefix_pad: Optional[int] = None,
                  q_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal full-sequence attention through the flash-prefill kernel.

    q: (b, s, nq, hd); k, v: (b, sk, nkv, hd). Returns (b, s, nq, hd).
    ``q_offset`` is the absolute position of the first query row;
    ``prefix_pad`` declares that the first prefix_pad key rows are a
    reused prefix padded to a bucket of which only the first q_offset are
    real (without it sk == q_offset + s and every key row is real).
    ``q_valid`` (b,) int32 marks how many leading query rows per batch
    row are real: the others output exactly 0."""
    if not causal or window is not None:
        raise unported("non-causal and sliding-window attention", 11)
    assert k.shape[2] == nkv, (k.shape, nkv)
    return ops.flash_prefill(q, k, v, q_offset=int(q_offset),
                             prefix_pad=int(prefix_pad or 0),
                             q_valid=q_valid)


def _attn_proj_qkv(p: Tree, x: torch.Tensor, cfg: ModelConfig,
                   sfx: str = ""):
    q = _mm(x, p[f"wq{sfx}"])
    k = _mm(x, p[f"wk{sfx}"])
    v = _mm(x, p[f"wv{sfx}"])
    if f"bq{sfx}" in p:
        q = q + p[f"bq{sfx}"]
        k = k + p[f"bk{sfx}"]
        v = v + p[f"bv{sfx}"]
    return q, k, v


def attn_sublayer_seq(p: Tree, h: torch.Tensor, cfg: ModelConfig, *,
                      positions: torch.Tensor,
                      prefix_kv: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                      prefix_len: Optional[int] = None,
                      q_valid: Optional[torch.Tensor] = None,
                      rot: Optional[Rot] = None):
    """Causal self-attention sublayer. Returns (h, (k, v)) with the
    freshly computed (suffix) k/v as (b, s, kv_dim) each.

    ``prefix_kv`` = (k, v) each (b, P, kv_dim): a reused prefix KV, roped
    at its absolute positions and right-padded to the bucket P, of which
    the first ``prefix_len`` rows are real. ``rot`` is ``rope_tables`` at
    ``positions`` when the caller has them."""
    x = rmsnorm(h, p["norm"], cfg.norm_eps)
    q, k, v = _attn_proj_qkv(p, x, cfg)
    if rot is None:
        rot = rope_tables(positions, cfg.hd, cfg.rope_theta, 4)
    q = apply_rope(_split_heads(q, cfg.num_heads), rot)
    k = apply_rope(_split_heads(k, cfg.num_kv_heads), rot)
    v4 = _split_heads(v, cfg.num_kv_heads)
    k_all, v_all, q_off, p_pad = k, v4, 0, None
    if prefix_kv is not None:
        kp, vp = prefix_kv
        p_pad = kp.shape[1]
        q_off = p_pad if prefix_len is None else prefix_len
        k_all = torch.cat(
            [_split_heads(kp.to(k.dtype), cfg.num_kv_heads), k], dim=1)
        v_all = torch.cat(
            [_split_heads(vp.to(v4.dtype), cfg.num_kv_heads), v4], dim=1)
    o = attention_seq(q, k_all, v_all, cfg.num_kv_heads, causal=True,
                      q_offset=q_off, prefix_pad=p_pad, q_valid=q_valid)
    h = h + _mm(_merge_heads(o), p["wo"])
    return h, (_merge_heads(k), v)


# ---------------------------------------------------------------- mlp

def mlp(p: Tree, x: torch.Tensor) -> torch.Tensor:
    return _mm(F.silu(_mm(x, p["w_gate"])) * _mm(x, p["w_up"]), p["w_down"])


def _ffn_sublayer(p: Tree, h: torch.Tensor, cfg: ModelConfig,
                  is_moe: bool) -> torch.Tensor:
    if is_moe:
        raise unported(f"{cfg.name}: MoE feed-forward", 9)
    if cfg.d_ff > 0:
        h = h + mlp(p["mlp"], rmsnorm(h, p["norm2"], cfg.norm_eps))
    return h


# ---------------------------------------------------------------- blocks

def _block_params(params: Tree, blk: int) -> Tree:
    """Views of one repeating block's params (no copies)."""
    return tree_map(lambda x: x[blk], params["blocks"])


def block_seq(cfg: ModelConfig, blk_params: Tree, h: torch.Tensor, *,
              positions: torch.Tensor, prefix: Optional[Tree] = None,
              prefix_len=None, valid_len: Optional[torch.Tensor] = None,
              rot: Optional[Rot] = None) -> Tuple[torch.Tensor, Tree]:
    """Apply one repeating block (period sublayers). Returns (h, cache)
    with cache "sub{i}" -> {"k", "v"} (b, s, kv_dim). ``prefix`` maps
    "sub{i}" -> {"k", "v"} (b, P, kv_dim) reused prefix KV;
    ``valid_len`` (b,) masks right-pad bucket queries."""
    moe_mask = cfg.moe_layer_mask()
    cache_out: Tree = {}
    for i in range(block_period(cfg)):
        p = blk_params[f"sub{i}"]
        pfx = None
        if prefix is not None and prefix.get(f"sub{i}"):
            pfx = (prefix[f"sub{i}"]["k"], prefix[f"sub{i}"]["v"])
        h, (k, v) = attn_sublayer_seq(p, h, cfg, positions=positions,
                                      prefix_kv=pfx, prefix_len=prefix_len,
                                      q_valid=valid_len, rot=rot)
        h = _ffn_sublayer(p, h, cfg, moe_mask[i])
        cache_out[f"sub{i}"] = {"k": k, "v": v}
    return h, cache_out


# ---------------------------------------------------------------- full fwd

def forward_seq(cfg: ModelConfig, params: Tree, batch: Tree, *,
                prefix: Optional[Tree] = None, prefix_len: int = 0,
                valid_len: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Tree]:
    """Prefill path. Returns (hidden (b, s, d), cache) with cache
    "sub{i}" -> {"k", "v"} (num_blocks, b, s, kv_dim).

    With ``prefix`` ("sub{i}" -> {"k", "v"} of (num_blocks, b, P,
    kv_dim), P the prefix bucket) the batch holds only the uncached
    suffix tokens, positioned from ``prefix_len`` (<= P; padded prefix
    rows are masked out of attention)."""
    check_dense(cfg)
    emb = params["embed"]
    h = emb[batch["tokens"].long()].to(emb.dtype)
    s = h.shape[1]
    positions = prefix_len + torch.arange(s, device=h.device)
    rot = rope_tables(positions, cfg.hd, cfg.rope_theta, 4)
    per_block = []
    for blk in range(num_blocks(cfg)):
        pfx = None
        if prefix is not None:
            pfx = {sub: ({"k": c["k"][blk], "v": c["v"][blk]} if c else {})
                   for sub, c in prefix.items()}
        h, cache = block_seq(cfg, _block_params(params, blk), h,
                             positions=positions, prefix=pfx,
                             prefix_len=prefix_len if prefix is not None
                             else None, valid_len=valid_len, rot=rot)
        per_block.append(cache)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    caches = {sub: {k: torch.stack([c[sub][k] for c in per_block])
                    for k in per_block[0][sub]}
              for sub in per_block[0]}
    return h, caches


def lm_logits(cfg: ModelConfig, params: Tree, h: torch.Tensor
              ) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w.to(h.dtype)


def forward_prefill(cfg: ModelConfig, params: Tree, batch: Tree,
                    last_index: Optional[torch.Tensor] = None,
                    prefix: Optional[Tree] = None, prefix_len: int = 0
                    ) -> Tuple[torch.Tensor, Tree]:
    """Returns (first generated token (b,) int32, cache).

    ``last_index`` (b,) selects each row's last prompt position in a
    right-padded batch AND masks the rows past it (pad-invariance: padded
    queries attend to nothing). With ``prefix``/``prefix_len`` (see
    forward_seq) the returned cache covers only the suffix tokens; the
    caller stitches prefix ++ suffix."""
    valid_len = None if last_index is None \
        else (last_index.to(torch.int32) + 1).contiguous()
    h, caches = forward_seq(cfg, params, batch, prefix=prefix,
                            prefix_len=prefix_len, valid_len=valid_len)
    if last_index is None:
        h_last = h[:, -1, :]
    else:
        h_last = h[torch.arange(h.shape[0], device=h.device),
                   last_index.long()]
    first = torch.argmax(lm_logits(cfg, params, h_last), dim=-1).to(
        torch.int32)
    return first, {"layers": caches, "pos": prefix_len + h.shape[1]}


# ---------------------------------------------------------------- decode

def _decode_step_core(cfg: ModelConfig, params: Tree, storage: torch.Tensor,
                      block_tables: torch.Tensor, tokens: torch.Tensor,
                      pos: torch.Tensor, active: torch.Tensor,
                      slot_layers: Tree, *, block_size: int,
                      write_rows: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, Tree]:
    """One decode iteration's layer loop: (argmax token, storage,
    slot_layers), the pool storage updated in place.

    Each slot's new KV row is written at (block_tables[slot, pos // BS],
    pos % BS) of every attention layer, write-then-attend. Only the rows
    in ``write_rows`` (int64 slot indices: the active slots, which the
    caller knows on the host) are written. Inactive slots compute garbage
    rows that touch nothing: where JAX routed their writes out of range and dropped them,
    an out-of-range index_put_ on the card is a device assert, so the
    port writes the chosen rows only."""
    check_dense(cfg)
    bs = block_size
    period = block_period(cfg)
    moe_mask = cfg.moe_layer_mask()
    pool_dtype = storage.dtype
    pos = pos.to(torch.int32)
    lens = (pos + 1).contiguous()                 # incl. the current token
    col = (pos // bs).clamp(0, block_tables.shape[1] - 1).long()
    tok_blk = block_tables.gather(1, col[:, None])[:, 0]
    tok_off = pos % bs
    wb = tok_blk[write_rows].long()
    wo = tok_off[write_rows].long()
    rot = rope_tables(pos, cfg.hd, cfg.rope_theta, 3)   # shared by layers
    h = params["embed"][tokens.long()].float()
    for blk in range(num_blocks(cfg)):
        bp = _block_params(params, blk)
        for i in range(period):
            p = bp[f"sub{i}"]
            li = blk * period + i                 # dense: every layer attends
            x = rmsnorm(h, p["norm"], cfg.norm_eps)
            q, k, v = _attn_proj_qkv(p, x, cfg)
            q4 = apply_rope(_split_heads(q, cfg.num_heads), rot)
            k4 = apply_rope(_split_heads(k, cfg.num_kv_heads), rot)
            kv_tok = torch.cat([_merge_heads(k4), v], -1).to(pool_dtype)
            page = storage[li]
            page.index_put_((wb, wo), kv_tok[write_rows])
            o = ops.paged_attention(q4.to(pool_dtype), page, block_tables,
                                    lens)
            h = h + _mm(_merge_heads(o).to(h.dtype), p["wo"])
            h = _ffn_sublayer(p, h, cfg, moe_mask[i])
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    nxt = torch.argmax(lm_logits(cfg, params, h), dim=-1).to(torch.int32)
    return nxt, storage, slot_layers


def forward_decode_step(cfg: ModelConfig, params: Tree, storage: torch.Tensor,
                        block_tables: torch.Tensor, tokens: torch.Tensor,
                        pos: torch.Tensor, active: torch.Tensor,
                        slot_layers: Tree, *, block_size: int,
                        write_rows: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor, Tree]:
    """ONE fused decode iteration over a fixed slot set.

    storage:      (attn_layers, NB, BS, W) paged pool, updated in place.
    block_tables: (n_slots, T) int32, -1 padded.
    tokens/pos:   (n_slots,) int32 last emitted token / tokens so far.
    active:       (n_slots,) bool slot mask.
    write_rows:   int64 indices of the slots whose KV row is written:
                  the active slots, known on the host, so a step makes no
                  extra device->host sync.

    Returns (next_token, new_tokens, new_pos, storage, slot_layers);
    next_token is the on-device argmax, the caller's one host transfer."""
    nxt, storage, slot_layers = _decode_step_core(
        cfg, params, storage, block_tables, tokens, pos, active,
        slot_layers, block_size=block_size, write_rows=write_rows)
    new_tokens = torch.where(active, nxt, tokens)
    new_pos = pos.to(torch.int32) + active.to(torch.int32)
    return nxt, new_tokens, new_pos, storage, slot_layers
