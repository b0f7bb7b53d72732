"""Forward passes of every served family, in PyTorch: dense, MoE, Mamba2
(SSM), hybrid attention/Mamba/MoE stacks, the encoder-decoder (whisper)
and the VLM backbone (pixtral, token-only as in the JAX package).

Counterpart of ``src/repro/models/modeling.py``: ``forward_train``
(the training loss: the full-sequence forward, optionally rematerialised
block by block, and a chunked cross-entropy), ``forward_prefill``
(the P in P/D: full-sequence forward returning the first greedy token,
the per-layer KV, the cross-attention KV of an encoder-decoder, and the
Mamba hand-off state and snapshots), ``forward_decode_step`` (the D:
one fused continuous-batching iteration over a paged KV pool and
per-slot Mamba and cross-attention state), its speculative twin
``forward_spec_decode_step`` (a draft proposes, the target verifies, each
slot commits 1..k+1 tokens) and ``forward_decode`` (one step over a dense
per-request cache: the b=1 speculation oracle's decode).

Layouts follow the JAX package at every public function: activations
(b, s, heads, hd), params as the stacked ``param_specs`` tree, KV caches
(num_blocks, b, s, kv_dim), the pool (attn_layers, NB, BS, 2*kv_dim) with
K and V packed. Differences that come from the framework:

* the layer stack runs as a Python loop, eagerly (no jit); the pool is
  updated IN PLACE by the decode step, where JAX donated and returned it;
* sequence attention, causal (prefill) or not (the whisper encoder and
  cross-attention), goes through ``kernels.ops.flash_prefill`` (GQA in
  the kernel, no K/V repeat; differentiable for the causal training mask
  through its hand-written backward), decode self-attention through
  ``kernels.ops.paged_attention``; the one-query cross-attention of the
  decode step is plain torch (``attention_decode``), as JAX computes it
  outside any Pallas kernel;
* torch does not promote mixed-dtype matmuls, so ``_mm`` casts both
  operands to JAX's promoted result dtype explicitly; a product of at
  most 32 f32 rows on the card (every dense product of the decode step,
  and the head) goes through ``kernels.ops.skinny_mm``, a hand-written
  kernel that streams the weight once, chosen by the operands alone
  (``ops.skinny_mm_applies``), products of one x (q, k, v; gate, up) in
  one launch (``_mm_shared``): the rest is ``x @ w``, as in XLA;
* the sorted MoE dispatch's grouped products (JAX's ``lax.ragged_dot``)
  go through ``kernels.ops.grouped_mm``, a hand-written kernel on the
  card; the capacity dispatch's expert products and the SSD scan are
  plain torch matmuls and einsums, as they are plain XLA ops (no Pallas
  kernel) in JAX; sharding hints (``constrain``) have no counterpart.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.caches import SSM_LEAVES, select_slot_state
from repro_torch.models.config import ATTN, ModelConfig
from repro_torch.models.params import block_period, num_blocks, tree_map

Tree = Dict[str, Any]


# ---------------------------------------------------------------- basics

def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in JAX's promoted dtype (f32 @ bf16 -> f32); through the
    skinny kernel where ``ops.skinny_mm_applies`` holds."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    if ops.skinny_mm_applies(x, w):
        return ops.skinny_mm(x, w)[0]
    return x @ w


def _mm_shared(x: torch.Tensor, *ws: torch.Tensor) -> list:
    """[_mm(x, w) for w in ws], the products of one x: one skinny launch
    for all of them where ``ops.skinny_mm_applies`` holds for them
    together."""
    if ops.skinny_mm_applies(x, *ws):
        return ops.skinny_mm(x, *ws)
    return [_mm(x, w) for w in ws]


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
                  q_offset: Union[int, torch.Tensor] = 0,
                  prefix_pad: Optional[int] = None,
                  q_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention through the flash-prefill kernel.

    q: (b, s, nq, hd); k, v: (b, sk, nkv, hd). Returns (b, s, nq, hd).
    Causal: ``q_offset`` is the absolute position of the first query row
    (an int, or a 0-d int32 tensor on q's device that the kernel reads
    there, JAX's traced ``prefix_len``);
    ``prefix_pad`` declares that the first prefix_pad key rows are a
    reused prefix padded to a bucket of which only the first q_offset are
    real (without it sk == q_offset + s and every key row is real).
    Non-causal (the encoder, cross-attention): every key row is live and
    sk is free. ``q_valid`` (b,) int32 marks how many leading query rows
    per batch row are real: the others output exactly 0. ``window`` W
    (causal only, as in JAX, where the mask sits under ``if causal``): a
    query at absolute position p sees the keys at positions > p - W,
    through the kernel's window mode."""
    assert k.shape[2] == nkv, (k.shape, nkv)
    if not isinstance(q_offset, torch.Tensor):
        q_offset = int(q_offset)
    return ops.flash_prefill(q, k, v, q_offset=q_offset,
                             prefix_pad=int(prefix_pad or 0),
                             q_valid=q_valid, causal=causal, window=window)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, nkv: int, pos, *,
                     window: Optional[int] = None,
                     k_new: Optional[torch.Tensor] = None,
                     v_new: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-query attention against a flat cache, plain torch (JAX computes
    it outside any Pallas kernel): q (b, nq, hd); k_cache, v_cache (b, S,
    kv_dim), of which the slots < ``pos`` are live. The decode step uses
    it for cross-attention over the encoder's KV (pos = S); the dense-cache
    decode (``block_decode``) passes the current token's k/v as ``k_new``,
    ``v_new`` (b, kv_dim) against the cache BEFORE that token is written.
    With ``window`` the cache is a ring buffer of length S == window: the
    slot being overwritten (pos % S) holds the token that just fell out
    of the window, so the live slots are those < min(pos, S) other than
    it (JAX's mask)."""
    b, nq, hd = q.shape
    S = k_cache.shape[1]
    g = nq // nkv
    scale = 1.0 / math.sqrt(hd)
    k = _split_heads(k_cache, nkv)                   # (b, S, nkv, hd)
    v = _split_heads(v_cache, nkv)
    qg = q.reshape(b, nkv, g, hd)
    dt = torch.promote_types(q.dtype, k.dtype)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.to(dt),
                          k.to(dt)).float() * scale
    slots = torch.arange(S, device=q.device)
    if window is not None:
        p = torch.as_tensor(pos, device=q.device)
        valid = (slots < p.clamp(max=S)) & (slots != p % S)
    else:
        valid = slots < pos
    scores = scores.masked_fill(~valid, -1e30)
    if k_new is None:
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgs,bskd->bkgd", probs.to(v.dtype), v)
        return out.reshape(b, nq, hd)
    kn = k_new.reshape(b, nkv, hd)
    vn = v_new.reshape(b, nkv, hd)
    s_new = torch.einsum("bkgd,bkd->bkg", qg.to(dt), kn.to(dt)).float() \
        * scale
    probs = torch.softmax(torch.cat([scores, s_new[..., None]], -1), dim=-1)
    pc, pn = probs[..., :S], probs[..., S]
    out = torch.einsum("bkgs,bskd->bkgd", pc.to(v.dtype), v)
    out = out + pn.to(v.dtype)[..., None] * vn[:, :, None, :]
    return out.reshape(b, nq, hd)


def _attn_proj_qkv(p: Tree, x: torch.Tensor, cfg: ModelConfig,
                   sfx: str = ""):
    q, k, v = _mm_shared(x, p[f"wq{sfx}"], p[f"wk{sfx}"], p[f"wv{sfx}"])
    if f"bq{sfx}" in p:
        q = q + p[f"bq{sfx}"]
        k = k + p[f"bk{sfx}"]
        v = v + p[f"bv{sfx}"]
    return q, k, v


def attn_sublayer_seq(p: Tree, h: torch.Tensor, cfg: ModelConfig, *,
                      positions: Optional[torch.Tensor],
                      causal: bool = True, use_rope: bool = True,
                      prefix_kv: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                      prefix_len: Optional[Union[int,
                                                 torch.Tensor]] = None,
                      q_valid: Optional[torch.Tensor] = None,
                      rot: Optional[Rot] = None,
                      window: Optional[int] = None):
    """Self-attention sublayer: causal in the decoder, not in the encoder
    (which also takes no RoPE), with an optional sliding ``window``.
    Returns (h, (k, v)) with the freshly computed (suffix) k/v as (b, s,
    kv_dim) each.

    ``prefix_kv`` = (k, v) each (b, P, kv_dim): a reused prefix KV, roped
    at its absolute positions and right-padded to the bucket P, of which
    the first ``prefix_len`` (an int or a 0-d int32 tensor on the device)
    rows are real. ``rot`` is ``rope_tables`` at
    ``positions`` when the caller has them."""
    x = rmsnorm(h, p["norm"], cfg.norm_eps)
    q, k, v = _attn_proj_qkv(p, x, cfg)
    q = _split_heads(q, cfg.num_heads)
    k = _split_heads(k, cfg.num_kv_heads)
    if use_rope:
        if rot is None:
            rot = rope_tables(positions, cfg.hd, cfg.rope_theta, 4)
        q, k = apply_rope(q, rot), apply_rope(k, rot)
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
    o = attention_seq(q, k_all, v_all, cfg.num_kv_heads, causal=causal,
                      window=window, q_offset=q_off, prefix_pad=p_pad,
                      q_valid=q_valid)
    h = h + _mm(_merge_heads(o), p["wo"])
    return h, (_merge_heads(k), v)


def cross_attn_seq(p: Tree, h: torch.Tensor, enc_out: torch.Tensor,
                   cfg: ModelConfig):
    """Decoder cross-attention over the encoder output (b, enc_seq, d),
    non-causal through the flash-prefill kernel. Returns (h, (xk, xv)),
    the cross KV as (b, enc_seq, kv_dim) each."""
    x = rmsnorm(h, p["norm_x"], cfg.norm_eps)
    q = _split_heads(_mm(x, p["wqx"]), cfg.num_heads)
    k = _split_heads(_mm(enc_out, p["wkx"]), cfg.num_kv_heads)
    v = _split_heads(_mm(enc_out, p["wvx"]), cfg.num_kv_heads)
    o = attention_seq(q, k, v, cfg.num_kv_heads, causal=False)
    h = h + _mm(_merge_heads(o), p["wox"])
    return h, (_merge_heads(k), _merge_heads(v))


# ---------------------------------------------------------------- mlp / moe

def mlp(p: Tree, x: torch.Tensor) -> torch.Tensor:
    gate, up = _mm_shared(x, p["w_gate"], p["w_up"])
    return _mm(F.silu(gate) * up, p["w_down"])


# longest token run one dispatch sees; longer runs go in window-aligned
# chunks (a module attribute, so tests can make it small)
MOE_TOKEN_CHUNK = 32768


def moe_ffn(p: Tree, x: torch.Tensor, cfg: ModelConfig, rows: int = 1,
            valid: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE over x (T, d), chunked over tokens. Returns (y (T, d),
    aux loss scalar).

    ``rows`` > 1 marks x as ``rows`` independent batch rows of T // rows
    tokens: capacity is counted per row, so a request's output never
    depends on what it is batched with. ``valid`` (rows,) counts each
    row's real (un-padded) leading tokens: pads take no capacity and get
    zero expert output. Runs longer than MOE_TOKEN_CHUNK go row by row,
    then in chunks aligned to the capacity window (padded up to whole
    chunks when no aligned divisor of T exists), as the JAX scan does."""
    T, d = x.shape
    if T > MOE_TOKEN_CHUNK:
        if rows > 1:
            x3 = x.reshape(rows, T // rows, d)
            valid_r = torch.full((rows,), T // rows, dtype=torch.int32,
                                 device=x.device) if valid is None \
                else valid.to(torch.int32).reshape(rows)
            ys, aux = [], torch.zeros((), device=x.device)
            for r in range(rows):
                yr, a = moe_ffn(p, x3[r], cfg, valid=valid_r[r:r + 1])
                ys.append(yr)
                aux = aux + a
            return torch.stack(ys).reshape(T, d), aux / rows
        W = cfg.moe.capacity_window if cfg.moe.dispatch == "capacity" else 1
        assert W <= MOE_TOKEN_CHUNK, (W, MOE_TOKEN_CHUNK)
        divs = [c for c in range(1, MOE_TOKEN_CHUNK + 1)
                if T % c == 0 and c % W == 0]
        if divs:
            chunk, T_pad = max(divs), T
        else:
            chunk = MOE_TOKEN_CHUNK - MOE_TOKEN_CHUNK % W
            T_pad = -(-T // chunk) * chunk
        nc = T_pad // chunk
        xp = x if T_pad == T else F.pad(x, (0, 0, 0, T_pad - T))
        v = torch.full((1,), T, dtype=torch.int32, device=x.device) \
            if valid is None else valid.to(torch.int32).reshape(1)
        v_chunks = (v - torch.arange(nc, device=x.device) * chunk).clamp(
            0, chunk).to(torch.int32)
        ys, aux = [], torch.zeros((), device=x.device)
        for c in range(nc):
            yc, a = _moe_dispatch(p, xp[c * chunk:(c + 1) * chunk], cfg,
                                  valid=v_chunks[c:c + 1])
            ys.append(yc)
            aux = aux + a
        return torch.cat(ys)[:T], aux / nc
    return _moe_dispatch(p, x, cfg, rows, valid)


def _moe_dispatch(p: Tree, x: torch.Tensor, cfg: ModelConfig, rows: int = 1,
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.moe.dispatch == "sorted":
        # dropless dispatch is per token: pad rows route like any token
        # and the caller slices their outputs off
        return _moe_dispatch_sorted(p, x, cfg)
    return _moe_dispatch_capacity(p, x, cfg, rows, valid)


def _top_k(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """lax.top_k: the k largest, the lower index first on ties (a
    stable descending sort; torch.topk promises no order on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p: Tree, x: torch.Tensor, cfg: ModelConfig):
    """(probs (T, E), normalised gates (T, K), expert ids (T, K))."""
    logits = _mm(x, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, cfg.moe.top_k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, idx


def _moe_router(p: Tree, x: torch.Tensor, cfg: ModelConfig):
    """(gates (T, K), expert ids (T, K), Switch-style aux loss)."""
    m = cfg.moe
    probs, gates, idx = _route(p, x, cfg)
    onehot = F.one_hot(idx.reshape(-1), m.num_experts)
    frac = onehot.float().mean(0)
    aux = m.num_experts * (frac * probs.mean(0)).sum() * m.router_aux_coef
    return gates, idx, aux


def _group_offsets(flat_e: torch.Tensor, E: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, offsets) of the T*K assignments ``flat_e``: the stable
    argsort by expert (``jnp.argsort``) and the (E+1,) int32 exclusive
    cumsum of the group sizes (``jnp.bincount``'s), on the device: the
    sorted ids searched for every expert id, so no size is read on the
    host (``torch.bincount`` reads the input's maximum there)."""
    order = torch.argsort(flat_e, stable=True)
    ids = torch.arange(E + 1, dtype=flat_e.dtype, device=flat_e.device)
    offsets = torch.searchsorted(flat_e[order], ids, out_int32=True)
    return order, offsets


def _moe_dispatch_sorted(p: Tree, x: torch.Tensor, cfg: ModelConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless dispatch: the T*K assignments sorted by expert (stable),
    each expert's contiguous segment through ``kernels.ops.grouped_mm``
    (lax.ragged_dot's counterpart) with the group offsets on the device,
    so the step reads nothing on the host and can be captured."""
    m = cfg.moe
    T, d = x.shape
    K = m.top_k
    gates, idx, aux = _moe_router(p, x, cfg)
    flat_e = idx.reshape(-1)                              # token-major
    order, offsets = _group_offsets(flat_e, m.num_experts)
    # repeat_interleave(x, K)[order]: assignment j is token j // K
    xs = x.index_select(0, order // K)
    h = F.silu(ops.grouped_mm(xs, p["w_gate"], offsets)) \
        * ops.grouped_mm(xs, p["w_up"], offsets)
    ys = ops.grouped_mm(h, p["w_down"], offsets)
    y_kt = torch.zeros((T * K, d), dtype=ys.dtype, device=x.device)
    y_kt[order] = ys
    y = (y_kt * gates.reshape(-1)[:, None].to(ys.dtype)).reshape(
        T, K, d).sum(1)
    if m.num_shared_experts:
        y = y + mlp(p["shared"], x)
    return y, aux


def _capacity_dispatch(x: torch.Tensor, idx: torch.Tensor,
                       cfg: ModelConfig, rows: int = 1,
                       valid: Optional[torch.Tensor] = None):
    """The routing half of the capacity dispatch: where each of the T*K
    assignments (expert ids ``idx`` (T, K)) lands.

    Expert capacity is counted inside fixed windows of
    ``capacity_window`` tokens per row (a row shorter than the window is
    its own window, as in the one-token decode step). The buffer holds
    C = ceil(W*K/E*cf) slots per (window, expert); the keep threshold of
    each window comes from its VALID token count, clamped to C. Within a
    window the assignments are flattened choice-major (all first
    choices, then all second ...), and a cumsum gives each its slot.
    Pads and overflow go to one null slot past the buffer.

    Returns (xe (E, G*C, d) the tokens in their expert slots, slot and
    keep (G*K*W,) in the window-local choice-major order, onehot
    (G, K*W, E) of the valid assignments, vmask (R, s_pad))."""
    m = cfg.moe
    T, d = x.shape
    E, K = m.num_experts, m.top_k
    R = max(1, rows)
    assert T % R == 0, (T, R)
    s = T // R
    W = min(m.capacity_window, s)
    nw = -(-s // W)
    s_pad = nw * W
    G = R * nw                                            # capacity windows
    C = max(1, int(math.ceil(W * K / E * m.capacity_factor)))
    dev = x.device
    if valid is None:
        valid_r = torch.full((R,), s, dtype=torch.int32, device=dev)
    else:
        valid_r = valid.to(torch.int32).reshape(R)
    vmask = torch.arange(s_pad, device=dev)[None, :] < valid_r[:, None]
    flat_e = _padrow(idx, R, s_pad).reshape(G, W, K).transpose(1, 2) \
        .reshape(G, K * W)
    vm_w = vmask.reshape(G, W)
    vflat = vm_w[:, None, :].expand(G, K, W).reshape(G, K * W)
    onehot = F.one_hot(flat_e, E) * vflat[..., None]      # (G, K*W, E)
    pos_in_e = onehot.cumsum(1) - 1
    pos_tok = pos_in_e.gather(2, flat_e[..., None])[..., 0]
    n_valid_w = vm_w.sum(1).float()
    c_thr = torch.ceil(n_valid_w * (K * m.capacity_factor / E)).long()
    # the f32 ceil can land one above C when W*K*cf/E is an exact
    # integer: clamp, or a kept token would alias the next expert's slot
    c_thr = c_thr.clamp_max(C)
    keep = vflat & (pos_tok < c_thr[:, None])
    grp_base = (torch.arange(G, device=dev) * E * C)[:, None]
    slot = torch.where(keep, grp_base + flat_e * C + pos_tok,
                       G * E * C).reshape(-1)
    x_kt = _padrow(x, R, s_pad).reshape(G, W, d).repeat(1, K, 1) \
        .reshape(G * K * W, d)
    buf = torch.zeros((G * E * C + 1, d), dtype=x.dtype, device=dev)
    buf.index_add_(0, slot, x_kt)
    xe = buf[:G * E * C].reshape(G, E, C, d).transpose(0, 1).reshape(
        E, G * C, d)
    return xe, slot, keep.reshape(-1), onehot, vmask


def _padrow(t: torch.Tensor, R: int, s_pad: int) -> torch.Tensor:
    """(R*s, ...) -> (R, s_pad, ...), each row right-padded with zeros."""
    t = t.reshape((R, t.shape[0] // R) + tuple(t.shape[1:]))
    if s_pad != t.shape[1]:
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, s_pad - t.shape[1]))
    return t


def _moe_dispatch_capacity(p: Tree, x: torch.Tensor, cfg: ModelConfig,
                           rows: int = 1,
                           valid: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard-style capacity scatter, window-local and pad-invariant (see
    ``_capacity_dispatch``): route, place the tokens in their slots, run
    each expert over its slots, gather the kept outputs back weighted by
    their gates."""
    m = cfg.moe
    T, d = x.shape
    E, K = m.num_experts, m.top_k
    R = max(1, rows)
    probs, gates, idx = _route(p, x, cfg)
    xe, slot, keep, onehot, vmask = _capacity_dispatch(x, idx, cfg, R, valid)
    G, KW, _ = onehot.shape
    W, s_pad, s = KW // K, vmask.shape[1], T // R
    h = F.silu(_mm(xe, p["w_gate"])) * _mm(xe, p["w_up"])
    ye = _mm(h, p["w_down"])
    ye = ye.reshape(E, G, -1, d).transpose(0, 1).reshape(-1, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))])
    y_kt = ye[slot] * keep[:, None].to(ye.dtype)
    gates_kt = _padrow(gates, R, s_pad).reshape(G, W, K).transpose(1, 2) \
        .reshape(-1)
    y = (y_kt * gates_kt[:, None].to(ye.dtype)).reshape(G, K, W, d).sum(1) \
        .reshape(R, s_pad, d)[:, :s].reshape(T, d)
    if m.num_shared_experts:
        y = y + mlp(p["shared"], x)     # per token: pad rows sliced upstream

    # load-balance aux loss over VALID assignments, at per-row scale
    counts = onehot.float().sum((0, 1)) / R
    vtok = vmask[:, :s].reshape(T).float()
    mean_p = (probs * vtok[:, None]).sum(0) / vtok.sum().clamp_min(1.0)
    aux = E * (counts * mean_p).sum() * m.router_aux_coef
    return y, aux


# ---------------------------------------------------------------- mamba2 ssd

def _causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                   init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. x: (b, s, c); w: (c, k); init: (b, c, k-1)
    holds the k-1 inputs before x (zeros when None)."""
    b, s, c = x.shape
    k = w.shape[1]
    if init is None:
        pad = x.new_zeros((b, k - 1, c))
    else:
        pad = init.transpose(1, 2).to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + s, :] * w[:, i]
    return out


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None,
             return_chunk_states: bool = False):
    """Chunked SSD (Mamba2, n_groups == 1), accumulated in f32.

    x: (b, s, nh, hd); dt: (b, s, nh); A: (nh,); B, C: (b, s, n).
    Returns y (b, s, nh, hd) and the final state (b, nh, n, hd); with
    ``return_chunk_states`` also the state after every chunk (nc, b,
    nh, n, hd). The sequence is right-padded to whole chunks with
    dt == 0 rows, which neither decay nor write the state, so the chunk
    partition depends on the config's chunk only."""
    b, s, nh, hd = x.shape
    n = B.shape[-1]
    nc = -(-s // chunk)
    s_pad = nc * chunk

    def resh(t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if s_pad != s:
            t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, s_pad - s))
        return t.reshape((b, nc, chunk) + tuple(t.shape[2:]))

    xs, dts, Bs, Cs = resh(x), resh(dt), resh(B), resh(C)
    S = x.new_zeros((b, nh, n, hd), dtype=torch.float32) \
        if init_state is None else init_state.float()
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    A = A.float()
    ys, states = [], []
    for c in range(nc):
        xc, dtc, Bc, Cc = xs[:, c], dts[:, c], Bs[:, c], Cs[:, c]
        cs = torch.cumsum(dtc * A, dim=1)                       # (b,Q,nh)
        # intra-chunk
        seg = torch.exp(cs[:, :, None, :] - cs[:, None, :, :])  # (b,Q,K,nh)
        seg = torch.where(causal[None, :, :, None], seg, 0.0)
        cb = torch.einsum("bqn,bkn->bqk", Cc, Bc)
        att = cb[..., None] * seg * dtc[:, None, :, :]
        y = torch.einsum("bqkh,bkhp->bqhp", att, xc)
        # inter-chunk: the carried state's contribution
        y = y + torch.einsum("bqn,bhnp->bqhp", Cc, S) \
            * torch.exp(cs)[..., None]
        # state update
        total = cs[:, -1, :]                                    # (b,nh)
        w_k = torch.exp(total[:, None, :] - cs) * dtc           # (b,Q,nh)
        dS = torch.einsum("bkn,bkhp->bhnp", Bc, xc * w_k[..., None])
        S = S * torch.exp(total)[:, :, None, None] + dS
        ys.append(y.to(x.dtype))
        if return_chunk_states:
            states.append(S)
    y = torch.stack(ys, dim=1).reshape(b, s_pad, nh, hd)[:, :s]
    if return_chunk_states:
        return y, S, torch.stack(states)
    return y, S


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, state: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD recurrence. x: (b, nh, hd); dt: (b, nh); B, C:
    (b, n); state: (b, nh, n, hd) f32."""
    da = torch.exp(dt * A)                                       # (b,nh)
    dS = B.float()[:, None, :, None] \
        * (dt[:, :, None] * x.float())[:, :, None, :]
    state = state * da[:, :, None, None] + dS
    y = torch.einsum("bn,bhnp->bhp", C.float(), state)
    return y.to(x.dtype), state


def _ssm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    """(d_inner, SSD heads)."""
    d_in = cfg.ssm_cfg.expand * cfg.d_model
    return d_in, d_in // cfg.ssm_cfg.head_dim


def mamba_sublayer_seq(p: Tree, h: torch.Tensor, cfg: ModelConfig, *,
                       valid_len: Optional[torch.Tensor] = None,
                       init: Optional[Tree] = None,
                       snap_stride: int = 0) -> Tuple[torch.Tensor, Tree]:
    """Mamba2 sublayer over a sequence. Returns (h, state) with state
    {"conv_x", "conv_b", "conv_c" (b, c, k-1), "state" (b, nh, n, hd)}:
    the decode hand-off at each row's end.

    ``valid_len`` (b,) counts each row's real tokens: pads get dt = 0
    (no decay, no write) and the conv tails are taken at the valid
    boundary. ``init`` restores a boundary snapshot (same keys): conv
    windows seeded with the prefix's last k-1 inputs, the scan started
    from its state. ``snap_stride`` > 0 (a multiple of the SSD chunk)
    also emits the snapshot at every stride boundary of this run:
    "snap_state" (nb, b, nh, n, hd) from the per-chunk carries and
    "snap_conv_{x,b,c}" (nb, b, c, k-1)."""
    s_cfg = cfg.ssm_cfg
    _, nh = _ssm_dims(cfg)
    s = h.shape[1]
    x = rmsnorm(h, p["norm"], cfg.norm_eps)
    z = _mm(x, p["w_z"])
    xin = _mm(x, p["w_x"])
    bin_ = _mm(x, p["w_b"])
    cin = _mm(x, p["w_c"])
    dt = _mm(x, p["w_dt"]) + p["dt_bias"]
    ini = init or {}
    xc = F.silu(_causal_conv1d(xin, p["conv_x"], ini.get("conv_x")))
    bc = F.silu(_causal_conv1d(bin_, p["conv_b"], ini.get("conv_b")))
    cc = F.silu(_causal_conv1d(cin, p["conv_c"], ini.get("conv_c")))
    dt = F.softplus(dt.float())
    if valid_len is not None:
        vmask = torch.arange(s, device=h.device)[None, :] \
            < valid_len[:, None]
        dt = torch.where(vmask[..., None], dt, 0.0)
    A = -torch.exp(p["a_log"].float())
    x4 = _split_heads(xc, nh)
    if snap_stride:
        assert snap_stride % s_cfg.chunk == 0, (snap_stride, s_cfg.chunk)
    y4, state, *chunk_states = ssd_scan(
        x4, dt, A, bc, cc, s_cfg.chunk, init_state=ini.get("state"),
        return_chunk_states=bool(snap_stride))
    y4 = y4 + x4 * p["d_skip"][:, None].to(x4.dtype)
    y = rmsnorm(_merge_heads(y4) * F.silu(z), p["norm_g"], cfg.norm_eps)
    out = h + _mm(y, p["w_out"])
    k = s_cfg.conv_kernel

    def tail(t: torch.Tensor, key: str) -> torch.Tensor:  # -> (b, c, k-1)
        if init is not None:
            # the window may span the restore boundary (suffix shorter
            # than k-1): gather from the snapshot tail ++ this run
            ext = torch.cat([ini[key].transpose(1, 2).to(t.dtype), t], 1)
            vl = valid_len[:, None].long() if valid_len is not None \
                else torch.full((t.shape[0], 1), s, device=t.device)
            idx = vl + torch.arange(k - 1, device=t.device)[None]
            g = ext.gather(1, idx[..., None].expand(-1, -1, t.shape[2]))
            return g.transpose(1, 2)
        if valid_len is None:
            return t[:, -(k - 1):, :].transpose(1, 2)
        # the last k-1 VALID inputs (zeros left of the sequence start)
        idx = valid_len[:, None].long() - (k - 1) \
            + torch.arange(k - 1, device=t.device)[None]
        g = t.gather(1, idx.clamp(0, s - 1)[..., None].expand(
            -1, -1, t.shape[2]))
        g = torch.where((idx >= 0)[..., None], g, 0.0)
        return g.transpose(1, 2)

    tails = {"conv_x": tail(xin, "conv_x"), "conv_b": tail(bin_, "conv_b"),
             "conv_c": tail(cin, "conv_c"), "state": state}
    if snap_stride:
        # boundary j sits after j*stride tokens of this run: the state
        # is the carry after chunk j*stride/chunk - 1, the conv tail the
        # k-1 inputs before it. Boundaries past a row's valid length hold
        # pad garbage; the engine stores only those <= the prompt length
        bidx = [(j + 1) * snap_stride for j in range(s // snap_stride)]
        (cst,) = chunk_states
        b = h.shape[0]
        tails["snap_state"] = torch.stack(
            [cst[t // s_cfg.chunk - 1] for t in bidx]) if bidx \
            else state.new_zeros((0,) + tuple(state.shape))
        for key, t in (("snap_conv_x", xin), ("snap_conv_b", bin_),
                       ("snap_conv_c", cin)):
            tails[key] = torch.stack(
                [t[:, e - (k - 1):e].transpose(1, 2) for e in bidx]) \
                if bidx else t.new_zeros((0, b, t.shape[-1], k - 1))
    return out, tails


def mamba_sublayer_step(p: Tree, h: torch.Tensor, cache: Tree,
                        cfg: ModelConfig) -> Tuple[torch.Tensor, Tree]:
    """One-token Mamba2 step. h: (b, d); cache leaves (b, ...) unstacked.
    Returns (h, new cache)."""
    s_cfg = cfg.ssm_cfg
    d_in, nh = _ssm_dims(cfg)
    x = rmsnorm(h, p["norm"], cfg.norm_eps)
    z = _mm(x, p["w_z"])
    xin = _mm(x, p["w_x"])
    bin_ = _mm(x, p["w_b"])
    cin = _mm(x, p["w_c"])
    dt = _mm(x, p["w_dt"]) + p["dt_bias"]

    def conv_step(state, new, w):
        win = torch.cat([state.to(new.dtype), new[:, :, None]], dim=2)
        return (win * w[None]).sum(2), win[:, :, 1:]

    xc, cx = conv_step(cache["conv_x"], xin, p["conv_x"])
    bc, cb = conv_step(cache["conv_b"], bin_, p["conv_b"])
    cc, ccs = conv_step(cache["conv_c"], cin, p["conv_c"])
    xc, bc, cc = F.silu(xc), F.silu(bc), F.silu(cc)
    dt = F.softplus(dt.float())
    A = -torch.exp(p["a_log"].float())
    x3 = xc.reshape(-1, nh, s_cfg.head_dim)
    y3, state = ssd_step(x3, dt, A, bc, cc, cache["state"])
    y3 = y3 + x3 * p["d_skip"][:, None].to(x3.dtype)
    y = rmsnorm(y3.reshape(-1, d_in) * F.silu(z), p["norm_g"], cfg.norm_eps)
    out = h + _mm(y, p["w_out"])
    return out, {"conv_x": cx, "conv_b": cb, "conv_c": ccs, "state": state}


# ---------------------------------------------------------------- blocks

def _ffn_sublayer(p: Tree, h: torch.Tensor, cfg: ModelConfig, is_moe: bool,
                  valid_len: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Feed-forward half of a sublayer: (h, aux loss). h is (b, s, d);
    MoE counts capacity per batch row, with ``valid_len`` (b,) routing
    right-pad tokens to the null slot."""
    aux = 0.0
    if is_moe:
        x = rmsnorm(h, p["norm2"], cfg.norm_eps)
        shp = x.shape
        y, aux = moe_ffn(p["moe"], x.reshape(-1, shp[-1]), cfg,
                         rows=shp[0] if len(shp) == 3 else 1,
                         valid=valid_len if len(shp) == 3 else None)
        h = h + y.reshape(shp)
    elif cfg.d_ff > 0:
        h = h + mlp(p["mlp"], rmsnorm(h, p["norm2"], cfg.norm_eps))
    return h, aux


def _block_params(params: Tree, blk: int) -> Tree:
    """Views of one repeating block's params (no copies)."""
    return tree_map(lambda x: x[blk], params["blocks"])


def block_seq(cfg: ModelConfig, blk_params: Tree, h: torch.Tensor, *,
              positions: torch.Tensor, prefix: Optional[Tree] = None,
              prefix_len=None, valid_len: Optional[torch.Tensor] = None,
              rot: Optional[Rot] = None, ssm_state: Optional[Tree] = None,
              snap_stride: int = 0, enc_out: Optional[torch.Tensor] = None,
              window: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, Tree]:
    """Apply one repeating block (period sublayers), its attention
    sublayers under the sliding ``window`` when one is given. Returns (h,
    aux, cache): attention sublayers cache "k", "v" (b, s, kv_dim), Mamba
    sublayers their hand-off state (and snapshots with ``snap_stride``);
    with ``enc_out`` every sublayer cross-attends after its mixer and
    caches "xk", "xv" (b, enc_seq, kv_dim).
    ``prefix`` maps "sub{i}" -> {"k", "v"} (b, P, kv_dim) reused prefix
    KV; ``ssm_state`` maps "sub{i}" -> a boundary snapshot restoring a
    Mamba sublayer; ``valid_len`` (b,) marks the real tokens of a
    right-padded bucket (masked queries, zero-dt recurrence, null-slot
    MoE capacity)."""
    kinds = cfg.layer_kinds()
    moe_mask = cfg.moe_layer_mask()
    aux_total = 0.0
    cache_out: Tree = {}
    for i in range(block_period(cfg)):
        p = blk_params[f"sub{i}"]
        c: Tree = {}
        if kinds[i] == ATTN:
            pfx = None
            if prefix is not None and prefix.get(f"sub{i}"):
                pfx = (prefix[f"sub{i}"]["k"], prefix[f"sub{i}"]["v"])
            h, (c["k"], c["v"]) = attn_sublayer_seq(
                p, h, cfg, positions=positions, prefix_kv=pfx,
                prefix_len=prefix_len, q_valid=valid_len, rot=rot,
                window=window)
        else:
            ini = (ssm_state or {}).get(f"sub{i}") or None
            h, c = mamba_sublayer_seq(p, h, cfg, valid_len=valid_len,
                                      init=ini, snap_stride=snap_stride)
        if enc_out is not None:
            h, (c["xk"], c["xv"]) = cross_attn_seq(p, h, enc_out, cfg)
        h, aux = _ffn_sublayer(p, h, cfg, moe_mask[i], valid_len)
        aux_total = aux_total + aux
        cache_out[f"sub{i}"] = c
    return h, aux_total, cache_out


def block_decode(cfg: ModelConfig, blk_params: Tree, h: torch.Tensor,
                 layers_cache: Tree, blk_idx: int, pos, *,
                 window: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, Tree]:
    """One-token step through one repeating block over a dense decode
    cache. h: (b, d); ``layers_cache`` the full stacked cache ("sub{i}" ->
    leaves on a leading num_blocks axis: attention "k", "v" (nblk, b, S,
    kv_dim), Mamba conv tails and SSD state, an encoder-decoder's "xk",
    "xv"), written IN PLACE at ``blk_idx``: the token's k/v row at slot
    ``pos`` (every row of the batch sits at the same position), the Mamba
    state. Attention reads the cache before the write and takes the new
    token as ``k_new``/``v_new``, as JAX does. With ``window`` the
    attention cache is a ring of length S and the row goes to slot
    ``pos % S``. ``pos`` is a 0-d int32 tensor on the device (an int is
    taken too); the slot is computed and written on the device (JAX's
    dynamic_update_slice, whose start clamps to S - 1), so the step reads
    nothing on the host. Returns (h, aux, cache)."""
    kinds = cfg.layer_kinds()
    moe_mask = cfg.moe_layer_mask()
    pos_t = torch.as_tensor(pos, dtype=torch.int32, device=h.device)
    rot = None
    aux_total = torch.zeros((), device=h.device)
    for i in range(block_period(cfg)):
        p = blk_params[f"sub{i}"]
        c = layers_cache[f"sub{i}"]
        if kinds[i] == ATTN:
            x = rmsnorm(h, p["norm"], cfg.norm_eps)
            q, k, v = _attn_proj_qkv(p, x, cfg)
            if rot is None:
                rot = rope_tables(pos_t, cfg.hd, cfg.rope_theta, 3)
            q4 = apply_rope(_split_heads(q, cfg.num_heads), rot)
            k_flat = _merge_heads(apply_rope(_split_heads(k, cfg.num_kv_heads),
                                             rot))
            o = attention_decode(q4, c["k"][blk_idx], c["v"][blk_idx],
                                 cfg.num_kv_heads, pos_t, window=window,
                                 k_new=k_flat, v_new=v)
            S = c["k"].shape[2]
            slot = (pos_t % S if window is not None
                    else pos_t.clamp(max=S - 1)).reshape(1).long()
            c["k"][blk_idx].index_copy_(1, slot,
                                        k_flat.to(c["k"].dtype)[:, None])
            c["v"][blk_idx].index_copy_(1, slot, v.to(c["v"].dtype)[:, None])
            h = h + _mm(_merge_heads(o), p["wo"])
        else:
            h, mc = mamba_sublayer_step(
                p, h, {k2: c[k2][blk_idx] for k2 in SSM_LEAVES}, cfg)
            for k2 in SSM_LEAVES:
                c[k2][blk_idx].copy_(mc[k2])
        if cfg.is_encoder_decoder:
            x = rmsnorm(h, p["norm_x"], cfg.norm_eps)
            q4 = _split_heads(_mm(x, p["wqx"]), cfg.num_heads)
            xk = c["xk"][blk_idx]
            o = attention_decode(q4, xk, c["xv"][blk_idx], cfg.num_kv_heads,
                                 xk.shape[1])
            h = h + _mm(_merge_heads(o), p["wox"])
        h2, aux = _ffn_sublayer(p, h[:, None, :], cfg, moe_mask[i])
        h = h2[:, 0]
        aux_total = aux_total + aux
    return h, aux_total, layers_cache


# ---------------------------------------------------------------- encoder

def encoder_forward(cfg: ModelConfig, params: Tree,
                    frames: torch.Tensor) -> torch.Tensor:
    """Whisper-style encoder over stub frame embeddings (b, enc_seq, d):
    learned positions, then non-causal self-attention without RoPE and an
    MLP per layer, then the final norm."""
    enc = params["encoder"]
    h = frames + enc["pos_embed"].to(frames.dtype)
    for blk in range(cfg.encoder_layers):
        bp = tree_map(lambda x: x[blk], enc["blocks"]["sub0"])
        h, _ = attn_sublayer_seq(bp, h, cfg, positions=None, causal=False,
                                 use_rope=False)
        h, _ = _ffn_sublayer(bp, h, cfg, False)
    return rmsnorm(h, enc["final_norm"], cfg.norm_eps)


# ---------------------------------------------------------------- full fwd

def _embed_inputs(cfg: ModelConfig, params: Tree, batch: Tree
                  ) -> torch.Tensor:
    if "embeds" in batch:          # VLM stub frontend: embeddings come in
        return batch["embeds"]
    emb = params["embed"]
    return emb[batch["tokens"].long()].to(emb.dtype)


def forward_seq(cfg: ModelConfig, params: Tree, batch: Tree, *,
                collect_cache: bool = True, remat: bool = False,
                prefix: Optional[Tree] = None,
                prefix_len: Union[int, torch.Tensor] = 0,
                valid_len: Optional[torch.Tensor] = None,
                ssm_init: Optional[Tree] = None, snap_stride: int = 0,
                window: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Tree]]:
    """Shared train/prefill path (decoder self-attention under the
    sliding ``window`` when one is given). Returns (hidden (b, s, d), aux,
    cache) with cache "sub{i}" -> leaves stacked on a leading num_blocks axis
    (attention: "k", "v" (num_blocks, b, s, kv_dim)), or None without
    ``collect_cache``. ``remat`` recomputes each repeating block in the
    backward instead of keeping its activations (JAX's
    ``jax.checkpoint(body)``): the backward then holds one block's
    activations at a time, plus each block's input.

    With ``prefix`` ("sub{i}" -> {"k", "v"} of (num_blocks, b, P,
    kv_dim), P the prefix bucket) the batch holds only the uncached
    suffix tokens, positioned from ``prefix_len`` (<= P; padded prefix
    rows are masked out of attention), an int or, as JAX traces it, a
    0-d int32 tensor on the device that nothing reads on the host.
    ``ssm_init`` ("sub{i}" -> a snapshot stacked on num_blocks) restores
    every Mamba sublayer at the reuse boundary; ``snap_stride`` > 0
    emits snapshots into the cache (see mamba_sublayer_seq). The batch
    holds "tokens" or, for the VLM stub frontend, "embeds" (b, s, d); an
    encoder-decoder also takes "frames" (b, enc_seq, d), which the
    encoder runs over first."""
    h = _embed_inputs(cfg, params, batch)
    s = h.shape[1]
    positions = prefix_len + torch.arange(s, device=h.device)
    rot = rope_tables(positions, cfg.hd, cfg.rope_theta, 4) \
        if not cfg.attn_free else None
    enc_out = encoder_forward(cfg, params, batch["frames"]) \
        if cfg.is_encoder_decoder else None
    aux = 0.0
    per_block = []
    # one unbind per stacked leaf, not an index per block: the backward
    # of unbind stacks the blocks' gradients once, where indexing would
    # add a zero-filled full-size gradient per block
    blocks = tree_map(lambda x: x.unbind(0), params["blocks"])
    for blk in range(num_blocks(cfg)):
        pfx = ssm = None
        if prefix is not None:
            pfx = {sub: ({"k": c["k"][blk], "v": c["v"][blk]} if c else {})
                   for sub, c in prefix.items()}
        if ssm_init is not None:
            ssm = {sub: {k: v[blk] for k, v in c.items()}
                   for sub, c in ssm_init.items()}
        extra = prefix is not None or ssm_init is not None
        run = functools.partial(
            block_seq, cfg, tree_map(lambda t: t[blk], blocks),
            positions=positions, prefix=pfx,
            prefix_len=prefix_len if extra else None, valid_len=valid_len,
            rot=rot, ssm_state=ssm, snap_stride=snap_stride, enc_out=enc_out,
            window=window)
        h, a, cache = checkpoint(run, h, use_reentrant=False) if remat \
            else run(h)
        aux = aux + a
        if collect_cache:
            per_block.append(cache)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    if not collect_cache:
        return h, aux, None
    caches = {sub: {k: torch.stack([c[sub][k] for c in per_block])
                    for k in per_block[0][sub]}
              for sub in per_block[0]}
    return h, aux, caches


def lm_logits(cfg: ModelConfig, params: Tree, h: torch.Tensor
              ) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return _mm(h, w.to(h.dtype))


LOSS_CHUNK = 512   # sequence rows per cross-entropy chunk


def chunked_loss(cfg: ModelConfig, params: Tree, h: torch.Tensor,
                 labels: torch.Tensor, chunk: int = LOSS_CHUNK
                 ) -> torch.Tensor:
    """Mean cross-entropy over sequence chunks, each recomputed in the
    backward: the (b, s, vocab) logits are never held at once (one
    chunk's are)."""
    b, s, _ = h.shape
    if s % chunk != 0 or s <= chunk:
        return _xent(lm_logits(cfg, params, h), labels)

    def body(hh: torch.Tensor, ll: torch.Tensor) -> torch.Tensor:
        return _xent(lm_logits(cfg, params, hh), ll)
    tot = torch.zeros((), device=h.device)
    for c in range(s // chunk):
        rows = slice(c * chunk, (c + 1) * chunk)
        tot = tot + checkpoint(body, h[:, rows], labels[:, rows],
                               use_reentrant=False) * (chunk / s)
    return tot


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def forward_train(cfg: ModelConfig, params: Tree, batch: Tree,
                  remat: bool = True
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss + MoE aux loss, {"lm_loss", "aux_loss"}) of a batch of
    "tokens" and next-token "labels" (b, s). Differentiable: attention's
    gradient is the hand-written backward kernel on the card."""
    h, aux, _ = forward_seq(cfg, params, batch, collect_cache=False,
                            remat=remat)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=h.device)
    loss = chunked_loss(cfg, params, h, batch["labels"])
    return loss + aux, {"lm_loss": loss, "aux_loss": aux}


def forward_prefill(cfg: ModelConfig, params: Tree, batch: Tree,
                    window: Optional[int] = None,
                    last_index: Optional[torch.Tensor] = None,
                    prefix: Optional[Tree] = None,
                    prefix_len: Union[int, torch.Tensor] = 0,
                    ssm_init: Optional[Tree] = None, snap_stride: int = 0
                    ) -> Tuple[torch.Tensor, Tree]:
    """Returns (first generated token (b,) int32, cache).

    ``window`` W runs self-attention under the sliding window; a prompt of
    exactly W tokens then leaves a cache that is already a valid ring for
    ``forward_decode(window=W)``.

    ``last_index`` (b,) selects each row's last prompt position in a
    right-padded batch AND marks the rows past it as padding for every
    sublayer (pad-invariance). With ``prefix``/``prefix_len``/
    ``ssm_init`` (see forward_seq) the returned cache covers only the
    suffix tokens; the caller stitches prefix ++ suffix."""
    valid_len = None if last_index is None \
        else (last_index.to(torch.int32) + 1).contiguous()
    h, _, caches = forward_seq(cfg, params, batch, prefix=prefix,
                               prefix_len=prefix_len, valid_len=valid_len,
                               ssm_init=ssm_init, snap_stride=snap_stride,
                               window=window)
    if last_index is None:
        h_last = h[:, -1, :]
    else:
        h_last = h[torch.arange(h.shape[0], device=h.device),
                   last_index.long()]
    first = torch.argmax(lm_logits(cfg, params, h_last), dim=-1).to(
        torch.int32)
    # "pos" a 0-d int32 on the device, as JAX's jnp.asarray (a fill, not a
    # copy from the host, plus the prefix length, an int or on the device)
    pos = torch.full((), h.shape[1], dtype=torch.int32,
                     device=h.device) + prefix_len
    return first, {"layers": caches, "pos": pos}


# ---------------------------------------------------------------- decode

def _decode_step_core(cfg: ModelConfig, params: Tree, storage: torch.Tensor,
                      block_tables: torch.Tensor, tokens: torch.Tensor,
                      pos: torch.Tensor, active: torch.Tensor,
                      slot_layers: Tree, *, block_size: int,
                      caps: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, Tree]:
    """One decode iteration's layer loop: (argmax token, storage,
    slot_layers), the pool storage and the slot state updated in place.

    ``storage`` is (L, NB + 1, BS, W): the pool's NB blocks and the drop
    block NB after them (``PagedKVPool.full_storage``). Every slot's new
    KV row is written at (block_tables[slot, pos // BS], pos % BS) of
    every attention layer, write-then-attend, so no shape depends on
    which slots are active. The rows that must not land go to the drop
    block, as JAX sends them past the pool with ``mode="drop"`` (on the
    card an out-of-range write is a device assert): inactive slots, -1
    table entries and, with ``caps`` (n_slots,) int32, positions past a
    slot's owned capacity (a speculative micro-step at ``pos + j``, whose
    clamped table lookup would land on the slot's last real block). No
    table names the drop block, so nothing reads it. Mamba
    sublayers step every slot's conv tails and SSD state (inactive slots
    are reseeded at admission);
    an encoder-decoder's sublayers cross-attend over each slot's "xk",
    "xv" (seeded at admission); MoE runs with one capacity window per
    slot (rows = slots), so inactive slots never take an active slot's
    capacity."""
    bs = block_size
    period = block_period(cfg)
    kinds = cfg.layer_kinds()
    moe_mask = cfg.moe_layer_mask()
    attn_subs = [i for i in range(period) if kinds[i] == ATTN]
    attn_rank = {s: r for r, s in enumerate(attn_subs)}
    pool_dtype = storage.dtype
    pos = pos.to(torch.int32)
    lens = (pos + 1).contiguous()                 # incl. the current token
    col = (pos // bs).clamp(0, block_tables.shape[1] - 1).long()
    tok_blk = block_tables.gather(1, col[:, None])[:, 0]
    ok = active & (tok_blk >= 0)
    if caps is not None:
        ok = ok & (pos < caps.to(torch.int32))
    tok_blk = torch.where(ok, tok_blk, storage.shape[1] - 1).long()
    tok_off = (pos % bs).long()
    rot = rope_tables(pos, cfg.hd, cfg.rope_theta, 3) if attn_subs else None
    h = params["embed"][tokens.long()].float()
    for blk in range(num_blocks(cfg)):
        bp = _block_params(params, blk)
        for i in range(period):
            p = bp[f"sub{i}"]
            if kinds[i] == ATTN:
                li = blk * len(attn_subs) + attn_rank[i]
                x = rmsnorm(h, p["norm"], cfg.norm_eps)
                q, k, v = _attn_proj_qkv(p, x, cfg)
                q4 = apply_rope(_split_heads(q, cfg.num_heads), rot)
                k4 = apply_rope(_split_heads(k, cfg.num_kv_heads), rot)
                kv_tok = torch.cat([_merge_heads(k4), v], -1).to(pool_dtype)
                page = storage[li]
                page.index_put_((tok_blk, tok_off), kv_tok)
                o = ops.paged_attention(q4.to(pool_dtype), page,
                                        block_tables, lens)
                h = h + _mm(_merge_heads(o).to(h.dtype), p["wo"])
            else:
                c = slot_layers[f"sub{i}"]
                h, mc = mamba_sublayer_step(
                    p, h, {k2: c[k2][blk] for k2 in SSM_LEAVES}, cfg)
                for k2 in SSM_LEAVES:
                    c[k2][blk].copy_(mc[k2])
            if cfg.is_encoder_decoder:
                c = slot_layers[f"sub{i}"]
                x = rmsnorm(h, p["norm_x"], cfg.norm_eps)
                q4 = _split_heads(_mm(x, p["wqx"]), cfg.num_heads)
                o = attention_decode(q4.float(), c["xk"][blk], c["xv"][blk],
                                     cfg.num_kv_heads, cfg.encoder_seq)
                h = h + _mm(_merge_heads(o).to(h.dtype), p["wox"])
            h2, _ = _ffn_sublayer(p, h[:, None, :], cfg, moe_mask[i])
            h = h2[:, 0]
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    nxt = torch.argmax(lm_logits(cfg, params, h), dim=-1).to(torch.int32)
    return nxt, storage, slot_layers


def forward_decode_step(cfg: ModelConfig, params: Tree, storage: torch.Tensor,
                        block_tables: torch.Tensor, tokens: torch.Tensor,
                        pos: torch.Tensor, active: torch.Tensor,
                        slot_layers: Tree, *, block_size: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor, Tree]:
    """ONE fused decode iteration over a fixed slot set: the counterpart
    of ``decode_step_jit``'s program. No shape depends on the active set
    and nothing is read on the host, so the step is captured as one CUDA
    graph per shape key (``serving/step_graph.py``).

    storage:      (attn_layers|1, NB + 1, BS, W) paged pool with its drop
                  block last, updated in place.
    block_tables: (n_slots, T) int32, -1 padded.
    tokens/pos:   (n_slots,) int32 last emitted token / tokens so far.
    active:       (n_slots,) bool slot mask.
    slot_layers:  {"sub{i}": {...}} per-slot Mamba state and cross KV
                  stacked on a leading num_blocks axis
                  (``caches.decode_slot_state``), updated in place.

    Returns (next_token, new_tokens, new_pos, storage, slot_layers);
    next_token is the on-device argmax, the caller's one host transfer."""
    nxt, storage, slot_layers = _decode_step_core(
        cfg, params, storage, block_tables, tokens, pos, active,
        slot_layers, block_size=block_size)
    new_tokens = torch.where(active, nxt, tokens)
    new_pos = pos.to(torch.int32) + active.to(torch.int32)
    return nxt, new_tokens, new_pos, storage, slot_layers


def forward_spec_decode_step(cfg: ModelConfig, dcfg: ModelConfig,
                             params: Tree, d_params: Tree,
                             storage: torch.Tensor, d_storage: torch.Tensor,
                             block_tables: torch.Tensor, tokens: torch.Tensor,
                             pos: torch.Tensor, active: torch.Tensor,
                             caps: torch.Tensor, slot_layers: Tree,
                             d_slot_layers: Tree, *, block_size: int, k: int
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor,
                                        torch.Tensor, Tree, Tree]:
    """ONE speculative decode iteration: the draft proposes ``k`` tokens,
    the target verifies the ``k+1`` new positions, and each slot commits
    its longest accepted prefix. The acceptance count is data (a device
    int lane), never a host decision, so the step makes no sync.

    The extras over ``forward_decode_step``: ``d_storage`` the draft's
    paged KV riding the TARGET's block tables, with its own drop block
    (never rolled back: rows past a slot's commit are masked by ``lens``
    and rewritten before they are attended); ``caps`` (n_slots,) int32
    each slot's owned capacity in tokens, whose guard sends a micro-step's
    rows past it to the drop block; ``d_slot_layers`` the draft's slot
    state. Like the plain step, no shape depends on the active set or on
    the acceptance counts (``spec_decode_step_jit``'s program).

    Both models run k+1 micro-steps over the consumed tokens ``C = [cur,
    d_1 .. d_k]`` (micro-step j consumes C[j] at pos + j) at the full slot
    batch, as the plain step does, keeping each micro-step's slot state;
    acceptance picks, per slot, the state at depth ``n_emit - 1``. The
    target pool rows a slot did not commit are restored from a gather
    taken before the verify sweep, so the pool equals plain greedy
    decode's bit for bit. The pool, the draft pool and both slot states
    are updated in place.

    Returns ``(out, new_tokens, new_pos, storage, d_storage, slot_layers,
    d_slot_layers)``; ``out`` (n_slots, k+2) int32 packs the target's
    greedy tokens G (columns 0..k) and the emission count (column k+1):
    the caller's one host transfer retires ``out[s, :out[s, k+1]]``."""
    bs = block_size
    pos = pos.to(torch.int32)
    caps = caps.to(torch.int32)
    has_attn = any(kd == ATTN for kd in cfg.layer_kinds())

    def snap(tree: Tree) -> Tree:
        return tree_map(lambda x: x.clone(), tree)

    # -- draft: propose k tokens; C[j] is the token micro-step j consumes
    c_toks, d_stack, tok = [], [], tokens
    for j in range(k + 1):
        c_toks.append(tok)
        tok, d_storage, d_slot_layers = _decode_step_core(
            dcfg, d_params, d_storage, block_tables, tok, pos + j, active,
            d_slot_layers, block_size=bs, caps=caps)
        d_stack.append(snap(d_slot_layers))

    # -- the (slot, j) pool rows the verify sweep writes, gathered first
    #    so the uncommitted ones can be restored bit for bit; the rows it
    #    drops (inactive, -1 pads, past caps) read and restore the drop
    #    block
    if has_attn:
        drop = storage.shape[1] - 1
        offs = pos[:, None] + torch.arange(k + 1, dtype=torch.int32,
                                           device=pos.device)[None]
        col = (offs // bs).clamp(0, block_tables.shape[1] - 1).long()
        qblk = block_tables.gather(1, col)                 # (ms, k+1)
        wrote = active[:, None] & (qblk >= 0) & (offs < caps[:, None])
        off = (offs % bs).long()
        old = storage[:, torch.where(wrote, qblk, drop).long(), off]

    # -- target: teacher-force the same k+1 positions; G[j] is its greedy
    #    token after consuming C[0..j]
    g_toks, t_stack = [], []
    for j in range(k + 1):
        nxt, storage, slot_layers = _decode_step_core(
            cfg, params, storage, block_tables, c_toks[j], pos + j, active,
            slot_layers, block_size=bs, caps=caps)
        g_toks.append(nxt)
        t_stack.append(snap(slot_layers))
    c = torch.stack(c_toks)                                # (k+1, ms)
    g = torch.stack(g_toks)

    # -- acceptance: the longest prefix of draft tokens equal to the
    #    target's own greedy stream, plus the correction / bonus token,
    #    clamped to the slot's capacity
    match = (c[1:] == g[:-1]).to(torch.int32)              # (k, ms)
    a = torch.cumprod(match, dim=0).sum(0)
    n_emit = torch.minimum(a + 1, caps - pos).clamp(1, k + 1)

    # -- restore the written target rows past each slot's commit point
    if has_attn:
        keep = torch.arange(k + 1, device=pos.device)[None] \
            < n_emit[:, None]                              # (ms, k+1)
        back = torch.where(wrote & ~keep, qblk, drop).long()
        storage[:, back, off] = old

    # -- per-slot state rollback: the state at depth n_emit - 1
    sel = (n_emit - 1).long()
    for live, stack in ((slot_layers, t_stack), (d_slot_layers, d_stack)):
        picked = select_slot_state(
            {sub: {kk: torch.stack([s[sub][kk] for s in stack])
                   for kk in live[sub]} for sub in live}, sel)
        for sub in live:
            for kk in live[sub]:
                live[sub][kk].copy_(picked[sub][kk])

    last = g.gather(0, sel[None])[0]
    new_tokens = torch.where(active, last, tokens)
    emitted = torch.where(active, n_emit, torch.zeros_like(n_emit))
    new_pos = pos + emitted
    out = torch.cat([g.T, emitted[:, None]], dim=1).to(torch.int32)
    return (out, new_tokens, new_pos, storage, d_storage, slot_layers,
            d_slot_layers)


def forward_decode(cfg: ModelConfig, params: Tree, cache: Tree,
                   tokens: torch.Tensor, *, window: Optional[int] = None
                   ) -> Tuple[torch.Tensor, Tree]:
    """One decode step over a dense cache (``forward_prefill``'s, padded
    along its sequence axis): tokens (b,) int32. Returns (next (b,),
    cache) with the cache's layers written IN PLACE (JAX returns a new
    tree) and "pos" + 1 as a NEW 0-d int32 tensor on the device, as JAX
    returns it: the earlier cache's "pos" is never advanced, so a caller
    that rolls back keeps clones of the layers and the old "pos". Reads
    nothing on the host. With ``window`` the attention caches are rings
    of length W (see block_decode)."""
    pos = torch.as_tensor(cache["pos"], dtype=torch.int32,
                          device=tokens.device)
    emb = params["embed"]
    h = emb[tokens.long()].to(emb.dtype)
    layers = cache["layers"]
    for blk in range(num_blocks(cfg)):
        h, _, layers = block_decode(cfg, _block_params(params, blk), h,
                                    layers, blk, pos, window=window)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    nxt = torch.argmax(lm_logits(cfg, params, h), dim=-1).to(torch.int32)
    return nxt, {"layers": layers, "pos": pos + 1}
