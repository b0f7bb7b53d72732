"""Forward passes of the decoder-only families, in PyTorch: dense, MoE,
Mamba2 (SSM) and hybrid attention/Mamba/MoE stacks.

Counterpart of ``src/repro/models/modeling.py`` for those families:
``forward_prefill`` (the P in P/D: full-sequence forward returning the
first greedy token, the per-layer KV and the Mamba hand-off state and
snapshots) and ``forward_decode_step`` (the D: one fused
continuous-batching iteration over a paged KV pool and per-slot Mamba
state).

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
  operands to JAX's promoted result dtype explicitly;
* the MoE expert products and the SSD scan are plain torch matmuls and
  einsums, as they are plain XLA ops (no Pallas kernel) in JAX; sharding
  hints (``constrain``) have no counterpart.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.caches import SSM_LEAVES
from repro_torch.models.config import ATTN, ModelConfig
from repro_torch.models.params import block_period, num_blocks, tree_map
from repro_torch.scope import check_served, unported

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


# ---------------------------------------------------------------- mlp / moe

def mlp(p: Tree, x: torch.Tensor) -> torch.Tensor:
    return _mm(F.silu(_mm(x, p["w_gate"])) * _mm(x, p["w_up"]), p["w_down"])


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


def _moe_dispatch_sorted(p: Tree, x: torch.Tensor, cfg: ModelConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless dispatch: the T*K assignments sorted by expert (stable),
    one matmul chain per expert over its contiguous segment (where JAX
    used lax.ragged_dot). The segment sizes are read on the host."""
    m = cfg.moe
    T, d = x.shape
    K = m.top_k
    gates, idx, aux = _moe_router(p, x, cfg)
    flat_e = idx.reshape(-1)                              # token-major
    order = torch.argsort(flat_e, stable=True)
    x_kt = x.repeat_interleave(K, dim=0)                  # (T*K, d)
    xs = x_kt[order]
    sizes = torch.bincount(flat_e, minlength=m.num_experts).tolist()
    segs, lo = [], 0
    for e, n in enumerate(sizes):
        xe = xs[lo:lo + n]
        h = F.silu(_mm(xe, p["w_gate"][e])) * _mm(xe, p["w_up"][e])
        segs.append(_mm(h, p["w_down"][e]))
        lo += n
    ys = torch.cat(segs)
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
              snap_stride: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor, Tree]:
    """Apply one repeating block (period sublayers). Returns (h, aux,
    cache): attention sublayers cache "k", "v" (b, s, kv_dim), Mamba
    sublayers their hand-off state (and snapshots with ``snap_stride``).
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
                prefix_len=prefix_len, q_valid=valid_len, rot=rot)
        else:
            ini = (ssm_state or {}).get(f"sub{i}") or None
            h, c = mamba_sublayer_seq(p, h, cfg, valid_len=valid_len,
                                      init=ini, snap_stride=snap_stride)
        h, aux = _ffn_sublayer(p, h, cfg, moe_mask[i], valid_len)
        aux_total = aux_total + aux
        cache_out[f"sub{i}"] = c
    return h, aux_total, cache_out


# ---------------------------------------------------------------- full fwd

def forward_seq(cfg: ModelConfig, params: Tree, batch: Tree, *,
                prefix: Optional[Tree] = None, prefix_len: int = 0,
                valid_len: Optional[torch.Tensor] = None,
                ssm_init: Optional[Tree] = None, snap_stride: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, Tree]:
    """Prefill path. Returns (hidden (b, s, d), aux, cache) with cache
    "sub{i}" -> leaves stacked on a leading num_blocks axis (attention:
    "k", "v" (num_blocks, b, s, kv_dim)).

    With ``prefix`` ("sub{i}" -> {"k", "v"} of (num_blocks, b, P,
    kv_dim), P the prefix bucket) the batch holds only the uncached
    suffix tokens, positioned from ``prefix_len`` (<= P; padded prefix
    rows are masked out of attention). ``ssm_init`` ("sub{i}" -> a
    snapshot stacked on num_blocks) restores every Mamba sublayer at the
    reuse boundary; ``snap_stride`` > 0 emits snapshots into the cache
    (see mamba_sublayer_seq)."""
    check_served(cfg)
    emb = params["embed"]
    h = emb[batch["tokens"].long()].to(emb.dtype)
    s = h.shape[1]
    positions = prefix_len + torch.arange(s, device=h.device)
    rot = rope_tables(positions, cfg.hd, cfg.rope_theta, 4) \
        if not cfg.attn_free else None
    aux = 0.0
    per_block = []
    for blk in range(num_blocks(cfg)):
        pfx = ssm = None
        if prefix is not None:
            pfx = {sub: ({"k": c["k"][blk], "v": c["v"][blk]} if c else {})
                   for sub, c in prefix.items()}
        if ssm_init is not None:
            ssm = {sub: {k: v[blk] for k, v in c.items()}
                   for sub, c in ssm_init.items()}
        extra = prefix is not None or ssm_init is not None
        h, a, cache = block_seq(cfg, _block_params(params, blk), h,
                                positions=positions, prefix=pfx,
                                prefix_len=prefix_len if extra else None,
                                valid_len=valid_len, rot=rot,
                                ssm_state=ssm, snap_stride=snap_stride)
        aux = aux + a
        per_block.append(cache)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    caches = {sub: {k: torch.stack([c[sub][k] for c in per_block])
                    for k in per_block[0][sub]}
              for sub in per_block[0]}
    return h, aux, caches


def lm_logits(cfg: ModelConfig, params: Tree, h: torch.Tensor
              ) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w.to(h.dtype)


def forward_prefill(cfg: ModelConfig, params: Tree, batch: Tree,
                    last_index: Optional[torch.Tensor] = None,
                    prefix: Optional[Tree] = None, prefix_len: int = 0,
                    ssm_init: Optional[Tree] = None, snap_stride: int = 0
                    ) -> Tuple[torch.Tensor, Tree]:
    """Returns (first generated token (b,) int32, cache).

    ``last_index`` (b,) selects each row's last prompt position in a
    right-padded batch AND marks the rows past it as padding for every
    sublayer (pad-invariance). With ``prefix``/``prefix_len``/
    ``ssm_init`` (see forward_seq) the returned cache covers only the
    suffix tokens; the caller stitches prefix ++ suffix."""
    valid_len = None if last_index is None \
        else (last_index.to(torch.int32) + 1).contiguous()
    h, _, caches = forward_seq(cfg, params, batch, prefix=prefix,
                               prefix_len=prefix_len, valid_len=valid_len,
                               ssm_init=ssm_init, snap_stride=snap_stride)
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
    slot_layers), the pool storage and the slot state updated in place.

    Each slot's new KV row is written at (block_tables[slot, pos // BS],
    pos % BS) of every attention layer, write-then-attend. Only the rows
    in ``write_rows`` (int64 slot indices: the active slots, which the
    caller knows on the host) are written. Inactive slots compute garbage
    rows that touch nothing: where JAX routed their writes out of range and dropped them,
    an out-of-range index_put_ on the card is a device assert, so the
    port writes the chosen rows only. Mamba sublayers step every slot's
    conv tails and SSD state (inactive slots are reseeded at admission);
    MoE runs with one capacity window per slot (rows = slots), so
    inactive slots never take an active slot's capacity."""
    check_served(cfg)
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
    tok_off = pos % bs
    wb = tok_blk[write_rows].long()
    wo = tok_off[write_rows].long()
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
                page.index_put_((wb, wo), kv_tok[write_rows])
                o = ops.paged_attention(q4.to(pool_dtype), page,
                                        block_tables, lens)
                h = h + _mm(_merge_heads(o).to(h.dtype), p["wo"])
            else:
                c = slot_layers[f"sub{i}"]
                h, mc = mamba_sublayer_step(
                    p, h, {k2: c[k2][blk] for k2 in SSM_LEAVES}, cfg)
                for k2 in SSM_LEAVES:
                    c[k2][blk].copy_(mc[k2])
            h2, _ = _ffn_sublayer(p, h[:, None, :], cfg, moe_mask[i])
            h = h2[:, 0]
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

    storage:      (attn_layers|1, NB, BS, W) paged pool, updated in place.
    block_tables: (n_slots, T) int32, -1 padded.
    tokens/pos:   (n_slots,) int32 last emitted token / tokens so far.
    active:       (n_slots,) bool slot mask.
    slot_layers:  {"sub{i}": {...}} per-slot Mamba state stacked on a
                  leading num_blocks axis (``caches.decode_slot_state``),
                  updated in place.
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
