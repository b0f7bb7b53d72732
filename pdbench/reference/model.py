"""Decoder-only transformer forward, plain PyTorch, one sequence at a time.

The equations the configuration files name (``arch_type`` "dense" or
"moe"): token embedding; per layer an RMSNorm, grouped-query attention
with rotary positions (the two halves of each head rotated, angles
``pos * theta ** (-i / (hd / 2))``), causal, scaled by ``hd ** -0.5``, a
residual add, an RMSNorm and a SwiGLU feed-forward (``silu(x Wg) * (x Wu)
Wd``) or, for "moe", a softmax router whose top-k gates are renormalised
to sum to one, the k routed SwiGLU experts weighted by them and the shared
experts as one SwiGLU of their summed width, a residual add; a final
RMSNorm and the LM head (the embedding's transpose when tied).

Weights are the benchmark's tree (``pdbench/weights.py``): stacked leaves
with the layers on the leading axis. The caller sets the precision of the
matmuls (``torch.backends.cuda.matmul.allow_tf32``); the configuration
states float32 with TF32 off.

Beside the equations, the model's counts that the harness reads through
``pdbench.spec.reference``: ``layout`` (the weight leaves, in the order
``pdbench/weights.py`` draws them) and ``matmul_params_per_token`` and
``attention_flops`` (the operations ``pdbench/roofline.py`` sums).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F


def layout(c: dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str]]:
    """(path, shape, init) of every leaf; init is "normal" or "ones"."""
    L, d, V = c["num_layers"], c["d_model"], c["vocab_size"]
    qd = c["num_heads"] * c["head_dim"]
    kvd = c["num_kv_heads"] * c["head_dim"]
    blk = ("blocks", "sub0")
    out = [(("embed",), (V, d), "normal"), (("final_norm",), (d,), "ones"),
           (blk + ("norm",), (L, d), "ones"),
           (blk + ("wq",), (L, d, qd), "normal"),
           (blk + ("wk",), (L, d, kvd), "normal"),
           (blk + ("wv",), (L, d, kvd), "normal"),
           (blk + ("wo",), (L, qd, d), "normal"),
           (blk + ("norm2",), (L, d), "ones")]
    m = c.get("moe")
    if m:
        E, f = m["num_experts"], m["d_ff_expert"]
        out += [(blk + ("moe", "router"), (L, d, E), "normal"),
                (blk + ("moe", "w_gate"), (L, E, d, f), "normal"),
                (blk + ("moe", "w_up"), (L, E, d, f), "normal"),
                (blk + ("moe", "w_down"), (L, E, f, d), "normal")]
        if m["num_shared_experts"]:
            fs = m["num_shared_experts"] * f
            out += [(blk + ("moe", "shared", "w_gate"), (L, d, fs), "normal"),
                    (blk + ("moe", "shared", "w_up"), (L, d, fs), "normal"),
                    (blk + ("moe", "shared", "w_down"), (L, fs, d), "normal")]
    else:
        f = c["d_ff"]
        out += [(blk + ("mlp", "w_gate"), (L, d, f), "normal"),
                (blk + ("mlp", "w_up"), (L, d, f), "normal"),
                (blk + ("mlp", "w_down"), (L, f, d), "normal")]
    if not c["tie_embeddings"]:
        out.append((("lm_head",), (d, V), "normal"))
    return out


def _dims(c: dict):
    hd = c["head_dim"]
    return hd, c["num_heads"] * hd, c["num_kv_heads"] * hd


def matmul_params_per_token(c: dict) -> int:
    """Weights a token multiplies through: attention projections, the
    feed-forward (a MoE token's router, top-k routed and shared experts)
    in every layer, and the LM head."""
    d, L = c["d_model"], c["num_layers"]
    _, qd, kvd = _dims(c)
    per_layer = 2 * d * qd + 2 * d * kvd
    m = c.get("moe")
    if m:
        f = m["d_ff_expert"]
        per_layer += d * m["num_experts"] \
            + (m["top_k"] + m["num_shared_experts"]) * 3 * d * f
    else:
        per_layer += 3 * d * c["d_ff"]
    return L * per_layer + d * c["vocab_size"]


def attention_flops(c: dict, pairs: int) -> float:
    """QK^T and PV over ``pairs`` in every layer and query head."""
    hd, qd, _ = _dims(c)
    return 4.0 * pairs * qd * c["num_layers"]


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
            ) -> torch.Tensor:
    half = x.shape[-1] // 2
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def _attention(c: dict, x: torch.Tensor, wq, wk, wv, wo, cos, sin):
    n = x.shape[0]
    nq, nkv, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    q = _rotate((x @ wq).view(n, nq, hd), cos, sin)
    k = _rotate((x @ wk).view(n, nkv, hd), cos, sin)
    v = (x @ wv).view(n, nkv, hd)
    g = nq // nkv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) * hd ** -0.5
    causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v)
    return o.reshape(n, nq * hd) @ wo


def _moe(c: dict, x: torch.Tensor, p: dict, layer: int) -> torch.Tensor:
    m = c["moe"]
    probs = torch.softmax(x @ p["router"][layer], dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :m["top_k"]]
    gates = gates / gates.sum(-1, keepdim=True)
    idx = idx[:, :m["top_k"]]
    y = torch.zeros_like(x)
    for e in torch.unique(idx).tolist():
        tok, slot = (idx == e).nonzero(as_tuple=True)
        ye = _swiglu(x[tok], p["w_gate"][layer, e], p["w_up"][layer, e],
                     p["w_down"][layer, e])
        y.index_add_(0, tok, ye * gates[tok, slot, None])
    if m["num_shared_experts"]:
        s = p["shared"]
        y = y + _swiglu(x, s["w_gate"][layer], s["w_up"][layer],
                        s["w_down"][layer])
    return y


@torch.no_grad()
def logits(c: dict, w: dict, tokens: torch.Tensor, first: int
           ) -> torch.Tensor:
    """Float32 logits (len(tokens) - first, vocab) at positions
    ``first, first + 1, ...`` of the causal forward over ``tokens``."""
    eps = c["norm_eps"]
    n = tokens.shape[0]
    half = c["head_dim"] // 2
    inv = c["rope_theta"] ** (-torch.arange(half, dtype=torch.float32,
                                            device=tokens.device) / half)
    ang = torch.arange(n, dtype=torch.float32, device=tokens.device)[:, None] \
        * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    h = w["embed"][tokens]
    b = w["blocks"]["sub0"]
    for i in range(c["num_layers"]):
        x = _rms(h, b["norm"][i], eps)
        h = h + _attention(c, x, b["wq"][i], b["wk"][i], b["wv"][i],
                           b["wo"][i], cos, sin)
        x = _rms(h, b["norm2"][i], eps)
        if c.get("moe"):
            h = h + _moe(c, x, b["moe"], i)
        else:
            mp = b["mlp"]
            h = h + _swiglu(x, mp["w_gate"][i], mp["w_up"][i],
                            mp["w_down"][i])
    h = _rms(h[first:], w["final_norm"], eps)
    head = w["embed"].T if c["tie_embeddings"] else w["lm_head"]
    return h @ head
