"""Weights drawn from the seed, on the device, in the type they are
served in (float32), by the benchmark's own generator.

Every matrix is a view into one flat buffer filled by a few large
``randn`` calls and scaled by 0.02; the norm gains are ones. The tree is
laid out as the port takes its params (one stacked tensor per leaf, the
layers on the leading axis), and the plain reference reads the same
tensors: both sides get the same numbers and neither derives them from
the other.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

SCALE = 0.02
CHUNK = 1 << 30          # elements a randn call fills
ALIGN = 64               # elements between leaves (256-byte aligned)


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


def make(c: dict, seed: int, device) -> Dict:
    """The weight tree of configuration ``c`` drawn from ``seed``."""
    dev = torch.device(device)
    leaves = layout(c)
    offs, n = [], 0
    for _, shape, init in leaves:
        if init == "normal":
            offs.append(n)
            n += -(-math.prod(shape) // ALIGN) * ALIGN
        else:
            offs.append(None)
    flat = torch.empty(n, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    for a in range(0, n, CHUNK):
        flat[a:a + CHUNK].normal_(generator=gen).mul_(SCALE)
    tree: Dict = {}
    for (path, shape, init), off in zip(leaves, offs):
        if init == "normal":
            x = flat[off:off + math.prod(shape)].view(shape)
        else:
            x = torch.ones(shape, dtype=torch.float32, device=dev)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return tree
