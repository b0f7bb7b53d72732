"""Parameter spec trees and materialized params.

Counterpart of ``src/repro/models/params.py``. ``param_specs`` gives the
same tree as the JAX package, key for key and shape for shape: identical
layers are stacked along a leading ``num_blocks`` axis, and heterogeneous
interleaves stack per sub-position (``params["blocks"]["sub3"]``). Params
are plain nested dicts of tensors in that layout.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ATTN, ModelConfig

Tree = Dict[str, Any]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis per dim
    init: str = "normal"             # normal | zeros | ones | small_normal
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn: Callable, tree, is_leaf: Callable = lambda x: False):
    """Map over the leaves of a nested dict (keys kept in insertion
    order)."""
    if isinstance(tree, dict) and not is_leaf(tree):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves in JAX's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _attn_specs(cfg: ModelConfig, cross: bool = False) -> Tree:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    sfx = "x" if cross else ""
    t: Tree = {
        f"wq{sfx}": ParamSpec((d, qd), ("embed", "q_heads")),
        f"wk{sfx}": ParamSpec((d, kvd), ("embed", "kv_heads")),
        f"wv{sfx}": ParamSpec((d, kvd), ("embed", "kv_heads")),
        f"wo{sfx}": ParamSpec((qd, d), ("q_heads", "embed")),
    }
    if cfg.qkv_bias and not cross:
        t[f"bq{sfx}"] = ParamSpec((qd,), ("q_heads",), init="zeros")
        t[f"bk{sfx}"] = ParamSpec((kvd,), ("kv_heads",), init="zeros")
        t[f"bv{sfx}"] = ParamSpec((kvd,), ("kv_heads",), init="zeros")
    return t


def _mlp_specs(d: int, ff: int) -> Tree:
    return {
        "w_gate": ParamSpec((d, ff), ("embed", "ff")),
        "w_up": ParamSpec((d, ff), ("embed", "ff")),
        "w_down": ParamSpec((ff, d), ("ff", "embed")),
    }


def _moe_specs(cfg: ModelConfig) -> Tree:
    m = cfg.moe
    d = cfg.d_model
    ffe = m.d_ff_expert or cfg.d_ff
    t: Tree = {
        "router": ParamSpec((d, m.num_experts), ("embed", None)),
        "w_gate": ParamSpec((m.num_experts, d, ffe), ("expert", "embed", "ff")),
        "w_up": ParamSpec((m.num_experts, d, ffe), ("expert", "embed", "ff")),
        "w_down": ParamSpec((m.num_experts, ffe, d), ("expert", "ff", "embed")),
    }
    if m.num_shared_experts:
        t["shared"] = _mlp_specs(d, m.num_shared_experts * ffe)
    return t


def _mamba_specs(cfg: ModelConfig) -> Tree:
    s = cfg.ssm_cfg
    d = cfg.d_model
    d_in = s.expand * d
    gn = s.n_groups * s.d_state
    nh = d_in // s.head_dim
    k = s.conv_kernel
    return {
        "w_z": ParamSpec((d, d_in), ("embed", "d_inner")),
        "w_x": ParamSpec((d, d_in), ("embed", "d_inner")),
        "w_b": ParamSpec((d, gn), ("embed", None)),
        "w_c": ParamSpec((d, gn), ("embed", None)),
        "w_dt": ParamSpec((d, nh), ("embed", None)),
        "conv_x": ParamSpec((d_in, k), ("d_inner", None), init="small_normal"),
        "conv_b": ParamSpec((gn, k), (None, None), init="small_normal"),
        "conv_c": ParamSpec((gn, k), (None, None), init="small_normal"),
        "a_log": ParamSpec((nh,), (None,), init="ones"),
        "d_skip": ParamSpec((nh,), (None,), init="ones"),
        "dt_bias": ParamSpec((nh,), (None,), init="zeros"),
        "norm_g": ParamSpec((d_in,), ("d_inner",), init="ones"),
        "w_out": ParamSpec((d_in, d), ("d_inner", "embed")),
    }


def sublayer_specs(cfg: ModelConfig, sub: int, *, decoder: bool = True) -> Tree:
    """Spec tree for one sub-position of the repeating block (unstacked)."""
    kind = cfg.layer_kinds()[sub]
    is_moe = cfg.moe_layer_mask()[sub]
    d = cfg.d_model
    t: Tree = {"norm": ParamSpec((d,), ("embed",), init="ones")}
    t.update(_attn_specs(cfg) if kind == ATTN else _mamba_specs(cfg))
    if decoder and cfg.is_encoder_decoder:
        t["norm_x"] = ParamSpec((d,), ("embed",), init="ones")
        t.update(_attn_specs(cfg, cross=True))
    if is_moe:
        t["norm2"] = ParamSpec((d,), ("embed",), init="ones")
        t["moe"] = _moe_specs(cfg)
    elif cfg.d_ff > 0:
        t["norm2"] = ParamSpec((d,), ("embed",), init="ones")
        t["mlp"] = _mlp_specs(d, cfg.d_ff)
    return t


def block_period(cfg: ModelConfig) -> int:
    p = len(cfg.layer_block)
    if cfg.moe is not None and cfg.moe.layout == "every_other":
        p = (p * 2) // math.gcd(p, 2)
    if cfg.num_layers % p != 0:
        raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} % period {p} != 0")
    return p


def num_blocks(cfg: ModelConfig) -> int:
    return cfg.num_layers // block_period(cfg)


def _stack(tree: Tree, n: int) -> Tree:
    """Add a leading 'layers' axis of size n to every spec leaf."""
    return tree_map(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                        s.init, s.scale), tree)


def param_specs(cfg: ModelConfig) -> Tree:
    d = cfg.d_model
    period = block_period(cfg)
    nblk = num_blocks(cfg)
    t: Tree = {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed")),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "blocks": {
            f"sub{i}": _stack(sublayer_specs(cfg, i), nblk)
            for i in range(period)
        },
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamSpec((d, cfg.vocab_size), ("embed", "vocab"))
    if cfg.is_encoder_decoder:
        enc_sub: Tree = {"norm": ParamSpec((d,), ("embed",), init="ones")}
        enc_sub.update(_attn_specs(cfg))
        enc_sub["norm2"] = ParamSpec((d,), ("embed",), init="ones")
        enc_sub["mlp"] = _mlp_specs(d, cfg.d_ff)
        t["encoder"] = {
            "blocks": {"sub0": _stack(enc_sub, cfg.encoder_layers)},
            "final_norm": ParamSpec((d,), ("embed",), init="ones"),
            "pos_embed": ParamSpec((cfg.encoder_seq, d), (None, "embed")),
        }
    return t


def _leaf_paths(tree: Tree, prefix=()):
    """(path, leaf) pairs in JAX's flattening order (sorted keys)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(tree: Tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = "cuda",
                dtype: torch.dtype = torch.float32) -> Tree:
    """Random params drawn on ``device`` from ``generator`` (a generator
    of that device; seed 0 when omitted), leaf by leaf in JAX's
    flattening order. Same distributions as the JAX ``init_params``, but
    not the same numbers: compare the two stacks through
    ``params_from_numpy``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    out: Tree = {}
    for path, s in _leaf_paths(param_specs(cfg)):
        if s.init == "zeros":
            x = torch.zeros(s.shape, dtype=dtype, device=dev)
        elif s.init == "ones":
            x = torch.ones(s.shape, dtype=dtype, device=dev)
        else:
            scale = s.scale if s.init == "normal" else s.scale * 0.5
            x = torch.randn(s.shape, generator=generator, device=dev,
                            dtype=torch.float32).mul_(scale).to(dtype)
        _set(out, path, x)
    return out


def params_from_numpy(cfg: ModelConfig, tree: Tree,
                      device: DeviceLike = "cuda",
                      dtype: Optional[torch.dtype] = None) -> Tree:
    """Turn the JAX package's params (any nested dict of arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) into the port's, checking every
    key and shape against ``param_specs``. Values are copied exactly;
    ``dtype`` casts them, else each keeps its own dtype (bfloat16 arrays
    come through as torch.bfloat16)."""
    dev = resolve_device(device)
    out: Tree = {}
    specs = dict(_leaf_paths(param_specs(cfg)))
    have = dict(_leaf_paths(tree))
    if set(specs) != set(have):
        raise KeyError(f"param tree keys differ from param_specs: "
                       f"{sorted(set(specs) ^ set(have))}")
    for path, s in specs.items():
        arr = np.asarray(have[path])
        if tuple(arr.shape) != s.shape:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != "
                             f"{s.shape}")
        if arr.dtype.name == "bfloat16":
            x = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            x = torch.from_numpy(np.array(arr))
        _set(out, path, x.to(device=dev, dtype=dtype or x.dtype))
    return out
