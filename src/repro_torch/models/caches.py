"""Decode caches: the dense cache's shapes, logical axes, abstract and
zeroed trees, and the per-slot decode state of the serving DecodeEngine.

Counterpart of ``src/repro/models/caches.py``. The dense cache (the
lockstep ``forward_decode``'s, and what the planner sizes) keeps a flat
per-layer KV layout (nblk, b, S, kv_dim); with a sliding ``window`` S is
the window and the cache is a ring. In the serving engine the paged pool
holds all self-attention KV, so attention sublayers carry no per-slot
state of their own; Mamba sublayers carry their conv tails and SSD state,
and every sublayer of an encoder-decoder its request's cross-attention
KV, stacked on a leading num_blocks axis with one row per slot. The
fused decode step updates the Mamba state in place; the cross KV is
written at admission.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.device import DeviceLike
from repro_torch.models.config import ATTN, ModelConfig
from repro_torch.models.params import block_period, num_blocks, tree_map

Tree = Dict[str, Any]


def _is_leaf(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)


def cache_shapes(cfg: ModelConfig, batch: int, seq: int, *,
                 window: Optional[int] = None) -> Tree:
    """The dense decode cache as (shape, logical axes) leaves:
    {"layers": {"sub{i}": {...}}, "pos": ((), ())}. Attention sublayers
    hold "k", "v" (nblk, batch, S, kv_dim) with S = window or seq, Mamba
    sublayers their conv tails and SSD state, an encoder-decoder's every
    sublayer the cross KV "xk", "xv" (nblk, batch, encoder_seq, kv_dim)."""
    nblk = num_blocks(cfg)
    kinds = cfg.layer_kinds()
    S = window if window is not None else seq
    layers: Tree = {}
    for i in range(block_period(cfg)):
        c: Tree = {}
        if kinds[i] == ATTN:
            for name in ("k", "v"):
                c[name] = ((nblk, batch, S, cfg.kv_dim),
                           ("layers", "batch", "cache_seq", "kv_heads"))
        else:
            s = cfg.ssm_cfg
            d_in = s.expand * cfg.d_model
            gn = s.n_groups * s.d_state
            nh = d_in // s.head_dim
            k = s.conv_kernel
            c["conv_x"] = ((nblk, batch, d_in, k - 1),
                           ("layers", "batch", "d_inner", None))
            c["conv_b"] = ((nblk, batch, gn, k - 1),
                           ("layers", "batch", None, None))
            c["conv_c"] = ((nblk, batch, gn, k - 1),
                           ("layers", "batch", None, None))
            c["state"] = ((nblk, batch, nh, s.d_state, s.head_dim),
                          ("layers", "batch", None, None, None))
        if cfg.is_encoder_decoder:
            for name in ("xk", "xv"):
                c[name] = ((nblk, batch, cfg.encoder_seq, cfg.kv_dim),
                           ("layers", "batch", None, "kv_heads"))
        layers[f"sub{i}"] = c
    return {"layers": layers, "pos": ((), ())}


def abstract_cache(cfg: ModelConfig, batch: int, seq: int, *,
                   window: Optional[int] = None,
                   dtype: torch.dtype = torch.bfloat16) -> Tree:
    """``cache_shapes`` as tensors on the ``meta`` device: the SSD state
    in f32 (it accumulates), "pos" a 0-d int32, the rest in ``dtype``."""
    def mk(name, leaf):
        shape, _ = leaf
        dt = torch.int32 if shape == () else \
            torch.float32 if name == "state" else dtype
        return torch.empty(shape, dtype=dt, device="meta")
    tree = cache_shapes(cfg, batch, seq, window=window)
    return {"layers": {sub: {n: mk(n, leaf) for n, leaf in c.items()}
                       for sub, c in tree["layers"].items()},
            "pos": mk("pos", tree["pos"])}


def cache_axes(cfg: ModelConfig, batch: int, seq: int, *,
               window: Optional[int] = None) -> Tree:
    return tree_map(lambda leaf: leaf[1],
                    cache_shapes(cfg, batch, seq, window=window),
                    is_leaf=_is_leaf)


def zeros_cache(cfg: ModelConfig, batch: int, seq: int, *,
                window: Optional[int] = None,
                dtype: torch.dtype = torch.float32, pos: int = 0,
                device: DeviceLike = "cuda") -> Tree:
    """A zeroed dense cache on ``device`` (the SSD state in f32, the rest
    in ``dtype``) with "pos" a 0-d int32 tensor holding ``pos`` on
    ``device``, as forward_prefill returns it and forward_decode takes
    it."""
    abstract = abstract_cache(cfg, batch, seq, window=window, dtype=dtype)
    return {"layers": tree_map(
                lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device),
                abstract["layers"]),
            "pos": torch.full((), int(pos), dtype=torch.int32,
                              device=device)}


def cache_num_bytes(cfg: ModelConfig, batch: int, seq: int, *,
                    window: Optional[int] = None,
                    bytes_per_el: int = 2) -> int:
    """Bytes of the dense cache at ``bytes_per_el`` a value (the JAX
    package's count: every leaf, the SSD state included, at that size)."""
    tree = cache_shapes(cfg, batch, seq, window=window)
    return sum(math.prod(shape) * bytes_per_el
               for c in tree["layers"].values()
               for shape, _ in c.values())

# the leaves of a Mamba sublayer's decode state (and of a snapshot)
SSM_LEAVES = ("conv_x", "conv_b", "conv_c", "state")


def decode_slot_state(cfg: ModelConfig, max_slots: int,
                      dtype: torch.dtype = torch.float32,
                      device: DeviceLike = "cuda") -> Tree:
    """Zeroed per-slot state {"sub{i}": {...}}, leaves stacked on a
    leading num_blocks axis with batch dim ``max_slots``: conv tails
    (nblk, slots, c, k-1) in ``dtype`` and the SSD state (nblk, slots,
    nh, d_state, head_dim) in f32 for Mamba sublayers; the cross KV
    "xk", "xv" (nblk, slots, encoder_seq, kv_dim) in ``dtype`` for every
    sublayer of an encoder-decoder."""
    nblk = num_blocks(cfg)
    kinds = cfg.layer_kinds()
    layers: Tree = {}

    def zeros(*shape, dt=dtype):
        return torch.zeros((nblk, max_slots) + shape, dtype=dt,
                           device=device)
    for i in range(block_period(cfg)):
        c: Tree = {}
        if kinds[i] != ATTN:
            s = cfg.ssm_cfg
            d_in = s.expand * cfg.d_model
            gn = s.n_groups * s.d_state
            nh = d_in // s.head_dim
            k = s.conv_kernel
            c["conv_x"] = zeros(d_in, k - 1)
            c["conv_b"] = zeros(gn, k - 1)
            c["conv_c"] = zeros(gn, k - 1)
            c["state"] = zeros(nh, s.d_state, s.head_dim, dt=torch.float32)
        if cfg.is_encoder_decoder:
            c["xk"] = zeros(cfg.encoder_seq, cfg.kv_dim)
            c["xv"] = zeros(cfg.encoder_seq, cfg.kv_dim)
        layers[f"sub{i}"] = c
    return layers


def select_slot_state(stacked: Tree, idx: torch.Tensor) -> Tree:
    """Per-slot pick out of a micro-step state stack: every leaf has
    shape (k+1, nblk, max_slots, ...) and ``idx`` (max_slots,) picks,
    per slot, which micro-step's state to keep. A pure gather."""
    def pick(x: torch.Tensor) -> torch.Tensor:
        ix = idx.long().reshape((1, 1, -1) + (1,) * (x.dim() - 3))
        ix = ix.expand((1,) + tuple(x.shape[1:]))
        return torch.gather(x, 0, ix)[0]
    return tree_map(pick, stacked)
