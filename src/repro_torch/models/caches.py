"""Per-slot decode state for the serving DecodeEngine.

Counterpart of ``src/repro/models/caches.py:decode_slot_state`` and
``select_slot_state``. The paged pool holds all self-attention KV, so
attention sublayers carry no per-slot state of their own; Mamba
sublayers carry their conv tails and SSD state, and every sublayer of an
encoder-decoder its request's cross-attention KV, stacked on a leading
num_blocks axis with one row per slot. The fused decode step updates the
Mamba state in place; the cross KV is written at admission.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import DeviceLike
from repro_torch.models.config import ATTN, ModelConfig
from repro_torch.models.params import block_period, num_blocks, tree_map

Tree = Dict[str, Any]

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
