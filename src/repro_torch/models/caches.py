"""Per-slot decode state for the serving DecodeEngine.

Counterpart of ``src/repro/models/caches.py:decode_slot_state`` and
``select_slot_state``. The paged pool holds all attention KV, so dense
stacks carry no per-slot state: every attention sublayer maps to an
empty dict. The structure is kept so that the SSM and encoder-decoder
slices fill in their entries (conv tails and SSD state, cross KV)
without reshaping callers.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import DeviceLike
from repro_torch.models.config import ATTN, ModelConfig
from repro_torch.models.params import block_period, tree_map
from repro_torch.scope import unported

Tree = Dict[str, Any]


def decode_slot_state(cfg: ModelConfig, max_slots: int,
                      dtype: torch.dtype = torch.float32,
                      device: DeviceLike = "cuda") -> Tree:
    """Zeroed per-slot state {"sub{i}": {...}}, leaves stacked on a
    leading num_blocks axis with batch dim ``max_slots``."""
    kinds = cfg.layer_kinds()
    layers: Tree = {}
    for i in range(block_period(cfg)):
        if kinds[i] != ATTN:
            raise unported(f"{cfg.name}: SSM slot state", 10)
        if cfg.is_encoder_decoder:
            raise unported(f"{cfg.name}: cross-attention slot state", 11)
        layers[f"sub{i}"] = {}
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
