"""Serving cost profiles for the simulator, and the heterogeneous node
classes of the autoscaler's shared node pool (counterpart of
``src/repro/core/profiles.py``).

The discrete-event simulator needs TTFT/TPOT/transfer costs per instance.
``profile_for`` derives them from a ModelConfig with the JAX package's
roofline arithmetic, but at an NVIDIA H100's published rates and the
dtype the port serves: prefill is compute-bound (2·N·tokens / instance
FLOPs), decode is memory-bound (params bytes / HBM bw), transfer time
comes from KV bytes over the LinkModel. A ``ServingProfile`` can also be
fitted to walls measured on the card (``chip_smoke.py`` phase 11).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.launch import mesh
from repro_torch.models.config import ATTN, ModelConfig

# One NVIDIA H100 80GB HBM3 at its 700 W limit (launch/mesh.py holds the
# published rates): f32 on the CUDA cores (the port serves f32 with TF32
# off) and the HBM rate, the rates PERF.md's kernel bounds use.
H100_F32_FLOPS = mesh.PEAK_FLOPS["float32"]
H100_HBM_BPS = mesh.HBM_BW
# An instance is an 8-GPU node, in place of the paper's 8-NPU Atlas
# instance.
CARDS_PER_INSTANCE = 8
# ASSUMED efficiencies, not measurements: the prefill MFU and the share
# of the HBM rate a decode step reaches (the JAX package's factors).
PREFILL_MFU = 0.45
HBM_EFFICIENCY = 0.7
PEAK_FLOPS = H100_F32_FLOPS * CARDS_PER_INSTANCE * PREFILL_MFU
HBM_BW = H100_HBM_BPS * CARDS_PER_INSTANCE * HBM_EFFICIENCY
# the dtype of the port's params and paged KV pools
SERVED_DTYPE = torch.float32


@dataclass(frozen=True)
class ServingProfile:
    name: str
    kv_bytes_per_token: int
    prefill_tok_rate: float      # tokens/s at reference batch
    prefill_fixed: float         # per-batch fixed overhead (s)
    tpot_base: float             # decode iteration floor (s)
    tpot_per_req: float          # added per concurrent request (s)
    params_bytes: int
    prefix_reuse_eff: float = 0.95   # fraction of hit tokens skipped

    def ttft(self, batch_tokens: int, hit_tokens: int = 0) -> float:
        eff = batch_tokens - self.prefix_reuse_eff * hit_tokens
        return self.prefill_fixed + max(eff, 0.0) / self.prefill_tok_rate

    def tpot(self, concurrent: int) -> float:
        return self.tpot_base + self.tpot_per_req * concurrent


@dataclass(frozen=True)
class NodeClass:
    """One hardware class in the shared autoscaler node pool.

    The real engines execute the same compute regardless of class (token
    streams are class-invariant); a class only scales the VIRTUAL
    service time its node charges the event clock — prefill-heavy nodes
    run prefill batches faster and decode steps slower, decode-heavy
    the inverse. ``role_bias`` steers the pool's lease choice: the
    autoscaler prefers a prefill-heavy node when growing the P side of
    a group, falling back to balanced then off-bias classes when the
    preferred inventory is exhausted. ``provision_level`` picks the
    ``core.mlops.substitute_ready_delay`` timeline a provisioning event
    pays before the node takes traffic (one stateless container:
    connect + model load + health)."""
    name: str
    role_bias: str = ""              # "P" | "D" | "" (no preference)
    prefill_scale: float = 1.0       # service-time multiplier (<1 faster)
    decode_scale: float = 1.0
    provision_level: str = "node_replace"


BALANCED = NodeClass("balanced")
PREFILL_HEAVY = NodeClass("prefill-heavy", role_bias="P",
                          prefill_scale=0.6, decode_scale=1.5)
DECODE_HEAVY = NodeClass("decode-heavy", role_bias="D",
                         prefill_scale=1.5, decode_scale=0.6)

NODE_CLASSES = {c.name: c for c in (BALANCED, PREFILL_HEAVY, DECODE_HEAVY)}


def profile_for(cfg: ModelConfig) -> ServingProfile:
    """The analytic profile of one H100 instance serving ``cfg`` in
    ``SERVED_DTYPE`` (the JAX package's arithmetic, with K+V bytes and
    params bytes at the served dtype instead of bf16)."""
    nbytes = SERVED_DTYPE.itemsize
    n_attn = sum(1 for k in cfg.layer_kinds() if k == ATTN)
    kv_bpt = 2 * cfg.kv_dim * n_attn * nbytes     # K+V
    n = cfg.param_count(active_only=True)
    params_bytes = cfg.param_count() * nbytes
    tok_rate = PEAK_FLOPS / (2.0 * n)             # prefill tokens/s
    # decode iteration: weights + avg cache traffic per token
    tpot_base = params_bytes / HBM_BW
    tpot_per_req = kv_bpt * 2048 / HBM_BW         # ~2k ctx cache read
    return ServingProfile(
        name=cfg.name, kv_bytes_per_token=kv_bpt,
        prefill_tok_rate=tok_rate, prefill_fixed=0.015,
        tpot_base=tpot_base, tpot_per_req=tpot_per_req,
        params_bytes=params_bytes)
