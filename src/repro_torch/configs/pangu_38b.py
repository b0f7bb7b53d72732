"""Pangu-like dense model standing in for the paper's own workloads [Pangu, arXiv:2303.10845].

The paper serves Pangu variants (sizes vary per scenario); we model a
38B-class dense GQA decoder as the paper-faithful serving target.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pangu-38b",
    arch_type="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=100352,
    head_dim=128,
    rope_theta=1_000_000.0,
)
