"""Qwen1.5-110B-like dense [hf:Qwen/Qwen1.5-0.5B family scaling].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064, QKV bias.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    arch_type="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
