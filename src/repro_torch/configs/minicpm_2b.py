"""MiniCPM-2B [arXiv:2404.06395] — llama-like, WSD schedule.

40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    arch_type="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    head_dim=64,
    tie_embeddings=True,
    rope_theta=10_000.0,
)
