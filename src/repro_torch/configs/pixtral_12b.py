"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409].

Language decoder (mistral-nemo backbone): 40L d_model=5120 32H (kv=8)
d_ff=14336 vocab=131072. The Pixtral-ViT vision frontend is a STUB —
input_specs provide precomputed patch embeddings of shape (b, s, d_model).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    arch_type="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    rope_theta=1_000_000_000.0,
    frontend="vision",
)
