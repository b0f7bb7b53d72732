"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407].

40L d_model=5120 32H (kv=8, head_dim=128) d_ff=14336 vocab=131072, 128k ctx.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    rope_theta=1_000_000.0,
    max_seq_len=131072,
)
