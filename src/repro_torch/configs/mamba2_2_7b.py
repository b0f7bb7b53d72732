"""Mamba2-2.7B [arXiv:2405.21060] — SSD (state-space duality).

64L d_model=2560, attention-free, d_ff=0 (no MLP; Mamba2 block only),
vocab=50280, ssm_state=128, headdim=64 -> 80 SSD heads.
"""
from repro_torch.models.config import ModelConfig, SSMConfig, MAMBA

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=64,
    tie_embeddings=True,
    layer_block=(MAMBA,),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2),
    max_seq_len=1048576,
)
