"""Jamba-1.5-Large (398B) [arXiv:2403.19887].

72L d_model=8192, attention:mamba = 1:7 interleave (1 attn layer per 8),
attn 64H (GQA kv=8), MoE 16 experts top-2 (every other layer) d_ff=24576,
vocab=65536, Mamba(2) ssm_state=128.
"""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig, ATTN, MAMBA

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    rope_theta=10_000.0,
    layer_block=(MAMBA, MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA),
    moe=MoEConfig(num_experts=16, top_k=2, num_shared_experts=0,
                  d_ff_expert=24576, layout="every_other"),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2),
    max_seq_len=262144,
)
