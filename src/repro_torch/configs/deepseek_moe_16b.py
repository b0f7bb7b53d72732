"""DeepSeekMoE-16B [arXiv:2401.06066].

28L d_model=2048 16H d_ff(expert)=1408 vocab=102400,
fine-grained MoE: 2 shared + 64 routed top-6.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    head_dim=128,
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                  d_ff_expert=1408, layout="all"),
)
