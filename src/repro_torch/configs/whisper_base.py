"""Whisper-base [arXiv:2212.04356].

Encoder-decoder, 6L enc + 6L dec, d_model=512 8H d_ff=2048 vocab=51865.
Mel-spectrogram + conv frontend is a STUB — input_specs provide
precomputed frame embeddings (b, 1500, 512).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    arch_type="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    encoder_layers=6,
    encoder_seq=1500,
    frontend="audio",
    rope_theta=10_000.0,
)
