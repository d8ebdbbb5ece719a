"""whisper-base [audio]: 6L enc + 6L dec, d=512, 8H (kv=8), ff=2048, V=51865.

Enc-dec with conv audio frontend STUBBED: ``input_specs`` provides 1500
precomputed frame embeddings (the paper-assigned backbone-only scope).
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="encdec",
        num_layers=6, encoder_layers=6, cross_attention=True,
        d_model=512, num_heads=8, num_kv_heads=8, d_ff=2048,
        vocab_size=51865, frontend="audio", frontend_len=1500,
        rope_theta=0.0,  # whisper uses learned/sinusoidal positions, not RoPE
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base-reduced", family="encdec",
        num_layers=2, encoder_layers=2, cross_attention=True,
        d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
        vocab_size=256, frontend="audio", frontend_len=24, rope_theta=0.0,
    )
