"""mamba2-2.7b [ssm]: 64L d=2560, attention-free, V=50280, ssm_state=128.

Pure SSD (state-space duality) stack -- no attention, no MLP (d_ff=0);
the Mamba2 block carries the full FLOP budget. [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-reduced", family="ssm",
        num_layers=3, d_model=64, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=256,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2,
    )
