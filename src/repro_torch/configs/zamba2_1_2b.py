"""zamba2-1.2b [hybrid]: 38L d=2048 32H (kv=32) ff=8192 V=32000 ssm_state=64.

Mamba2 backbone with a SHARED attention block applied every ``attn_every``
layers (one attention parameter set reused -- the Zamba2 design). The shared
attn block uses SWA so long_500k decode stays sub-quadratic.
[arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=32000,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_every=6,
        sliding_window=4096,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-reduced", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, attn_every=2,
        sliding_window=64,
    )
