"""granite-moe-1b-a400m [moe]: 24L d=1024 16H (kv=8) V=49155, 32 experts top-8,
per-expert ff=512. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
        d_ff=512, vocab_size=49155,
        num_experts=32, experts_per_token=8, moe_d_ff=512,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-reduced", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=64, vocab_size=256,
        num_experts=4, experts_per_token=2, moe_d_ff=64,
    )
