"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (kv=8) V=49155, MoE 40e top-8,
per-expert ff=512.

NOTE: 40 experts do NOT divide the 16-wide ``model`` axis -- the sharding
rule engine falls back to replicating the expert dim and sharding the
per-expert ffn dim instead; the padding/replication waste is called out in
EXPERIMENTS.md §Roofline. [hf:ibm-granite/granite-3.0-3b-a800m-base; hf]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
        d_ff=512, vocab_size=49155,
        num_experts=40, experts_per_token=8, moe_d_ff=512,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-reduced", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=64, vocab_size=256,
        num_experts=5, experts_per_token=2, moe_d_ff=64,  # 5 keeps the
        # indivisible-expert fallback path exercised in smoke tests
    )
