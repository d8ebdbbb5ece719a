"""minitron-4b [dense]: 32L d=3072 24H (kv=8) ff=9216 V=256000 -- pruned
nemotron. [arXiv:2407.14679; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b", family="dense",
        num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
        d_ff=9216, vocab_size=256000,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-reduced", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256,
    )
