"""qwen1.5-4b [dense]: 40L d=2560 20H (kv=20) ff=6912 V=151936, QKV bias.
[hf:Qwen/Qwen1.5-4B; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b", family="dense",
        num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20,
        d_ff=6912, vocab_size=151936, qkv_bias=True,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen-reduced", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, qkv_bias=True,
    )
