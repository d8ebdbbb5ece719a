"""h2o-danube-1.8b [dense]: 24L d=2560 32H (kv=8) ff=6912 V=32000, llama +
mistral mix with sliding-window attention (window 4096) -- SWA makes the
long_500k decode cell in-family. [arXiv:2401.16818; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b", family="dense",
        num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
        d_ff=6912, vocab_size=32000, sliding_window=4096,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="danube-reduced", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, sliding_window=32,
    )
