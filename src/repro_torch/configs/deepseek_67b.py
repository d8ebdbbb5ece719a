"""deepseek-67b [dense]: 95L d=8192 64H (kv=8) ff=22016 V=102400 -- llama
architecture at 67B scale; the largest assigned cell and the FSDP stress
test. [arXiv:2401.02954; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b", family="dense",
        num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=22016, vocab_size=102400,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-reduced", family="dense",
        num_layers=3, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=160, vocab_size=256,
    )
