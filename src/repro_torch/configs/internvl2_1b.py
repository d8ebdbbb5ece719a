"""internvl2-1b [vlm]: 24L d=896 14H (kv=2) ff=4864 V=151655 -- Qwen2-0.5B
language backbone; the InternViT frontend is STUBBED: ``input_specs``
provides 256 precomputed patch embeddings prepended to the token sequence.
[arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", family="vlm",
        num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
        d_ff=4864, vocab_size=151655,
        frontend="vlm", frontend_len=256,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-reduced", family="vlm",
        num_layers=2, d_model=56, num_heads=4, num_kv_heads=2,
        d_ff=112, vocab_size=256,
        frontend="vlm", frontend_len=8,
    )
