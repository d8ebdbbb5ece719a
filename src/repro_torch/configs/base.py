"""ModelConfig + input-shape grid + the architecture registry.

A copy of ``repro.configs.base`` (pure Python), so that the port imports
nothing of the JAX package.  Every assigned architecture is a
``ModelConfig`` in its own module under ``repro_torch.configs``;
``get_config(name)`` returns the full published config and
``get_config(name, reduced=True)`` a tiny same-family config for CPU smoke
tests. The (arch x shape) grid for the dry-run comes from ``SHAPES`` and
``cells_for(config)`` which applies the per-family skip rules (DESIGN.md §5).
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field, replace
from typing import Optional

__all__ = ["ModelConfig", "InputShape", "SHAPES", "ARCH_NAMES", "get_config",
           "cells_for", "all_cells"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads

    # attention variants
    qkv_bias: bool = False           # qwen1.5
    sliding_window: Optional[int] = None   # h2o-danube SWA; zamba2 long ctx
    rope_theta: float = 10000.0
    attn_logit_softcap: Optional[float] = None

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # per-expert hidden (granite: 512)
    capacity_factor: float = 1.25

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    attn_every: int = 0              # hybrid: shared attn block every k layers

    # enc-dec (whisper)
    encoder_layers: int = 0
    cross_attention: bool = False

    # modality frontend stub
    frontend: Optional[str] = None   # "audio" (1500 frames) | "vlm" (256 patches)
    frontend_len: int = 0

    # numerics / schedule
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    attn_chunk: int = 2048           # flash-style KV chunking threshold/size
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # ---- beyond-paper perf knobs (EXPERIMENTS.md §Perf; defaults = the
    # paper-faithful baseline the roofline table was measured on) ----
    gqa_repeat_kv: bool = False      # expand KV->H heads in train/prefill
    #   attention instead of the (KV,G) grouped reshape, keeping scores
    #   head-sharded when KV < model-axis < H (deepseek: 16x score memory)
    shard_cache_seq: bool = False    # decode KV cache: shard the seq dim
    #   over the model axis (flash-decoding-style partial attention + tiny
    #   softmax all-reduce) -- fits 32k caches when kv_heads % model != 0
    moe_impl: str = "gspmd_sort"     # or "shard_map_local": tokens stay on
    #   their data shard, each model shard runs ITS experts on all local
    #   tokens, one psum over model combines -- removes the cross-shard
    #   dispatch scatter (the granite 454GB/layer all-reduce)
    kv_cache_dtype: str = "bfloat16" # or "int8": symmetric per-(pos,head)
    #   quantized KV cache -- ~1.95x less decode HBM and cache-read
    #   bandwidth (models/kv_quant.py)

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if long_500k decode is in-family (SSM / hybrid / SWA)."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def num_params(self) -> int:
        """Exact parameter count (matches init_params leaf sizes)."""
        from repro_torch.models.params import param_table
        return sum(int_prod(s.shape) for s in param_table(self).values())

    def active_params(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        n = self.num_params()
        if self.num_experts:
            dead_frac_ff = (self.num_experts - self.experts_per_token) / self.num_experts
            expert_params = (self.num_layers * self.num_experts
                             * 3 * self.d_model * self.moe_d_ff)
            n -= int(dead_frac_ff * expert_params)
        return n


def int_prod(xs):
    out = 1
    for x in xs:
        out *= int(x)
    return out


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPES: dict[str, InputShape] = {
    "train_4k":    InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k":  InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k":   InputShape("long_500k", 524288, 1, "decode"),
}

ARCH_NAMES = [
    "whisper-base", "zamba2-1.2b", "mamba2-2.7b", "granite-moe-1b-a400m",
    "granite-moe-3b-a800m", "minitron-4b", "qwen1.5-4b", "deepseek-67b",
    "h2o-danube-1.8b", "internvl2-1b",
]

_MODULE_FOR = {n: n.replace("-", "_").replace(".", "_") for n in ARCH_NAMES}
_MODULE_FOR["chessfad"] = "chessfad"


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{_MODULE_FOR[name]}")
    return mod.reduced_config() if reduced else mod.config()


def shape_supported(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Apply the per-family skip rules. Returns (supported, reason)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention (DESIGN.md §5)"
    return True, ""


def cells_for(cfg: ModelConfig):
    for shape in SHAPES.values():
        ok, why = shape_supported(cfg, shape)
        yield shape, ok, why


def all_cells():
    """All 40 (arch, shape) cells with their live/skip status."""
    for name in ARCH_NAMES:
        cfg = get_config(name)
        for shape, ok, why in cells_for(cfg):
            yield name, cfg, shape, ok, why
