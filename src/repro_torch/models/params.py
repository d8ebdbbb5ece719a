"""Parameter table: ONE source of truth for shapes and initializers, for
every architecture family.

Counterpart of ``repro.models.params``.  ``param_table(cfg)`` returns a
flat {path: PSpec}; ``init_params(cfg, generator, device)`` materializes
it.  Nested-dict paths use '/' separators; ``unflatten`` rebuilds the tree
the forward code consumes.  Stacked layer params carry a leading
("layers",) dim, and the attention weights keep the reference's
(d, H, hd) / (H, hd, d) shapes, so weights carry across 1:1.

Key order: ``jax.tree.flatten`` sorts dict keys, ``torch.utils._pytree``
flattens in insertion order.  Every dict built here is inserted in sorted
key order, so a tree's leaf order, and the rows it ravels to, are the
reference's.  ``param_specs(cfg, mesh)`` maps each leaf's ``logical`` axes
to a spec on the mesh (``parallel.sharding.spec_for`` with
``PARAM_RULES``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import DTYPES
from repro_torch.parallel.sharding import PARAM_RULES, spec_for

__all__ = ["PSpec", "param_table", "init_params", "param_specs",
           "unflatten", "flatten"]


@dataclass(frozen=True)
class PSpec:
    shape: tuple
    logical: tuple
    init: str = "normal"       # normal | zeros | ones | a_log | dt_bias


def _attn(cfg: ModelConfig, L: Optional[int], prefix: str, table,
          kv_heads=None, bias=None, ln_bias=False):
    d, H = cfg.d_model, cfg.num_heads
    KV = kv_heads if kv_heads is not None else cfg.num_kv_heads
    hd = cfg.head_dim_
    bias = cfg.qkv_bias if bias is None else bias
    Ld = () if L is None else (L,)
    La = () if L is None else ("layers",)

    def put(name, shape, logical, init="normal"):
        table[f"{prefix}{name}"] = PSpec(Ld + shape, La + logical, init)

    put("norm", (d,), ("embed",), "zeros" if not ln_bias else "ones")
    if ln_bias:
        put("norm_b", (d,), ("embed",), "zeros")
    put("wq", (d, H, hd), ("embed", "heads", "head_dim"))
    put("wk", (d, KV, hd), ("embed", "kv_heads", "head_dim"))
    put("wv", (d, KV, hd), ("embed", "kv_heads", "head_dim"))
    put("wo", (H, hd, d), ("heads", "head_dim", "embed"))
    if bias:
        put("bq", (H, hd), ("heads", "head_dim"), "zeros")
        put("bk", (KV, hd), ("kv_heads", "head_dim"), "zeros")
        put("bv", (KV, hd), ("kv_heads", "head_dim"), "zeros")


def _mlp(cfg: ModelConfig, L: Optional[int], prefix: str, table,
         gelu=False, ln_bias=False):
    d, ff = cfg.d_model, cfg.d_ff
    Ld = () if L is None else (L,)
    La = () if L is None else ("layers",)

    def put(name, shape, logical, init="normal"):
        table[f"{prefix}{name}"] = PSpec(Ld + shape, La + logical, init)

    put("norm", (d,), ("embed",), "zeros" if not ln_bias else "ones")
    if ln_bias:
        put("norm_b", (d,), ("embed",), "zeros")
    if gelu:
        put("w1", (d, ff), ("embed", "ffn"))
        put("b1", (ff,), ("ffn",), "zeros")
        put("w2", (ff, d), ("ffn", "embed"))
        put("b2", (d,), ("embed",), "zeros")
    else:
        put("w_gate", (d, ff), ("embed", "ffn"))
        put("w_up", (d, ff), ("embed", "ffn"))
        put("w_down", (ff, d), ("ffn", "embed"))


def _moe(cfg: ModelConfig, L: int, prefix: str, table):
    d, E, ffe = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    table[f"{prefix}norm"] = PSpec((L, d), ("layers", "embed"), "zeros")
    table[f"{prefix}router"] = PSpec((L, d, E), ("layers", "embed", "experts"))
    for w in ("w_gate", "w_up"):
        table[f"{prefix}{w}"] = PSpec(
            (L, E, d, ffe), ("layers", "experts", "embed", "expert_ffn"))
    table[f"{prefix}w_down"] = PSpec(
        (L, E, ffe, d), ("layers", "experts", "expert_ffn", "embed"))


def _ssm(cfg: ModelConfig, L: int, prefix: str, table):
    d, din = cfg.d_model, cfg.d_inner
    H, N, W = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv_width

    def put(name, shape, logical, init="normal"):
        table[f"{prefix}{name}"] = PSpec((L,) + shape, ("layers",) + logical,
                                         init)

    put("norm_in", (d,), ("embed",), "zeros")
    put("w_z", (d, din), ("embed", "ffn"))
    put("w_x", (d, din), ("embed", "ffn"))
    put("w_B", (d, N), ("embed", "ssm_state"))
    put("w_C", (d, N), ("embed", "ssm_state"))
    put("w_dt", (d, H), ("embed", "ssm_heads"))
    put("conv_x", (W, din), ("conv", "ffn"))
    put("conv_B", (W, N), ("conv", "ssm_state"))
    put("conv_C", (W, N), ("conv", "ssm_state"))
    put("A_log", (H,), ("ssm_heads",), "a_log")
    put("D", (H,), ("ssm_heads",), "ones")
    put("dt_bias", (H,), ("ssm_heads",), "dt_bias")
    put("norm", (din,), ("ffn",), "zeros")
    put("w_out", (din, d), ("ffn", "embed"))


def param_table(cfg: ModelConfig) -> dict[str, PSpec]:
    t: dict[str, PSpec] = {}
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    t["embed"] = PSpec((V, d), ("vocab", "embed"))

    if cfg.family in ("dense", "vlm"):
        _attn(cfg, L, "layers/attn/", t)
        _mlp(cfg, L, "layers/mlp/", t)
    elif cfg.family == "moe":
        _attn(cfg, L, "layers/attn/", t)
        _moe(cfg, L, "layers/moe/", t)
    elif cfg.family == "ssm":
        _ssm(cfg, L, "layers/ssm/", t)
    elif cfg.family == "hybrid":
        _ssm(cfg, L, "layers/ssm/", t)
        _attn(cfg, None, "shared/attn/", t)      # ONE shared block (Zamba2)
        _mlp(cfg, None, "shared/mlp/", t)
    elif cfg.family == "encdec":
        Le = cfg.encoder_layers
        _attn(cfg, Le, "encoder/layers/attn/", t, bias=True, ln_bias=True)
        _mlp(cfg, Le, "encoder/layers/mlp/", t, gelu=True, ln_bias=True)
        t["encoder/norm"] = PSpec((d,), ("embed",), "ones")
        t["encoder/norm_b"] = PSpec((d,), ("embed",), "zeros")
        _attn(cfg, L, "layers/attn/", t, bias=True, ln_bias=True)
        _attn(cfg, L, "layers/cross/", t, bias=True, ln_bias=True)
        _mlp(cfg, L, "layers/mlp/", t, gelu=True, ln_bias=True)
    else:
        raise ValueError(cfg.family)

    if cfg.family == "encdec":
        t["final_norm"] = PSpec((d,), ("embed",), "ones")
        t["final_norm_b"] = PSpec((d,), ("embed",), "zeros")
    else:
        t["final_norm"] = PSpec((d,), ("embed",), "zeros")
    if cfg.frontend:
        t["frontend_adapter"] = PSpec((d, d), ("embed", "embed_tp"))
    if not cfg.tie_embeddings:
        t["unembed"] = PSpec((d, V), ("embed", "vocab"))
    return t


# ---------------------------------------------------------------------------
# materialization
# ---------------------------------------------------------------------------

def _fan_in_std(shape) -> float:
    """The reference's fan-in scale: the input dim of a matrix, the leading
    (model) dim of a (d, H, hd)-style weight."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    if len(shape) >= 3:
        fan_in = shape[-3]
    return min(0.02, 1.0 / math.sqrt(max(fan_in, 1)))


def _init_leaf(gen, spec: PSpec, dtype, device):
    shape = spec.shape
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if spec.init == "a_log":
        return out.uniform_(1.0, 16.0, generator=gen).log_().to(dtype)
    if spec.init == "dt_bias":
        dt = out.uniform_(1e-3, 1e-1, generator=gen)
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)  # softplus^-1
    return out.normal_(0.0, _fan_in_std(shape), generator=gen).to(dtype)


def init_params(cfg: ModelConfig, generator=0, device="cuda"):
    """The parameter tree of ``cfg`` on ``device`` (the card unless the
    caller asks for the CPU), in ``cfg.param_dtype``: fan-in-scaled normal
    weights and the reference's zeros/ones norms, drawn leaf by leaf in
    sorted path order from ``generator`` (a ``torch.Generator`` on
    ``device``, or an int seed for a fresh one).  The values differ from
    the JAX package's; ``convert.lm_params_from_numpy`` carries those
    across instead."""
    device = torch.device(device)
    if isinstance(generator, torch.Generator):
        gen = generator
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(generator))
    dtype = DTYPES[cfg.param_dtype]
    out = {}
    for path, spec in sorted(param_table(cfg).items()):
        out[path] = _init_leaf(gen, spec, dtype, device)
    return unflatten(out)


def param_specs(cfg: ModelConfig, mesh):
    """The spec tree of ``cfg``'s params on ``mesh`` (a DeviceMesh or an
    ``{axis: size}`` dict)."""
    return unflatten({p: spec_for(s.shape, s.logical, mesh, PARAM_RULES)
                      for p, s in param_table(cfg).items()})


# ---------------------------------------------------------------------------
# path <-> tree
# ---------------------------------------------------------------------------

def unflatten(flat: dict):
    """{'a/b': x} -> {'a': {'b': x}}, every level inserted in sorted key
    order (the order ``jax.tree.flatten`` visits), whatever the order of
    ``flat``."""
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return _sorted(tree)


def _sorted(tree):
    if not isinstance(tree, dict):
        return tree
    return {k: _sorted(tree[k]) for k in sorted(tree)}


def flatten(tree: dict, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out
