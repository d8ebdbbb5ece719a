"""Shared model building blocks: norms, activations, dtype policy.

Counterpart of ``repro.models.common``.  Functions of tensors; the norms
compute in float32 and return the input's dtype, as the reference does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

__all__ = ["rms_norm", "layer_norm", "silu", "gelu", "softplus",
           "cast_to_compute", "DTYPES"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def cast_to_compute(params, cfg):
    """Every floating leaf of ``params`` in ``cfg.compute_dtype`` (the
    parameters stay in ``param_dtype``; this copy is what the forward
    reads, so the tangents of a float32 tree cast with it)."""
    dt = DTYPES[cfg.compute_dtype]
    return pytree.tree_map(
        lambda p: p.to(dt) if p.is_floating_point() else p, params)


def rms_norm(x, scale, eps=1e-5):
    """RMSNorm in fp32 (the norm is tiny; precision matters at bf16)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def softplus(x):
    return F.softplus(x)
