"""int8 KV-cache quantization, and the curvature-informed per-layer policy.

Counterpart of ``repro.models.kv_quant``.  Decode reads the whole cache
every token; symmetric per-(position, head) int8 halves its bytes, at a
small logit error (tests bound it).

Layout: k/v stored int8 with a float32 scale per (batch, pos, kv_head):
    q = round(x / s),  s = max|x| over head_dim / 127 + 1e-12
(``torch.round`` rounds half to even, as ``jnp.round`` does).  The cache is
dequantized on read, right before the attention einsum.  The writes go
into the given cache in place (the reference's ``.at[].set`` returns a new
one); the functions return the cache all the same.
"""

from __future__ import annotations

import re

import torch

__all__ = ["quantize_kv", "dequantize_kv", "init_quant_attn_cache",
           "cache_write_one_quant", "cache_read_quant",
           "kv_sensitivity", "choose_kv_cache_dtype"]


def quantize_kv(x):
    """x (..., head_dim) -> (q int8 same shape, scale (...,) float32)."""
    xf = x.float()
    s = xf.abs().amax(dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def dequantize_kv(q, s, dtype=torch.bfloat16):
    return (q.float() * s[..., None]).to(dtype)


def init_quant_attn_cache(cfg, batch, max_seq, kv_heads=None,
                          device="cuda"):
    """One layer's int8 cache (keys in sorted order, as every tree here)."""
    KV = kv_heads if kv_heads is not None else cfg.num_kv_heads
    C = max_seq if cfg.sliding_window is None else min(max_seq,
                                                       cfg.sliding_window)
    hd = cfg.head_dim_
    return {
        "k": torch.zeros((batch, C, KV, hd), dtype=torch.int8, device=device),
        "k_scale": torch.zeros((batch, C, KV), dtype=torch.float32,
                               device=device),
        "pos": torch.full((batch, C), -1, dtype=torch.int32, device=device),
        "v": torch.zeros((batch, C, KV, hd), dtype=torch.int8, device=device),
        "v_scale": torch.zeros((batch, C, KV), dtype=torch.float32,
                               device=device),
    }


def cache_write_one_quant(cache, k1, v1, pos):
    """Quantize-and-write one token in place. k1/v1 (B,1,KV,hd), pos (B,)."""
    B = pos.shape[0]
    C = cache["k"].shape[1]
    slot = (pos % C).long()
    bidx = torch.arange(B, device=pos.device)
    kq, ks = quantize_kv(k1[:, 0])
    vq, vs = quantize_kv(v1[:, 0])
    cache["k"][bidx, slot] = kq
    cache["v"][bidx, slot] = vq
    cache["k_scale"][bidx, slot] = ks
    cache["v_scale"][bidx, slot] = vs
    cache["pos"][bidx, slot] = pos.to(cache["pos"].dtype)
    return cache


def cache_read_quant(cache, dtype=torch.bfloat16):
    """The dequantized (k, v) for attention."""
    k = dequantize_kv(cache["k"], cache["k_scale"], dtype)
    v = dequantize_kv(cache["v"], cache["v_scale"], dtype)
    return k, v


# ---------------------------------------------------------------------------
# curvature-informed per-layer cache dtype policy
# ---------------------------------------------------------------------------
#
# The Hessian-diagonal spectrum (models.targets.diag_spectrum) measures how
# sharply the loss curves along each parameter -- layers whose KV projections
# (wk / wv) sit in flat curvature regions tolerate the int8 rounding error,
# while high-curvature layers amplify it into logits. The policy quantizes
# the FLATTEST layers first, up to a memory budget.

_KV_LEAF = re.compile(r"(?:^|/)(?:wk|wv)\[(\d+)\]$")


def kv_sensitivity(spectrum: dict) -> dict:
    """Per-layer curvature score of the KV projections.

    ``spectrum`` is a ``diag_spectrum`` report; every ``...wk[i]`` /
    ``...wv[i]`` entry contributes its mean_abs. Returns {layer: score}
    (mean over that layer's matching entries)."""
    acc: dict = {}
    for path, stats in spectrum.items():
        m = _KV_LEAF.search(path)
        if m is None:
            continue
        layer = int(m.group(1))
        acc.setdefault(layer, []).append(float(stats["mean_abs"]))
    return {layer: sum(v) / len(v) for layer, v in sorted(acc.items())}


def choose_kv_cache_dtype(sensitivity: dict,
                          int8_budget_frac: float = 0.5) -> dict:
    """Assign a cache dtype per layer from curvature scores.

    The ``floor(L * int8_budget_frac)`` lowest-sensitivity layers get
    "int8"; the rest keep "bfloat16". Ties break toward the lower layer
    index (deterministic policy). Empty sensitivity -> empty policy."""
    if not 0.0 <= int8_budget_frac <= 1.0:
        raise ValueError(f"int8_budget_frac={int8_budget_frac} not in [0,1]")
    layers = sorted(sensitivity)
    n_int8 = int(len(layers) * int8_budget_frac)
    quantized = set(sorted(layers, key=lambda l: (sensitivity[l], l))[:n_int8])
    return {l: ("int8" if l in quantized else "bfloat16") for l in layers}
