"""The dense transformer stack in train mode: pre-norm attention and MLP
sublayers over stacked (L, ...) layer params.

Counterpart of the dense half of ``repro.models.transformer``.  The
reference scans the stacked layer leaves with ``lax.scan`` under
``jax.checkpoint``; here a Python loop reads layer ``l`` of every leaf,
and there is no remat: ``torch.utils.checkpoint`` does not compose with
the ``torch.func`` transforms the curvature engine applies, so every
layer's activations stay live for the backward sweep.  KV caches, decode,
MoE, SSM, hybrid and encoder-decoder stacks wait for ROADMAP A.7.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import apply_rope, attention
from repro_torch.models.common import gelu, layer_norm, rms_norm, silu

__all__ = ["attn_sublayer", "mlp_sublayer", "dense_stack"]


def _norm(x, p, cfg):
    if "norm_b" in p:
        return layer_norm(x, p["norm"], p["norm_b"], cfg.norm_eps)
    return rms_norm(x, p["norm"], cfg.norm_eps)


def _qkv(h, p):
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def attn_sublayer(x, p, cfg, positions, *, causal=True, window=None,
                  rope=True):
    """Pre-norm residual attention (train mode: no cache)."""
    h = _norm(x, p, cfg)
    q, k, v = _qkv(h, p)
    theta = cfg.rope_theta if rope else 0.0
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    if cfg.gqa_repeat_kv and k.shape[2] < q.shape[2]:
        # expand KV -> H heads (the reference's sharding knob; the same
        # values as the grouped path)
        G = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    out = attention(q, k, v, causal=causal, window=window,
                    q_positions=positions, kv_positions=positions,
                    chunk=cfg.attn_chunk, softcap=cfg.attn_logit_softcap)
    return x + torch.einsum("bshk,hkd->bsd", out, p["wo"])


def mlp_sublayer(x, p, cfg):
    h = _norm(x, p, cfg)
    if "w1" in p:                                    # GELU (whisper)
        h = gelu(torch.einsum("bsd,df->bsf", h, p["w1"]) + p["b1"])
        o = torch.einsum("bsf,fd->bsd", h, p["w2"]) + p["b2"]
    else:                                            # SwiGLU
        g = torch.einsum("bsd,df->bsf", h, p["w_gate"])
        u = torch.einsum("bsd,df->bsf", h, p["w_up"])
        o = torch.einsum("bsf,fd->bsd", silu(g) * u, p["w_down"])
    return x + o


def dense_stack(x, layers, cfg, positions):
    """x (B, S, d) through every layer of the stacked ``layers`` dict
    ({"attn": {...}, "mlp": {...}}, each leaf (L, ...)).  Returns
    (x, aux) with aux the reference's zero auxiliary loss."""
    # unbind, not w[l]: the backward of L unbinds is ONE stack per leaf,
    # where L indexings would each scatter into a zero tensor of the whole
    # stacked leaf
    attn = {k: w.unbind(0) for k, w in layers["attn"].items()}
    mlp = {k: w.unbind(0) for k, w in layers["mlp"].items()}
    win = cfg.sliding_window
    for l in range(len(attn["wq"])):
        x = attn_sublayer(x, {k: w[l] for k, w in attn.items()}, cfg,
                          positions, window=win)
        x = mlp_sublayer(x, {k: w[l] for k, w in mlp.items()}, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)
