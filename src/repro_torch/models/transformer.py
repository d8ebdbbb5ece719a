"""The LM stacks: pre-norm attention, MLP, MoE and Mamba-2 sublayers over
stacked (L, ...) layer params, in full-sequence (train / prefill) and
single-token (decode) modes, with position-tagged KV caches and SSM
states.

Counterpart of ``repro.models.transformer`` for the dense, MoE, SSM and
hybrid families.  The reference scans the stacked layer leaves with
``lax.scan`` under ``jax.checkpoint``; here a Python loop reads layer
``l`` of every leaf, and there is no remat: ``torch.utils.checkpoint``
does not compose with the ``torch.func`` transforms the curvature engine
applies, so every layer's activations stay live for the backward sweep.

Caches and SSM states are written in place.  The reference's ``.at[].set``
returns new buffers and its decode keeps the (L, ...) cache stack in the
scan carry; here each layer writes its own view of the stacked tensors, so
a step allocates no second cache, and the state a caller passes in is the
state it gets back, changed.  An SSM state written in place is rounded to
the state's dtype (the conv states are bfloat16 by default), where the
reference returns a new tree in the compute dtype.  The encoder-decoder
stacks wait for ROADMAP A.7.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (apply_rope, attention,
                                          decode_attention)
from repro_torch.models.common import gelu, layer_norm, rms_norm, silu
from repro_torch.models.moe import moe_block

__all__ = ["attn_sublayer", "mlp_sublayer", "moe_sublayer", "ssm_sublayer",
           "dense_stack", "moe_stack", "ssm_stack", "hybrid_stack",
           "hybrid_attn_layout", "init_attn_cache"]


def _norm(x, p, cfg):
    if "norm_b" in p:
        return layer_norm(x, p["norm"], p["norm_b"], cfg.norm_eps)
    return rms_norm(x, p["norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def init_attn_cache(cfg, batch, max_seq, kv_heads=None, dtype=torch.bfloat16,
                    device="cuda"):
    """One layer's KV cache: k/v (B, C, KV, hd) in ``dtype`` and pos (B, C)
    int32 filled with -1.  SWA uses a ring buffer of window slots (C =
    min(max_seq, window)); ``cfg.kv_cache_dtype == "int8"`` gives the
    quantized cache."""
    if cfg.kv_cache_dtype == "int8":
        from repro_torch.models.kv_quant import init_quant_attn_cache
        return init_quant_attn_cache(cfg, batch, max_seq, kv_heads, device)
    KV = kv_heads if kv_heads is not None else cfg.num_kv_heads
    C = max_seq if cfg.sliding_window is None else min(max_seq,
                                                       cfg.sliding_window)
    hd = cfg.head_dim_
    return {
        "k": torch.zeros((batch, C, KV, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, C), -1, dtype=torch.int32, device=device),
        "v": torch.zeros((batch, C, KV, hd), dtype=dtype, device=device),
    }


def _cache_write_full(cache, k, v, positions):
    """Write a full prefill sequence (positions (B, S)) into the cache."""
    B, S = positions.shape
    C = cache["k"].shape[1]
    if S > C:                       # SWA ring: only the last C tokens survive
        # (truncating first keeps the slots distinct, so the scatter below
        # is well defined)
        k, v, positions = k[:, -C:], v[:, -C:], positions[:, -C:]
    slots = (positions % C).long()
    bidx = torch.arange(B, device=positions.device)[:, None]
    if "k_scale" in cache:          # int8 quantized cache
        from repro_torch.models.kv_quant import quantize_kv
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        cache["k"][bidx, slots] = kq
        cache["v"][bidx, slots] = vq
        cache["k_scale"][bidx, slots] = ks
        cache["v_scale"][bidx, slots] = vs
    else:
        cache["k"][bidx, slots] = k.to(cache["k"].dtype)
        cache["v"][bidx, slots] = v.to(cache["v"].dtype)
    cache["pos"][bidx, slots] = positions.to(cache["pos"].dtype)
    return cache


def _cache_write_one(cache, k1, v1, pos):
    """Write one token (k1/v1 (B, 1, KV, hd), pos (B,))."""
    B = pos.shape[0]
    C = cache["k"].shape[1]
    slot = (pos % C).long()
    bidx = torch.arange(B, device=pos.device)
    cache["k"][bidx, slot] = k1[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v1[:, 0].to(cache["v"].dtype)
    cache["pos"][bidx, slot] = pos.to(cache["pos"].dtype)
    return cache


def _qkv(h, p):
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


# ---------------------------------------------------------------------------
# sublayers
# ---------------------------------------------------------------------------

def attn_sublayer(x, p, cfg, mesh, positions, *, cache=None, mode="train",
                  causal=True, window=None, rope=True):
    """Pre-norm residual attention.  Returns (x, new_cache): the cache
    written in place in prefill and decode, ``cache`` as given in train
    mode.  ``mesh`` is the reference's argument (its sharding hints are
    not needed here)."""
    h = _norm(x, p, cfg)
    q, k, v = _qkv(h, p)
    theta = cfg.rope_theta if rope else 0.0
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)

    k_cache, v_cache = k, v          # caches always hold KV (not H) heads
    if cfg.gqa_repeat_kv and mode != "decode" and k.shape[2] < q.shape[2]:
        # expand KV -> H heads (the reference's sharding knob; the same
        # values as the grouped path)
        G = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)

    new_cache = cache
    if mode == "decode":
        if "k_scale" in cache:                            # int8 cache
            from repro_torch.models.kv_quant import (cache_read_quant,
                                                     cache_write_one_quant)
            new_cache = cache_write_one_quant(cache, k, v, positions[:, 0])
            kc, vc = cache_read_quant(new_cache, k.dtype)
        else:
            new_cache = _cache_write_one(cache, k, v, positions[:, 0])
            kc, vc = new_cache["k"], new_cache["v"]
        out = decode_attention(q, kc, vc, new_cache["pos"], positions[:, 0],
                               window=window, softcap=cfg.attn_logit_softcap)
    else:
        out = attention(q, k, v, causal=causal, window=window,
                        q_positions=positions, kv_positions=positions,
                        chunk=cfg.attn_chunk, softcap=cfg.attn_logit_softcap)
        if mode == "prefill" and cache is not None:
            new_cache = _cache_write_full(cache, k_cache, v_cache, positions)

    # the reference's einsum promotes mixed operands (a bfloat16 cache read
    # under float32 compute gives a bfloat16 ``out``); torch's does not
    dt = torch.promote_types(out.dtype, p["wo"].dtype)
    o = torch.einsum("bshk,hkd->bsd", out.to(dt), p["wo"].to(dt))
    return x + o, new_cache


def mlp_sublayer(x, p, cfg, mesh=None):
    h = _norm(x, p, cfg)
    if "w1" in p:                                    # GELU (whisper)
        h = gelu(torch.einsum("bsd,df->bsf", h, p["w1"]) + p["b1"])
        o = torch.einsum("bsf,fd->bsd", h, p["w2"]) + p["b2"]
    else:                                            # SwiGLU
        g = torch.einsum("bsd,df->bsf", h, p["w_gate"])
        u = torch.einsum("bsd,df->bsf", h, p["w_up"])
        o = torch.einsum("bsf,fd->bsd", silu(g) * u, p["w_down"])
    return x + o


def moe_sublayer(x, p, cfg, mesh):
    """Pre-norm residual MoE.  Returns (x, aux loss); routed to
    ``moe_sharded.moe_block_sharded`` when ``cfg.moe_impl ==
    "shard_map_local"``."""
    B, S, d = x.shape
    h = _norm(x, {"norm": p["norm"]}, cfg)
    sub = {k: p[k] for k in ("router", "w_down", "w_gate", "w_up")}
    if cfg.moe_impl == "shard_map_local":
        from repro_torch.models.moe_sharded import moe_block_sharded
        y, aux = moe_block_sharded(h.reshape(B * S, d), sub, cfg, mesh)
    else:
        y, aux = moe_block(h.reshape(B * S, d), sub, cfg, mesh)
    return x + y.reshape(B, S, d), aux


def ssm_sublayer(x, p, cfg, mesh, *, state=None, mode="train"):
    """Pre-norm residual Mamba-2 block.  Returns (x, state): in prefill
    and decode the new SSM and conv states are written into ``state`` (one
    layer's views) in place; in train mode ``state`` is None."""
    h = _norm(x, {"norm": p["norm_in"]}, cfg)
    if mode == "decode":
        y, new = ssm_mod.ssm_decode_step(h, p, cfg, state)
    else:
        init = None if state is None else state["ssm"]
        conv = (None if state is None else
                {"x": state["conv_x"], "B": state["conv_B"],
                 "C": state["conv_C"]})
        y, (s, cs) = ssm_mod.ssm_forward(h, p, cfg, init, conv)
        new = {"conv_B": cs["B"], "conv_C": cs["C"], "conv_x": cs["x"],
               "ssm": s}
    if state is not None:
        for k, t in new.items():
            state[k].copy_(t)
    return x + y, state


# ---------------------------------------------------------------------------
# the stacks
# ---------------------------------------------------------------------------

def _unbind(tree):
    """Each leaf of a stacked (L, ...) dict as a tuple of its L layers.
    unbind, not w[l]: the backward of L unbinds is ONE stack per leaf,
    where L indexings would each scatter into a zero tensor of the whole
    stacked leaf."""
    return {k: w.unbind(0) for k, w in tree.items()}


def _layer(tree, l):
    return None if tree is None else {k: c[l] for k, c in tree.items()}


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _attn_stack(x, layers, ffn, cfg, mesh, positions, mode, caches):
    """Attention + ``ffn`` ("mlp" or "moe") per layer; (x, caches, the
    sum of the layers' aux losses)."""
    attn, sub = _unbind(layers["attn"]), _unbind(layers[ffn])
    win = cfg.sliding_window
    aux = _zero(x)
    for l in range(len(attn["wq"])):
        x, _ = attn_sublayer(x, {k: w[l] for k, w in attn.items()}, cfg,
                             mesh, positions, cache=_layer(caches, l),
                             mode=mode, window=win)
        p = {k: w[l] for k, w in sub.items()}
        if ffn == "mlp":
            x = mlp_sublayer(x, p, cfg, mesh)
        else:
            x, a = moe_sublayer(x, p, cfg, mesh)
            aux = aux + a
    return x, caches, aux


def dense_stack(x, layers, cfg, mesh, positions, mode="train", caches=None):
    """x (B, S, d) through every layer of the stacked ``layers`` dict
    ({"attn": {...}, "mlp": {...}}, each leaf (L, ...)).  ``caches``: the
    stacked (L, ...) cache dict or None.  Returns (x, new_caches, aux) with
    aux the reference's zero auxiliary loss; in prefill and decode layer l
    writes its view ``c[l]`` of each stacked cache tensor in place, and
    ``new_caches`` is ``caches``."""
    x, caches, _ = _attn_stack(x, layers, "mlp", cfg, mesh, positions, mode,
                               caches)
    return x, caches, _zero(x)


def moe_stack(x, layers, cfg, mesh, positions, mode="train", caches=None):
    """As ``dense_stack`` over {"attn": ..., "moe": ...} layers.  The aux
    loss is the mean over layers in train and prefill, zero in decode (as
    the reference's)."""
    x, caches, aux = _attn_stack(x, layers, "moe", cfg, mesh, positions,
                                 mode, caches)
    if mode == "decode" and caches is not None:
        return x, caches, _zero(x)
    return x, caches, aux / cfg.num_layers


def ssm_stack(x, layers, cfg, mesh, positions, mode="train", states=None):
    """Mamba-2 layers over {"ssm": ...}; ``states`` the stacked (L, ...)
    SSM states (prefill / decode, written in place) or None (train).
    Returns (x, states, zero aux)."""
    ssm = _unbind(layers["ssm"])
    for l in range(len(ssm["w_out"])):
        x, _ = ssm_sublayer(x, {k: w[l] for k, w in ssm.items()}, cfg,
                            mesh, state=_layer(states, l), mode=mode)
    return x, states, _zero(x)


def hybrid_attn_layout(cfg):
    """(is_attn (L,), attn_idx (L,), n_attn) -- which layers get the shared
    attention block (every attn_every-th, Zamba2-style)."""
    L, k = cfg.num_layers, cfg.attn_every
    is_attn = np.zeros((L,), bool)
    if k:
        is_attn[k - 1::k] = True
    attn_idx = np.cumsum(is_attn) - 1
    attn_idx = np.where(is_attn, attn_idx, 0).astype(np.int32)
    return is_attn, attn_idx, int(is_attn.sum())


def hybrid_stack(x, layers, shared, cfg, mesh, positions, mode="train",
                 states=None, attn_caches=None):
    """Mamba-2 layers and ONE shared attention + MLP block applied after
    every ``attn_every``-th layer (its params used once per such layer, so
    their gradient is the sum over those uses).  ``attn_caches``: the
    stacked (n_attn, ...) caches of the shared block's uses; ``states``
    as ``ssm_stack``.  Returns (x, states, attn_caches, zero aux)."""
    is_attn, attn_idx, _ = hybrid_attn_layout(cfg)
    win = cfg.sliding_window
    ssm = _unbind(layers["ssm"])
    for l in range(cfg.num_layers):
        x, _ = ssm_sublayer(x, {k: w[l] for k, w in ssm.items()}, cfg,
                            mesh, state=_layer(states, l), mode=mode)
        if is_attn[l]:
            x, _ = attn_sublayer(x, shared["attn"], cfg, mesh, positions,
                                 cache=_layer(attn_caches, int(attn_idx[l])),
                                 mode=mode, window=win)
            x = mlp_sublayer(x, shared["mlp"], cfg, mesh)
    return x, states, attn_caches, _zero(x)
