"""The LM stacks: pre-norm attention, MLP, MoE and Mamba-2 sublayers over
stacked (L, ...) layer params, in full-sequence (train / prefill) and
single-token (decode) modes, with position-tagged KV caches and SSM
states; the encoder-decoder stacks with cross-attention.

Counterpart of ``repro.models.transformer`` for every family.  The
reference scans the stacked layer leaves with ``lax.scan``; here a Python
loop reads layer ``l`` of every leaf.

Remat.  The reference wraps each layer in ``jax.checkpoint`` when
``cfg.remat`` (train and prefill).  Here, when ``cfg.remat``, ``mode ==
"train"`` and a gradient is being recorded, each layer runs as
``_Remat``, an ``autograd.Function`` whose inputs are the activation (and
the encoder's output, for a decoder layer), the positions and the layer's
param tensors: it saves only those inputs, recomputes the layer with
``torch.func.vjp`` in its backward and with ``torch.func.jvp`` for
forward mode, and lets vmap run it through ``generate_vmap_rule``, so
``torch.func.grad``, ``jvp`` of ``grad``, ``vmap`` of that and ``grad``
of ``grad`` all compose with it (``torch.utils.checkpoint`` raises under
``torch.func`` transforms: they do not support saved-tensor hooks).  A
pass that records no gradient (``jvp`` of ``jvp``, a GGN's ``jvp``)
saves nothing for a backward and runs the layers directly.  The
recompute runs the layer's ops again in the same order, collectives
included, so a layer must be deterministic.  Prefill and decode run
without autograd and write caches in place, so they never remat.

Caches and SSM states are written in place.  The reference's ``.at[].set``
returns new buffers and its decode keeps the (L, ...) cache stack in the
scan carry; here each layer writes its own view of the stacked tensors, so
a step allocates no second cache, and the state a caller passes in is the
state it gets back, changed.  An SSM state written in place is rounded to
the state's dtype (the conv states are bfloat16 by default), where the
reference returns a new tree in the compute dtype; so is the enc-dec
prefill's ``cross_kv``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.funclock import transform_levels
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (apply_rope, attention,
                                          decode_attention)
from repro_torch.models.common import gelu, layer_norm, rms_norm, silu

__all__ = ["attn_sublayer", "cross_attn_sublayer", "mlp_sublayer",
           "moe_sublayer", "ssm_sublayer", "dense_stack", "moe_stack",
           "ssm_stack", "hybrid_stack", "encoder_stack", "decoder_stack",
           "hybrid_attn_layout", "init_attn_cache", "sinusoid"]


def _norm(x, p, cfg):
    if "norm_b" in p:
        return layer_norm(x, p["norm"], p["norm_b"], cfg.norm_eps)
    return rms_norm(x, p["norm"], cfg.norm_eps)


def sinusoid(positions, d):
    """Sinusoidal position embedding (whisper stub): positions (B, S) ->
    (B, S, 2 * (d // 2)) float32, the reference's frequencies (divisor
    max(d // 2 - 1, 1))."""
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                      * (math.log(10000.0) / max(half - 1, 1)))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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


def cross_attn_sublayer(x, p, cfg, mesh, enc_out=None, cross_kv=None):
    """Pre-norm residual cross-attention: k/v from the encoder output
    ``enc_out`` (B, F, d) in train and prefill, from the precomputed
    cross cache ``cross_kv`` ({"k", "v"} (B, F, KV, hd)) in decode (one
    token).  The queries sit at position F, the keys at 0 .. F-1 (no
    mask).  Returns (x, {"k": k, "v": v})."""
    h = _norm(x, p, cfg)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if cross_kv is None:
        k = torch.einsum("bfd,dhk->bfhk", enc_out, p["wk"])
        v = torch.einsum("bfd,dhk->bfhk", enc_out, p["wv"])
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
    else:
        k, v = cross_kv["k"], cross_kv["v"]
    B, F = k.shape[0], k.shape[1]
    fpos = torch.arange(F, device=x.device)[None].expand(B, F)
    if x.shape[1] == 1:                                   # decode
        out = decode_attention(q, k, v, fpos,
                               torch.full((B,), F, dtype=torch.int32,
                                          device=x.device))
    else:
        qpos = torch.full((B, x.shape[1]), F, dtype=torch.int64,
                          device=x.device)
        out = attention(q, k, v, causal=False, q_positions=qpos,
                        kv_positions=fpos, chunk=cfg.attn_chunk)
    # a bfloat16 cross cache under float32 compute: promote as attn_sublayer
    dt = torch.promote_types(out.dtype, p["wo"].dtype)
    o = torch.einsum("bshk,hkd->bsd", out.to(dt), p["wo"].to(dt))
    return x + o, {"k": k, "v": v}


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
    "shard_map_local"`` (each data shard routes its own rows, as the
    reference's ``shard_map`` does).  Under ``"gspmd_sort"`` on a mesh
    whose data axes hold more than one rank, the rows of every data rank
    are routed together, as the reference's GSPMD step routes the global
    batch: ``moe_sharded.moe_block_global``."""
    B, S, d = x.shape
    h = _norm(x, {"norm": p["norm"]}, cfg)
    sub = {k: p[k] for k in ("router", "w_down", "w_gate", "w_up")}
    if cfg.moe_impl == "shard_map_local":
        from repro_torch.models.moe_sharded import moe_block_sharded
        y, aux = moe_block_sharded(h.reshape(B * S, d), sub, cfg, mesh)
    else:
        from repro_torch.models.moe_sharded import moe_block_global
        y, aux = moe_block_global(h.reshape(B * S, d), sub, cfg, mesh)
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
# remat
# ---------------------------------------------------------------------------

class _Remat(torch.autograd.Function):
    """``fn(*args)`` saving only ``args``: the backward recomputes ``fn``
    under ``torch.func.vjp``, forward mode under ``torch.func.jvp``, and
    vmap runs all three as written (``generate_vmap_rule``).  ``fn``
    returns a tensor or a tuple of tensors, must not write its inputs in
    place, and must capture no tensor: a tensor made inside a transform
    (positions from ``arange``) is an argument too.  Only the floating
    arguments are differentiated."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])
        ctx.save_for_forward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        args = ctx.saved_tensors
        fn, diff = _floating(ctx.fn, args)
        # torch.func.grad runs its backward with create_graph: recorded at
        # the gradient's own level, the recompute's activations would live
        # until the transform ends.  Only a second reverse level (grad of
        # grad) reads that record, so under one torch.func reverse level
        # the backward records none (plain autograd's create_graph, with
        # no level, keeps its record)
        record = torch.is_grad_enabled() and transform_levels("grad") != 1
        with torch.set_grad_enabled(record):
            _, vjp_fn = torch.func.vjp(fn, *(args[i] for i in diff))
            g = vjp_fn(grads if len(grads) > 1 else grads[0])
        out = [None] * len(args)
        for i, gi in zip(diff, g):
            out[i] = gi
        return (None, *out)

    @staticmethod
    def jvp(ctx, _fn, *tangents):
        args = ctx.saved_tensors
        fn, diff = _floating(ctx.fn, args)
        primals = tuple(args[i] for i in diff)
        tangents = tuple(torch.zeros_like(args[i]) if tangents[i] is None
                         else tangents[i] for i in diff)
        return torch.func.jvp(fn, primals, tangents)[1]


def _floating(fn, args):
    """``fn`` of the floating ``args`` alone (the rest fixed), and their
    indices."""
    diff = [i for i, a in enumerate(args) if a.is_floating_point()]

    def f(*xs):
        full = list(args)
        for i, x in zip(diff, xs):
            full[i] = x
        return fn(*full)
    return f, diff


def _run_layer(body, cfg, mode, params, *acts):
    """``body(params, *acts)``, one layer: ``params`` {group: {name:
    tensor}} (each group's names in sorted order), ``acts`` its other
    tensor inputs (activations, positions).  When ``cfg.remat`` in train
    mode, and a gradient is being recorded (a backward will read what the
    layer saves), the layer runs as ``_Remat`` over the acts and the param
    tensors, flattened group by group in key order; otherwise directly: a
    forward-mode pass (``jvp``, ``jvp`` of ``jvp``) saves nothing for a
    backward, so there is nothing to recompute.

    ``_Remat``'s jvp rule runs with forward mode off at the other levels
    (torch's autograd.Function does so), so a second forward-mode level
    around a recorded gradient would lose its tangents: that raises."""
    keys = [(g, k) for g in params for k in params[g]]
    tensors = [*acts, *(params[g][k] for g, k in keys)]
    if not (cfg.remat and mode == "train" and torch.is_grad_enabled()
            and any(t is not None and t.requires_grad for t in tensors)):
        return body(params, *acts)
    if transform_levels("jvp") > 1:
        raise NotImplementedError(
            "remat (cfg.remat) under a gradient and two or more "
            "torch.func.jvp levels; set remat=False for this transform")

    def fn(*args):
        p: dict = {}
        for (g, k), t in zip(keys, args[len(acts):]):
            p.setdefault(g, {})[k] = t
        return body(p, *args[:len(acts)])

    return _Remat.apply(fn, *tensors)


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
        cache = _layer(caches, l)

        def body(p, x, positions, cache=cache):
            x, _ = attn_sublayer(x, p["attn"], cfg, mesh, positions,
                                 cache=cache, mode=mode, window=win)
            if ffn == "mlp":
                return mlp_sublayer(x, p["mlp"], cfg, mesh)
            return moe_sublayer(x, p["moe"], cfg, mesh)

        out = _run_layer(body, cfg, mode,
                         {"attn": {k: w[l] for k, w in attn.items()},
                          ffn: {k: w[l] for k, w in sub.items()}},
                         x, positions)
        if ffn == "mlp":
            x = out
        else:
            x, a = out
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
        state = _layer(states, l)

        def body(p, x, state=state):
            return ssm_sublayer(x, p["ssm"], cfg, mesh, state=state,
                                mode=mode)[0]

        x = _run_layer(body, cfg, mode,
                       {"ssm": {k: w[l] for k, w in ssm.items()}}, x)
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
    their gradient is the sum over those uses; under remat a layer and
    the shared block's use after it are one recomputed unit).
    ``attn_caches``: the stacked (n_attn, ...) caches of the shared block's
    uses; ``states`` as ``ssm_stack``.  Returns (x, states, attn_caches,
    zero aux)."""
    is_attn, attn_idx, _ = hybrid_attn_layout(cfg)
    win = cfg.sliding_window
    ssm = _unbind(layers["ssm"])
    for l in range(cfg.num_layers):
        state = _layer(states, l)
        cache = _layer(attn_caches, int(attn_idx[l])) if is_attn[l] else None

        def body(p, x, positions, state=state, cache=cache):
            x, _ = ssm_sublayer(x, p["ssm"], cfg, mesh, state=state,
                                mode=mode)
            if "attn" in p:
                x, _ = attn_sublayer(x, p["attn"], cfg, mesh, positions,
                                     cache=cache, mode=mode, window=win)
                x = mlp_sublayer(x, p["mlp"], cfg, mesh)
            return x

        p = {"ssm": {k: w[l] for k, w in ssm.items()}}
        if is_attn[l]:
            p.update(attn=shared["attn"], mlp=shared["mlp"])
        x = _run_layer(body, cfg, mode, p, x, positions)
    return x, states, attn_caches, _zero(x)


def encoder_stack(x, layers, cfg, mesh, positions, mode="train"):
    """The whisper encoder over {"attn": ..., "mlp": ...} layers:
    non-causal self-attention without RoPE, then the GELU MLP.  ``mode``
    only decides remat (train); the encoder writes no cache."""
    attn, mlp = _unbind(layers["attn"]), _unbind(layers["mlp"])

    def body(p, x, positions):
        x, _ = attn_sublayer(x, p["attn"], cfg, mesh, positions,
                             mode="train", causal=False, rope=False)
        return mlp_sublayer(x, p["mlp"], cfg, mesh)

    for l in range(len(attn["wq"])):
        x = _run_layer(body, cfg, mode,
                       {"attn": {k: w[l] for k, w in attn.items()},
                        "mlp": {k: w[l] for k, w in mlp.items()}},
                       x, positions)
    return x


def decoder_stack(x, layers, cfg, mesh, positions, enc_out=None,
                  mode="train", caches=None, cross_kv=None):
    """The whisper decoder over {"attn", "cross", "mlp"} layers: causal
    self-attention without RoPE, cross-attention, GELU MLP.  ``enc_out``
    (B, F, d): the encoder's output (train, prefill); ``caches``: the
    stacked self-attention caches (prefill, decode); ``cross_kv``:
    {"k", "v"} stacked (L, B, F, KV, hd), written in place by prefill (in
    its dtype) and read, unchanged, by decode.  Returns (x, caches,
    cross_kv)."""
    attn, cross = _unbind(layers["attn"]), _unbind(layers["cross"])
    mlp = _unbind(layers["mlp"])
    for l in range(len(attn["wq"])):
        cache, ckv = _layer(caches, l), _layer(cross_kv, l)
        enc = enc_out
        if enc is not None and not (cfg.remat and mode == "train"):
            # one node per layer sums the layer's two uses of enc_out (wk,
            # wv) before the sum over layers, as _Remat's backward does:
            # remat on and off add the same numbers in the same order.  It
            # changes no value beyond the order of two float adds; it is
            # here so that remat on and off can be held bitwise equal
            enc = enc_out.view_as(enc_out)

        def body(p, x, enc, positions, cache=cache, ckv=ckv):
            x, _ = attn_sublayer(x, p["attn"], cfg, mesh, positions,
                                 cache=cache, mode=mode, rope=False)
            if mode == "decode":
                x, _ = cross_attn_sublayer(x, p["cross"], cfg, mesh,
                                           cross_kv=ckv)
            else:
                x, new = cross_attn_sublayer(x, p["cross"], cfg, mesh,
                                             enc_out=enc)
                if ckv is not None:                      # prefill
                    ckv["k"].copy_(new["k"])
                    ckv["v"].copy_(new["v"])
            return mlp_sublayer(x, p["mlp"], cfg, mesh)

        x = _run_layer(body, cfg, mode,
                       {"attn": {k: w[l] for k, w in attn.items()},
                        "cross": {k: w[l] for k, w in cross.items()},
                        "mlp": {k: w[l] for k, w in mlp.items()}},
                       x, enc, positions)
    return x, caches, cross_kv
