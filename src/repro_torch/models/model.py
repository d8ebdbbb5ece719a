"""Top-level model API of the LMs: train, prefill and decode.

Counterpart of ``repro.models.model`` for every family of the zoo:

  forward(params, cfg, batch, mesh, mode, state, positions)
                                      -> logits (B, S, V), aux loss, state'
  loss_fn(params, cfg, batch, mesh)   -> scalar next-token xent, metrics
  init_decode_state(cfg, batch, max_seq, dtype, device) -> decode state
  prefill / decode_step               -> serving steps
  decode_state_logical(cfg, state)    -> logical axes per state leaf
  make_batch(cfg, batch, seq, generator, device)
                                      -> {"tokens"[, "frames" | "patches"]}

The modality frontends are stubs, as in the reference: ``frames``
(audio, whisper) and ``patches`` (VLM) arrive as precomputed d_model
embeddings (B, F, d) and pass through the learned ``frontend_adapter``.
The VLM prepends its patches to the token embeddings and runs the dense
stack; its logits at position F + i predict token i + 1.  The enc-dec
family runs the encoder on the frames (sinusoidal positions, a final
layer norm) and the decoder on the tokens.

The parameters stay in ``cfg.param_dtype``; the forward reads a copy cast
to ``cfg.compute_dtype`` (``cast_to_compute``, on every call, decode steps
included, as the reference's jitted step does), so a float32 tangent tree
is cast with them.  ``mesh`` reaches ``parallel.sharding.constrain`` at
the reference's two sites (embedding, logits), which returns its input:
a mesh step runs the forward on each rank's own rows with whole params
(``training.steps``).

The decode state, every leaf stacked (n, B, ...):
  dense, moe, vlm: {"layer_caches": {k, pos, v[, k_scale, v_scale]}}
                                                             (n = L);
  encdec:     {"cross_kv": {k, v} (L, B, F, KV, hd), "layer_caches": ...};
  ssm:        {"layer_states": {conv_B, conv_C, conv_x, ssm}} (n = L);
  hybrid:     {"attn_caches": ... (n = the shared block's uses),
               "layer_states": ... (n = L)}.
``prefill`` and ``decode_step`` write it in place and return it (the
reference returns a new tree): keep a ``clone`` of a state you want to
read again.  The enc-dec prefill writes ``cross_kv`` in the state's
dtype, where the reference returns it in the compute dtype: a bfloat16
state rounds it.  The MoE loss adds ``MOE_AUX_COEF`` times the
load-balancing loss.  ``input_specs`` and ``batch_logical`` wait for
``launch/dryrun.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf
from repro_torch.models.common import (DTYPES, cast_to_compute,
                                       layer_norm, rms_norm)
from repro_torch.parallel.sharding import constrain

__all__ = ["forward", "loss_fn", "cross_entropy", "prefill", "decode_step",
           "init_decode_state", "decode_state_logical", "make_batch",
           "MOE_AUX_COEF", "frontend_offset"]

MOE_AUX_COEF = 0.01


def frontend_offset(cfg: ModelConfig) -> int:
    """Positions before the tokens' in the logits: the VLM's F patches."""
    return cfg.frontend_len if cfg.frontend == "vlm" else 0


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def _embed(params, tokens, mesh):
    x = F.embedding(tokens, params["embed"])
    return constrain(x, mesh, "batch", None, None)


def _head(params, x, cfg, mesh):
    if "final_norm_b" in params:
        x = layer_norm(x, params["final_norm"], params["final_norm_b"],
                       cfg.norm_eps)
    else:
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = torch.einsum("bsd,dv->bsv", x, w)
    return constrain(logits, mesh, "batch", None, "vocab")


def _frontend(params, batch, cfg, mode):
    """The adapted frontend embeddings (B, F, d) in the compute dtype, or
    None (no frontend, decode, or none in the batch)."""
    key = "frames" if cfg.frontend == "audio" else "patches"
    if cfg.frontend is None or mode == "decode" or key not in batch:
        return None
    emb = batch[key].to(DTYPES[cfg.compute_dtype])
    return torch.einsum("bfd,de->bfe", emb, params["frontend_adapter"])


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, batch, mesh=None, mode="train",
            state=None, positions=None):
    """(logits (B, S, V) in the compute dtype, aux loss, new state) for a
    batch of token ids (B, S) on the params' device (with ``frames`` /
    ``patches`` (B, F, d) for the enc-dec / VLM families; a VLM's S counts
    its F patches before the tokens).  ``mode`` is "train", "prefill" or
    "decode"; ``state`` the decode state (None in train mode, and then so
    is the new state); ``positions`` (B, S) absolute positions,
    ``arange(S)`` by default."""
    cparams = cast_to_compute(params, cfg)
    if cfg.family == "encdec":
        return _forward_encdec(cparams, cfg, batch, mesh, mode, state,
                               positions)
    tokens = batch["tokens"]
    x = _embed(cparams, tokens, mesh)
    front = _frontend(cparams, batch, cfg, mode)
    if front is not None:
        x = torch.cat([front, x], dim=1)
    B, S = x.shape[:2]
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    lay = cparams["layers"]
    if cfg.family in ("dense", "vlm", "moe"):
        stack = tf.moe_stack if cfg.family == "moe" else tf.dense_stack
        x, _, aux = stack(x, lay, cfg, mesh, positions, mode,
                          None if state is None else state["layer_caches"])
    elif cfg.family == "ssm":
        x, _, aux = tf.ssm_stack(
            x, lay, cfg, mesh, positions, mode,
            None if state is None else state["layer_states"])
    elif cfg.family == "hybrid":
        x, _, _, aux = tf.hybrid_stack(
            x, lay, cparams["shared"], cfg, mesh, positions, mode,
            None if state is None else state["layer_states"],
            None if state is None else state["attn_caches"])
    else:
        raise ValueError(cfg.family)
    return _head(cparams, x, cfg, mesh), aux, state


def _forward_encdec(cparams, cfg, batch, mesh, mode, state, positions):
    """Whisper: the encoder over the adapted frames in train and prefill
    (prefill writes the decoder's cross cache in place), the decoder over
    the tokens; decode reads the cross cache."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    enc_out = None
    if mode in ("train", "prefill"):
        front = _frontend(cparams, batch, cfg, mode)
        if front is None:
            raise ValueError(f"{cfg.name}: {mode} needs the batch's "
                             "'frames' (B, F, d_model)")
        F = front.shape[1]
        fpos = torch.arange(F, device=front.device)[None].expand(B, F)
        enc_in = front + tf.sinusoid(fpos, cfg.d_model).to(front.dtype)
        enc_out = tf.encoder_stack(enc_in, cparams["encoder"]["layers"],
                                   cfg, mesh, fpos, mode)
        enc_out = layer_norm(enc_out, cparams["encoder"]["norm"],
                             cparams["encoder"]["norm_b"], cfg.norm_eps)
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = _embed(cparams, tokens, mesh)
    x = x + tf.sinusoid(positions, cfg.d_model).to(x.dtype)
    x, _, _ = tf.decoder_stack(
        x, cparams["layers"], cfg, mesh, positions, enc_out=enc_out,
        mode=mode, caches=None if state is None else state["layer_caches"],
        cross_kv=None if state is None else state["cross_kv"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(cparams, x, cfg, mesh), aux, state


def cross_entropy(logits, labels):
    """Stable fp32 next-token xent. logits (B,T,V), labels (B,T)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, labels[..., None])[..., 0]
    return (lse - picked).mean()


def loss_fn(params, cfg: ModelConfig, batch, mesh=None):
    logits, aux, _ = forward(params, cfg, batch, mesh, mode="train")
    off, S = frontend_offset(cfg), batch["tokens"].shape[1]
    # logits position off + i predicts tokens[i + 1]
    loss = cross_entropy(logits[:, off:off + S - 1], batch["tokens"][:, 1:])
    metrics = {"xent": loss, "aux": aux}
    if cfg.family == "moe":
        loss = loss + MOE_AUX_COEF * aux
    return loss, metrics


# ---------------------------------------------------------------------------
# decode state
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device="cuda"):
    """The empty decode state on ``device`` (the card unless the caller
    asks for the CPU): one ``transformer.init_attn_cache`` per attention
    layer (k/v in ``dtype``, int8 with float32 scales when
    ``cfg.kv_cache_dtype == "int8"``; pos int32, -1 everywhere) and one
    ``ssm.init_ssm_state`` per SSM layer (conv states in ``dtype``, the
    SSM state float32), each stacked (n, ...); the enc-dec family's
    ``cross_kv`` k / v (L, B, F, KV, hd) in ``dtype``, zeros."""

    def stacked(one, n):
        return {k: c[None].repeat((n,) + (1,) * c.dim())
                for k, c in one.items()}

    L = cfg.num_layers
    if cfg.family in ("dense", "vlm", "moe"):
        return {"layer_caches": stacked(tf.init_attn_cache(
            cfg, batch, max_seq, dtype=dtype, device=device), L)}
    if cfg.family == "encdec":
        shape = (L, batch, cfg.frontend_len, cfg.num_kv_heads,
                 cfg.head_dim_)
        return {"cross_kv": {n: torch.zeros(shape, dtype=dtype,
                                            device=device)
                             for n in ("k", "v")},
                "layer_caches": stacked(tf.init_attn_cache(
                    cfg, batch, max_seq, dtype=dtype, device=device), L)}
    states = stacked(ssm_mod.init_ssm_state(cfg, batch, dtype, device), L)
    if cfg.family == "ssm":
        return {"layer_states": states}
    _, _, n_attn = tf.hybrid_attn_layout(cfg)
    return {"attn_caches": stacked(tf.init_attn_cache(
                cfg, batch, max_seq, dtype=dtype, device=device), n_attn),
            "layer_states": states}


def decode_state_logical(cfg, state):
    """Logical sharding axes for every decode-state leaf (by path), the
    same tree of tuples as the reference's.

    With cfg.shard_cache_seq the cache SEQUENCE dim is sharded over the
    model axis (flash-decoding style); otherwise k/v shard their kv_heads
    dim; the SSM state shards its heads, the x conv state its channels."""
    def rule(name, leaf):
        ax = [None] * leaf.dim()
        ax[1] = "batch"                       # all leaves: (stack, B, ...)
        if name in ("k", "v", "k_scale", "v_scale"):
            if cfg.shard_cache_seq:
                ax[2] = "kv_seq"
            elif name in ("k", "v"):
                ax[3] = "kv_heads"
        elif name == "pos" and cfg.shard_cache_seq:
            ax[2] = "kv_seq"
        elif name == "ssm":
            ax[2] = "ssm_heads"
        elif name.startswith("conv_x"):
            ax[3] = "ffn"
        return tuple(ax)

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return rule(name, tree)

    return walk(state, "")


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------

def prefill(params, cfg, batch, state, mesh=None):
    """Full-sequence prefill writing the caches of ``state`` in place.
    Returns (last logits (B, V), state)."""
    logits, _, new_state = forward(params, cfg, batch, mesh, mode="prefill",
                                   state=state)
    return logits[:, -1], new_state


def decode_step(params, cfg, tokens, pos, state, mesh=None):
    """One decode step. tokens (B, 1) int, pos (B,) int absolute position.
    Writes the new token's k/v and SSM states into ``state`` in place.
    Returns (logits (B, V), state)."""
    positions = pos[:, None]
    logits, _, new_state = forward(params, cfg, {"tokens": tokens}, mesh,
                                   mode="decode", state=state,
                                   positions=positions)
    return logits[:, 0], new_state


# ---------------------------------------------------------------------------
# synthetic batches
# ---------------------------------------------------------------------------

def make_batch(cfg: ModelConfig, batch: int, seq: int, generator=0,
               device="cuda"):
    """A synthetic batch on ``device`` (the card unless the caller asks
    for the CPU), drawn from ``generator`` (a ``torch.Generator`` on
    ``device``, or an int seed): uniform token ids (int64, (batch, seq));
    a VLM's ``seq`` counts its ``frontend_len`` patches, so it gets seq - F
    tokens and ``patches`` (batch, F, d) standard normal float32; whisper
    gets seq tokens and ``frames`` (batch, F, d)."""
    device = torch.device(device)
    if isinstance(generator, torch.Generator):
        gen = generator
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(generator))
    n_tok = seq - frontend_offset(cfg)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, n_tok),
                                   generator=gen, device=device,
                                   dtype=torch.int64)}
    if cfg.frontend is not None:
        key = "frames" if cfg.frontend == "audio" else "patches"
        out[key] = torch.randn((batch, cfg.frontend_len, cfg.d_model),
                               generator=gen, device=device)
    return out
