"""Top-level model API of the dense LM, train mode.

Counterpart of ``repro.models.model`` for ``family == "dense"``:

  forward(params, cfg, batch, mesh)   -> logits (B, S, V), aux loss
  loss_fn(params, cfg, batch, mesh)   -> scalar next-token xent, metrics
  make_batch(cfg, batch, seq, generator, device) -> {"tokens": (B, S)}

The parameters stay in ``cfg.param_dtype``; the forward reads a copy cast
to ``cfg.compute_dtype`` (``cast_to_compute``), so a float32 tangent tree
is cast with them.  ``mesh`` reaches ``parallel.sharding.constrain`` at
the reference's two sites (embedding, logits), which returns its input:
a mesh step runs the forward on each rank's own rows with whole params
(``training.steps``).  Every other family (MoE, SSM, hybrid, enc-dec, VLM),
prefill, decode and their caches wait for ROADMAP A.7.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.common import cast_to_compute, layer_norm, rms_norm
from repro_torch.parallel.sharding import constrain

__all__ = ["forward", "loss_fn", "cross_entropy", "make_batch"]


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            "(ROADMAP A.7, \"The LM zoo\"); the port runs dense LMs only")


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


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, batch, mesh=None):
    """(logits (B, S, V) in the compute dtype, aux loss) for a batch of
    token ids (B, S) on the params' device."""
    _dense_only(cfg)
    cparams = cast_to_compute(params, cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(cparams, tokens, mesh)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x, aux = tf.dense_stack(x, cparams["layers"], cfg, positions)
    return _head(cparams, x, cfg, mesh), aux


def cross_entropy(logits, labels):
    """Stable fp32 next-token xent. logits (B,T,V), labels (B,T)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, labels[..., None])[..., 0]
    return (lse - picked).mean()


def loss_fn(params, cfg: ModelConfig, batch, mesh=None):
    logits, aux = forward(params, cfg, batch, mesh)
    # logits position i predicts tokens[i + 1]
    loss = cross_entropy(logits[:, :-1], batch["tokens"][:, 1:])
    return loss, {"xent": loss, "aux": aux}


def make_batch(cfg: ModelConfig, batch: int, seq: int, generator=0,
               device="cuda"):
    """A synthetic batch of uniform token ids (int64, (batch, seq)) on
    ``device`` (the card unless the caller asks for the CPU), drawn from
    ``generator`` (a ``torch.Generator`` on ``device``, or an int seed)."""
    _dense_only(cfg)
    device = torch.device(device)
    if isinstance(generator, torch.Generator):
        gen = generator
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(generator))
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=device, dtype=torch.int64)
    return {"tokens": tokens}
