"""Curvature targets for LMs: the objective splits the engine needs.

Counterpart of ``repro.models.targets``.  The GGN/Fisher workloads
decompose the LM objective as ``loss(params) = head_loss(model_fn(params))``:

  model_fn   params -> next-token logits, sliced to the label positions
  head_loss  logits -> scalar fp32 cross-entropy (convex in the logits --
             the property the GGN curvature ``J^T H_head J`` relies on)
  per_example  params -> (B,) per-sequence xent, for the empirical Fisher
             ``(1/B) J_L^T J_L``

For the dense family ``loss(p) == head_loss(model_fn(p))`` exactly (same
forward, same slice, same reduction).

``diag_spectrum`` turns a Hessian-diagonal tree into a flat per-leaf
report (stacked ``layers/`` leaves split per layer row).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models.model import cross_entropy, forward, loss_fn
from repro_torch.models.params import flatten

__all__ = ["CurvatureTarget", "lm_curvature_targets", "diag_spectrum"]


@dataclass(frozen=True)
class CurvatureTarget:
    """The four callables a curvature plan over one (cfg, batch) needs."""
    loss: Callable[[Any], Any]            # params -> scalar (full objective)
    model_fn: Callable[[Any], Any]        # params -> sliced logits
    head_loss: Callable[[Any], Any]       # logits -> scalar xent
    per_example_fn: Callable[[Any], Any]  # params -> (B,) per-sequence xent

    def plan_options(self) -> dict:
        """The extra options ``engine.plan`` needs so pytree_fwdrev can
        serve ggn / fisher alongside hvp / diag."""
        return {"model_fn": self.model_fn, "head_loss": self.head_loss,
                "per_example_fn": self.per_example_fn}


def lm_curvature_targets(cfg, batch) -> CurvatureTarget:
    """The loss split for one config and one materialized batch (a
    ``model.make_batch``-style dict on the params' device); the callables
    close over it (the batch is data, not a differentiation variable)."""
    labels = batch["tokens"][:, 1:]

    def model_fn(params):
        logits, _ = forward(params, cfg, batch)
        return logits[:, :-1]          # position i predicts tokens[i + 1]

    def head_loss(lg):
        return cross_entropy(lg, labels)

    def loss(params):
        return loss_fn(params, cfg, batch)[0]

    def per_example(params):
        lf = model_fn(params).float()
        lse = torch.logsumexp(lf, dim=-1)
        picked = torch.gather(lf, -1, labels[..., None])[..., 0]
        return (lse - picked).mean(dim=1)          # (B,)

    return CurvatureTarget(loss=loss, model_fn=model_fn, head_loss=head_loss,
                           per_example_fn=per_example)


# ---------------------------------------------------------------------------
# Hessian-diagonal spectrum report
# ---------------------------------------------------------------------------

_STACKED_PREFIXES = ("layers/", "encoder/layers/")


def _leaf_stats(arr) -> dict:
    a = np.abs(np.asarray(arr, np.float64))
    return {"mean_abs": float(a.mean()), "rms": float(np.sqrt((a * a).mean())),
            "max_abs": float(a.max()), "size": int(a.size)}


def _host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().double().numpy()
    return np.asarray(leaf)


def diag_spectrum(diag_tree) -> dict:
    """Per-leaf curvature statistics of a Hessian/GGN-diagonal tree.

    Returns {path: {mean_abs, rms, max_abs, size}}.  Leaves under a stacked
    layer prefix are split into one entry per layer, named ``path[i]``."""
    out = {}
    for path, leaf in sorted(flatten(diag_tree).items()):
        arr = _host(leaf)
        if path.startswith(_STACKED_PREFIXES) and arr.ndim >= 1:
            for i in range(arr.shape[0]):
                out[f"{path}[{i}]"] = _leaf_stats(arr[i])
        else:
            out[path] = _leaf_stats(arr)
    return out
