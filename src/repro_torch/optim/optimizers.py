"""Optimizers on parameter pytrees (dicts of tensors).

Counterpart of ``repro.optim.optimizers``.  AdamW is the throughput
baseline; SophiaH is the CHESSFAD integration point: its diagonal-Hessian
preconditioner is estimated by chunked Hutchinson HVP probes
(``repro_torch.core.curvature.hutchinson_diag``).

``update(grads, state, params, step, **ctx)`` returns ``(new_params,
new_state, stats)`` as the reference's does, but it updates IN PLACE: the
new values are written into ``state``'s and ``params``' tensors under
``torch.no_grad()``, and the returned trees are those same objects.  This
is the port's counterpart of the reference step's ``donate_argnums=(0,)``:
a full-width step holds one copy of params and of each moment, not two.
The gradients are clipped in place too.  The leaves are updated one at a
time, so the temporaries of an update are those of one leaf.

On a mesh (``training.steps.make_train_step(cfg, mesh, ...)``) params,
moments and gradients are DTensors, each rank holding its block: the
elementwise math runs on the blocks and the global norm reduces over the
mesh, as DTensor's ops do.  SophiaH's estimate gathers the params whole,
runs on the global batch it is given, and folds each rank's block of the
estimate into its ``h``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.curvature import hutchinson_diag
from repro_torch.parallel.sharding import gather, shard_like

__all__ = ["Optimizer", "adamw", "sophia_h", "OPTIMIZERS", "global_norm",
           "clip_by_global_norm", "probe_seed"]

_leaves = pytree.tree_leaves


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in _leaves(tree)))


def _clip_scale(norm, max_norm):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm):
    """(tree scaled to global norm <= max_norm, the norm before): a new
    tree, each leaf in its own dtype."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return pytree.tree_map(lambda g: (g * scale).to(g.dtype), tree), norm


def _clip_(tree, max_norm):
    """``clip_by_global_norm`` in place; returns the norm before."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    for g in _leaves(tree):
        g.mul_(scale)
    return norm


def _fold_(moments, grads, b):
    """moments <- b * moments + (1 - b) * grads, leaf by leaf, in place."""
    for m, g in zip(_leaves(moments), _leaves(grads)):
        m.mul_(b).add_(g.float(), alpha=1 - b)


def _set_(p, value):
    """Write ``value`` (float32) into the parameter ``p`` in its dtype."""
    if value is not p:
        p.copy_(value)


@dataclass(frozen=True)
class Optimizer:
    """init(params) -> state; update(grads, state, params, step, **ctx) ->
    (new_params, new_state, stats), in place (module docstring).  ``ctx``
    may carry loss_fn/batch/rng for curvature-aware optimizers."""
    name: str
    init: Callable
    update: Callable
    needs_curvature: bool = False


def _zeros(params):
    return pytree.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params)


def adamw(lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          clip_norm: Optional[float] = 1.0) -> Optimizer:
    def init(params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def update(grads, state, params, step, **ctx):
        with torch.no_grad():
            gnorm = torch.zeros(())
            if clip_norm is not None:
                gnorm = _clip_(grads, clip_norm)
            t = torch.as_tensor(step, dtype=torch.float32) + 1.0
            bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
            lr = lr_fn(step)
            for p, g, m, v in zip(_leaves(params), _leaves(grads),
                                  _leaves(state["m"]), _leaves(state["v"])):
                g = g.float()
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                del g
                pf = p.float()
                # m_hat / (sqrt(v_hat) + eps) + wd * p, then p - lr * that
                u = torch.div(v, bc2).sqrt_().add_(eps)
                u = torch.div(m, bc1).div_(u).add_(pf, alpha=weight_decay)
                _set_(p, pf.sub_(u.mul_(lr)))
                del u, pf   # before the next leaf's temporaries
        return params, state, {"grad_norm": gnorm, "lr": lr}

    return Optimizer("adamw", init, update)


def probe_seed(rng: int, step) -> int:
    """SophiaH's probe seed at ``step`` for the state seed ``rng``:
    ``(rng * 1_000_003 + step) mod 2**63``.  A pure function of the two, so
    a run resumed from a checkpoint at step k draws step k's probes."""
    return (int(rng) * 1_000_003 + int(step)) % (2 ** 63)


def sophia_h(lr_fn, b1=0.96, b2=0.99, rho=0.03, weight_decay=0.1,
             clip_norm: Optional[float] = 1.0, hess_every: int = 10,
             n_probes: int = 4, csize: int = 4,
             hess_batch_frac: float = 1.0) -> Optimizer:
    """Sophia-H (Liu et al. 2023) with CHESSFAD-chunked Hutchinson curvature.

    Every ``hess_every`` steps (a Python test of the step), diag(H) is
    re-estimated with ``n_probes`` Rademacher probes evaluated ``csize`` at
    a time through one shared linearization
    (``core.curvature.hutchinson_diag``; ``csize`` must divide
    ``n_probes``).  The probes come from the int seed
    ``probe_seed(rng, step)``, where ``rng`` is the ``rng=`` the caller
    passes (the train state's seed).  The update is the clipped-Newton step
    p -= lr * (clip(m / max(rho * h, 1e-12), -1, 1) + wd * p).

    ``hess_batch_frac``: curvature probes run on the leading
    ``max(1, int(B * frac))`` rows of the batch (diag(H) is an expectation
    -- a sub-batch estimate is unbiased); this bounds the HVPs' activation
    memory and FLOPs.

    Memory: ``update`` consumes its gradients.  Once they are clipped and
    folded into ``m`` it releases their storage (each leaf becomes an
    empty tensor), before the estimate, whatever references the caller
    keeps: at full width they would hold a parameter-sized tree beside the
    HVPs.
    """
    def init(params):
        return {"m": _zeros(params), "h": _zeros(params)}

    def fresh_h(h, params, loss_fn, batch, seed):
        hbatch = batch
        if hess_batch_frac < 1.0 and batch is not None:
            hbatch = pytree.tree_map(
                lambda x: x[: max(1, int(x.shape[0] * hess_batch_frac))],
                batch)

        def scalar_loss(p):
            out = loss_fn(p, hbatch)
            return out[0] if isinstance(out, tuple) else out

        # hutchinson_diag holds core.funclock.FUNC_LOCK for the estimate
        est = hutchinson_diag(scalar_loss, gather(params), seed,
                              n_probes=n_probes, csize=csize)
        with torch.no_grad():
            for hh, e in zip(_leaves(h), _leaves(est)):
                e = shard_like(e.float().clamp_(min=0.0), hh)
                hh.mul_(b2).add_(e, alpha=1 - b2)

    def update(grads, state, params, step, *, loss_fn=None, batch=None,
               rng=None, **ctx):
        # batch may be None when loss_fn closes over its data
        if loss_fn is None or rng is None:
            raise ValueError("sophia_h.update needs loss_fn= and rng=")
        with torch.no_grad():
            gnorm = torch.zeros(())
            if clip_norm is not None:
                gnorm = _clip_(grads, clip_norm)
            _fold_(state["m"], grads, b1)
            for g in _leaves(grads):
                # consumed: storage released (a DTensor's local block)
                (g.to_local() if hasattr(g, "to_local") else g).set_()
        del grads
        if hess_every == 1 or int(step) % hess_every == 0:
            fresh_h(state["h"], params, loss_fn, batch,
                    probe_seed(rng, step))
        lr = lr_fn(step)
        with torch.no_grad():
            for p, m, hh in zip(_leaves(params), _leaves(state["m"]),
                                _leaves(state["h"])):
                pf = p.float()
                u = torch.mul(hh, rho).clamp_(min=1e-12)
                u = torch.div(m, u).clamp_(-1.0, 1.0)
                u.add_(pf, alpha=weight_decay)
                _set_(p, pf.sub_(u.mul_(lr)))
                del u, pf
        return params, state, {"grad_norm": gnorm, "lr": lr}

    return Optimizer("sophia_h", init, update, needs_curvature=True)


OPTIMIZERS = {"adamw": adamw, "sophia_h": sophia_h}
