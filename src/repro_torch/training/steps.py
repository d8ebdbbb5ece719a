"""The train step for one device: loss -> grad -> clip -> optimizer.

Counterpart of ``repro.training.steps``.  The gradients come from
``torch.func.grad_and_value(loss_fn, has_aux=True)``.  Gradient
accumulation (microbatching) is a Python loop over the batch's leading
rows, ``accum_steps`` microbatches averaged in float32, as the reference's
``lax.scan``.

The step CONSUMES its input state: the optimizer writes the new params and
moments into the input state's tensors (``repro_torch.optim``), the
counterpart of the reference's ``donate_argnums=(0,)``, and the returned
state holds those same tensors.

What waits for the distributed slice: the ``mesh`` argument,
``grad_sync="hierarchical"`` with its compressed collectives,
``state_shardings`` and ``make_shard_map_train_step``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
from torch.func import grad_and_value
from torch.utils import _pytree as pytree

from repro_torch.core.funclock import func_locked
from repro_torch.models import model as model_lib

__all__ = ["TrainState", "make_train_step"]

_FIELDS = ("params", "opt_state", "step", "rng")


@dataclass
class TrainState:
    """``step`` is an int64 0-d tensor on the params' device; ``rng`` is an
    int seed.  The seed does not advance: SophiaH draws its probes at step
    k from ``optim.optimizers.probe_seed(rng, k)``, so a state restored at
    step k draws what the uninterrupted run drew."""
    params: Any
    opt_state: Any
    step: torch.Tensor
    rng: int


pytree.register_pytree_node(
    TrainState,
    lambda s: ([getattr(s, f) for f in _FIELDS], None),
    lambda leaves, _: TrainState(*leaves),
    flatten_with_keys_fn=lambda s: (
        [(pytree.GetAttrKey(f), getattr(s, f)) for f in _FIELDS], None),
)


def make_train_step(cfg, optimizer, *, accum_steps: int = 1,
                    loss_fn: Optional[Callable] = None):
    """Returns step(state, batch) -> (state, metrics).  ``metrics`` holds the
    loss function's metrics, ``loss`` and the optimizer's stats, as 0-d
    tensors on the device (read them with ``.item()``)."""
    loss_fn = loss_fn or (lambda p, b: model_lib.loss_fn(p, cfg, b))
    vg = func_locked(grad_and_value(loss_fn, has_aux=True))

    def compute_grads(params, batch):
        if accum_steps == 1:
            grads, (loss, metrics) = vg(params, batch)
            return loss, metrics, grads
        acc, losses, metricss = None, [], []
        for i in range(accum_steps):
            mb = pytree.tree_map(
                lambda x: x.reshape((accum_steps, x.shape[0] // accum_steps)
                                    + x.shape[1:])[i], batch)
            grads, (loss, metrics) = vg(params, mb)
            if acc is None:
                acc = pytree.tree_map(lambda g: g.float(), grads)
            else:
                pytree.tree_map(torch.Tensor.add_, acc, grads)
            losses.append(loss)
            metricss.append(metrics)
            del grads
        for g in pytree.tree_leaves(acc):
            g.div_(accum_steps)
        metrics = pytree.tree_map(lambda *ms: torch.stack(ms).mean(),
                                  *metricss)
        return torch.stack(losses).mean(), metrics, acc

    def step_fn(state: TrainState, batch):
        loss, metrics, grads = compute_grads(state.params, batch)
        new_params, new_opt, stats = optimizer.update(
            grads, state.opt_state, state.params, state.step,
            loss_fn=loss_fn, batch=batch, rng=state.rng)
        metrics = dict(metrics, loss=loss, **stats)
        return TrainState(new_params, new_opt, state.step + 1,
                          state.rng), metrics

    return step_fn
