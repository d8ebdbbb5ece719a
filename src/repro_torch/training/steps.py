"""Train step builders: loss -> grad -> clip -> optimizer, on one device or
on a named ``torch.distributed`` DeviceMesh.

Counterpart of ``repro.training.steps``.  The gradients come from
``torch.func.grad_and_value(loss_fn, has_aux=True)``.  Gradient
accumulation (microbatching) is a Python loop over the batch's leading
rows, ``accum_steps`` microbatches averaged in float32, as the reference's
``lax.scan``.

The step CONSUMES its input state: the optimizer writes the new params and
moments into the input state's tensors (``repro_torch.optim``), the
counterpart of the reference's ``donate_argnums=(0,)``, and the returned
state holds those same tensors.

Two steps on a mesh, as in the reference:
  ``make_train_step(cfg, mesh, ...)`` -- the state at rest is DTensors
      placed by ``state_shardings`` (each rank holds its block of params
      and moments); each rank gathers the params whole, takes the loss and
      gradients of its own rows of the batch, averages them over the data
      axes, and the optimizer updates its blocks in place.  The reference
      leaves the gradient all-reduce to GSPMD; here it is one all-reduce
      over the data axes' group.
  ``make_shard_map_train_step(cfg, mesh, ...)`` -- params and moments
      replicated; gradients synced explicitly by
      ``parallel.collectives.hierarchical_grad_sync`` (full precision over
      ``data``, compressed over ``pod``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.func import grad_and_value
from torch.utils import _pytree as pytree

from repro_torch.core.distributed import _group
from repro_torch.core.funclock import func_locked
from repro_torch.models import model as model_lib
from repro_torch.models.params import flatten, param_specs, unflatten
from repro_torch.parallel.collectives import hierarchical_grad_sync
from repro_torch.parallel.sharding import (NamedSharding, batch_spec,
                                           data_axes, gather, shard_like)

__all__ = ["TrainState", "make_train_step", "state_shardings",
           "make_shard_map_train_step"]

_FIELDS = ("params", "opt_state", "step", "rng")


@dataclass
class TrainState:
    """``step`` is an int64 0-d tensor on the params' device; ``rng`` is an
    int seed.  The seed does not advance: SophiaH draws its probes at step
    k from ``optim.optimizers.probe_seed(rng, k)``, and the shard-map
    step's int8 rounding from ``sync_seed(rng, k)``, so a state restored at
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


def state_shardings(cfg, mesh, optimizer, params):
    """The ``NamedSharding`` tree of a TrainState on ``mesh``: params by
    ``param_specs``, the optimizer state mirroring them (it is a dict of
    params-shaped trees), ``step`` and ``rng`` replicated.  ``params`` is
    read for its shapes only (the optimizer state's keys come from
    ``optimizer.init`` on meta tensors)."""
    ns = unflatten({p: NamedSharding(mesh, s)
                    for p, s in flatten(param_specs(cfg, mesh)).items()})
    meta = pytree.tree_map(
        lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), params)
    opt_ns = {k: ns for k in optimizer.init(meta)}
    rep = NamedSharding(mesh, ())
    return TrainState(params=ns, opt_state=opt_ns, step=rep, rng=rep)


def _grads_fn(vg, accum_steps: int):
    """(params, batch) -> (loss, metrics, grads), the batch's rows split
    into ``accum_steps`` microbatches whose gradients are averaged."""
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
    return compute_grads


def _plain(x):
    """A replicated DTensor's value as a plain tensor; anything else as
    it is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _data_group(mesh, axes: tuple):
    """The process group over the data axes (None: the mesh has none) and
    its size."""
    if not axes:
        return None, 1
    names = tuple(mesh.mesh_dim_names)
    return _group(mesh, axes), math.prod(mesh.shape[names.index(a)]
                                         for a in axes)


def _mean_over(tree, group, size: int):
    """Each leaf summed over ``group`` (in place) and divided by its size:
    the mean over the data ranks of equal shards."""
    if group is None:
        return tree
    # once per tensor: a loss's metrics may hold the loss itself
    for x in {id(x): x for x in pytree.tree_leaves(tree)}.values():
        dist.all_reduce(x, group=group)
        x.div_(size)
    return tree


def _local_rows(batch, mesh):
    """This rank's rows of the batch: a DTensor leaf's local block, or the
    rows of a global tensor that ``batch_spec(mesh)`` gives this rank's
    data coordinate (ranks along ``model`` see the same rows)."""
    rows = NamedSharding(mesh, batch_spec(mesh))

    def local(x):
        if hasattr(x, "to_local"):
            return x.to_local()
        return x[rows.local_slices(x.shape)[:1]]
    return pytree.tree_map(local, batch)


def make_train_step(cfg, mesh, optimizer, *, grad_sync: str = "gspmd",
                    compress: str = "int8", accum_steps: int = 1,
                    loss_fn: Optional[Callable] = None):
    """Returns step(state, batch) -> (state, metrics).  ``metrics`` holds the
    loss function's metrics, ``loss`` and the optimizer's stats, as 0-d
    tensors on the device (read them with ``.item()``).

    ``mesh=None``: the single-device step.  On a mesh every rank calls the
    step with the same state (DTensors placed by ``state_shardings``; a
    plain leaf is held whole by every rank) and the same batch, either
    whole (each rank slices its rows) or as DTensors sharded by
    ``batch_spec``; the
    loss and metrics are the global batch's, on every rank.  The shards
    are equal, so the mean of the ranks' gradients is the global batch's
    gradient.  A curvature optimizer gets the global batch (gathered when
    it came sharded), so SophiaH's ``hess_batch_frac`` rows are the
    single-device step's.

    ``grad_sync`` and ``compress`` are accepted and not read, as in the
    reference, whose step leaves the gradient all-reduce to GSPMD; the
    hierarchical, compressed sync is ``make_shard_map_train_step``'s."""
    del grad_sync, compress
    # the step's loss reads this rank's rows on a mesh; the optimizer's
    # (SophiaH's curvature) reads the global batch, whole on every rank,
    # so the model gets no mesh there: a gspmd_sort MoE must not gather
    # rows that are global already
    opt_loss_fn = loss_fn or (lambda p, b: model_lib.loss_fn(p, cfg, b))
    loss_fn = loss_fn or (lambda p, b: model_lib.loss_fn(p, cfg, b, mesh))
    compute_grads = _grads_fn(
        func_locked(grad_and_value(loss_fn, has_aux=True)), accum_steps)

    if mesh is None:
        def step_fn(state: TrainState, batch):
            loss, metrics, grads = compute_grads(state.params, batch)
            new_params, new_opt, stats = optimizer.update(
                grads, state.opt_state, state.params, state.step,
                loss_fn=loss_fn, batch=batch, rng=state.rng)
            metrics = dict(metrics, loss=loss, **stats)
            return TrainState(new_params, new_opt, state.step + 1,
                              state.rng), metrics
        return step_fn

    group, n_data = _data_group(mesh, data_axes(mesh))

    def mesh_step_fn(state: TrainState, batch):
        step = _plain(state.step)
        loss, metrics, grads = compute_grads(gather(state.params),
                                             _local_rows(batch, mesh))
        with torch.no_grad():
            _mean_over([loss, *pytree.tree_leaves(metrics),
                        *pytree.tree_leaves(grads)], group, n_data)
        # each rank keeps its own block of the mean gradient
        grads = pytree.tree_map(shard_like, grads, state.params)
        new_params, new_opt, stats = optimizer.update(
            grads, state.opt_state, state.params, step,
            loss_fn=opt_loss_fn,
            batch=gather(batch) if optimizer.needs_curvature else None,
            rng=state.rng)
        metrics = dict(metrics, loss=loss,
                       **{k: _plain(v) for k, v in stats.items()})
        return TrainState(new_params, new_opt, step + 1, state.rng), metrics

    return mesh_step_fn


def sync_seed(rng: int, step) -> int:
    """The seed of the shard-map step's int8 rounding at ``step``: a pure
    function of the state's seed and step, distinct from SophiaH's
    ``probe_seed`` (which is ``rng * 1_000_003 + step``)."""
    return (int(rng) * 1_000_003 + int(step) + 2 ** 62) % (2 ** 63)


def make_shard_map_train_step(cfg, mesh, optimizer, *,
                              compress: str = "int8",
                              loss_fn: Optional[Callable] = None):
    """Explicit-collective trainer: per-rank grads + hierarchical
    compressed sync (``parallel.collectives``).  Params and optimizer
    state are replicated: every rank holds them whole (plain tensors) and
    applies the same synced update.  Each rank takes its rows of the batch
    (``batch_spec``; whole tensors or DTensors, as ``make_train_step``);
    the gradients are averaged over ``data`` in full precision, then over
    ``pod`` compressed by ``compress`` ("none", "bf16" or "int8") when the
    mesh has a pod axis.  The int8 rounding draws from a generator seeded
    with ``sync_seed(state.rng, state.step)``, the same on every rank.  The
    loss is averaged over ``data``, then ``pod``; ``metrics`` is
    ``{"loss": loss}``, as the reference's.  The optimizer sees the rank's
    own rows (the reference hands it the shard's batch)."""
    loss_fn = loss_fn or (lambda p, b: model_lib.loss_fn(p, cfg, b, None))
    vg = func_locked(grad_and_value(loss_fn, has_aux=True))
    names = tuple(mesh.mesh_dim_names)
    pod_axis = "pod" if "pod" in names else None
    size = {a: mesh.shape[names.index(a)] for a in names}

    def step_fn(state: TrainState, batch):
        step = _plain(state.step)
        local = _local_rows(batch, mesh)
        grads, (loss, _metrics) = vg(state.params, local)
        gen = torch.Generator(device=step.device).manual_seed(
            sync_seed(state.rng, step))
        grads = hierarchical_grad_sync(grads, mesh, data_axis="data",
                                       pod_axis=pod_axis, generator=gen,
                                       method=compress)
        with torch.no_grad():
            loss = loss.detach().clone()
            for axis in ("data", pod_axis):
                if axis is not None:
                    dist.all_reduce(loss, group=mesh.get_group(axis))
                    loss.div_(size[axis])
        new_params, new_opt, _stats = optimizer.update(
            grads, state.opt_state, state.params, step, loss_fn=loss_fn,
            batch=local, rng=state.rng)
        return TrainState(new_params, new_opt, step + 1,
                          state.rng), {"loss": loss}

    return step_fn
