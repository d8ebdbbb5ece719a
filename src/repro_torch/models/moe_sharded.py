"""Expert-parallel MoE with LOCAL dispatch on a ``torch.distributed``
DeviceMesh.

Counterpart of ``repro.models.moe_sharded``.  Each rank holds its own
rows of the tokens (the rows a mesh train step hands it, split over the
data axes) and the whole parameter tree.  It routes ALL of its rows, but
builds the dispatch buffer and runs the experts ONLY for the E / model
experts of its ``model`` coordinate; one all-reduce over the model group
sums the ranks' partial outputs:

  wire per rank per layer = 2 * T_loc * d (the forward sum and, in the
  backward, the sums below), against the whole (E, C, d) buffer.

The reference's ``shard_map`` differentiates through its ``psum`` with
the cotangent passed through unscaled, and gets every parameter's
gradient whole from XLA.  Here each rank differentiates its own graph, so
the gradient of every input that only a rank's own experts see is summed
over the model group in the backward, and every rank ends with the whole
gradient of its rows' loss:

  * the output sum (``_Reduce``): all-reduce forward, cotangent passed
    through unchanged;
  * the tokens and the router probabilities on the gate path
    (``_FromModel``): identity forward, all-reduce backward; the aux
    loss's path to the router stays local (every rank computes it whole);
  * the expert weights (``_OwnExperts``): a rank slices its own experts,
    and the backward all-gathers the slices' gradients into the whole
    tensor.

The aux loss is each rank's Switch loss of its own rows, averaged over
the data axes (the reference's ``pmean``), its gradient passed through.
Falls back to ``moe.moe_block`` when there is no mesh, no ``model`` axis,
or the experts do not divide it (granite-3b's 40 on a 16-wide axis).

``moe_block_global`` is the ``"gspmd_sort"`` block on a mesh: the
reference's GSPMD step routes the global batch (its argsort runs over all
T tokens of the jitted global array), so each rank all-gathers the data
ranks' rows (``_GatherRows``), routes, dispatches and combines the whole
batch, as every other data rank does, and keeps its own rows of the
output.  Capacity and the aux loss are the global batch's.  The gather's
backward sums the ranks' cotangents and keeps this rank's rows (a
reduce-scatter), so that the mean over the data ranks of their gradients
is the global batch's gradient.  The aux loss is the same on every data
rank, so the mean over the ranks of their losses counts it once; its
gradient too: each rank's cotangent of the gathered rows holds the whole
aux term's, the sum over the n ranks makes that n times it, and the mean
divides by n.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.distributed import _group
from repro_torch.models.moe import (capacity, dispatch_combine, moe_block,
                                    router_probs, switch_aux, topk_gates)
from repro_torch.parallel.sharding import data_axes, mesh_axis_size

__all__ = ["moe_block_sharded", "moe_block_global"]


class _Reduce(torch.autograd.Function):
    """``scale`` times the sum over ``group`` of a value every rank then
    holds; the backward passes each rank's (equal) cotangent through
    unchanged, as the reference's ``psum`` / ``pmean`` transpose under
    ``shard_map``."""

    @staticmethod
    def forward(x, group, scale):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out * scale if scale != 1 else out

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _FromModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``
    (each rank holds the part its own experts saw)."""

    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _OwnExperts(torch.autograd.Function):
    """Rows e0 .. e0 + E_loc - 1 of an (E, ...) expert weight; the
    backward all-gathers every rank's slice gradient (in model order) into
    the whole tensor's."""

    @staticmethod
    def forward(w, group, e0, E_loc):
        return w[e0:e0 + E_loc]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        parts = [torch.empty_like(g)
                 for _ in range(dist.get_world_size(ctx.group))]
        dist.all_gather(parts, g, group=ctx.group)
        return torch.cat(parts, 0), None, None, None


class _GatherRows(torch.autograd.Function):
    """Every rank's rows of ``group``, concatenated in group-rank order;
    the backward sums the cotangents over ``group`` and returns this
    rank's rows of the sum (an all-reduce then a slice: gloo has no
    reduce-scatter)."""

    @staticmethod
    def forward(x, group):
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, 0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.rows = inputs[1], inputs[0].shape[0]

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        r = dist.get_rank(ctx.group) * ctx.rows
        return g[r:r + ctx.rows], None


def moe_block_global(x2d, params, cfg, mesh):
    """Drop-in for ``moe.moe_block`` under ``"gspmd_sort"``: x2d (T_loc,
    d) this rank's rows -> ((T_loc, d), the global batch's aux), routed
    with the rows of every rank of the data axes.  ``moe_block`` itself
    when there is no mesh or its data axes hold one rank."""
    daxes = (() if mesh is None or isinstance(mesh, dict)
             else data_axes(mesh))
    if not daxes or mesh_axis_size(mesh, daxes) == 1:
        return moe_block(x2d, params, cfg, mesh)
    group = _group(mesh, daxes)
    y, aux = moe_block(_GatherRows.apply(x2d, group), params, cfg, mesh)
    r = dist.get_rank(group) * x2d.shape[0]
    return y[r:r + x2d.shape[0]], aux


def moe_block_sharded(x2d, params, cfg, mesh):
    """Drop-in for ``moe.moe_block`` with ``cfg.moe_impl ==
    "shard_map_local"``: x2d (T_loc, d) this rank's rows -> ((T_loc, d),
    aux)."""
    if (mesh is None or isinstance(mesh, dict)
            or "model" not in tuple(mesh.mesh_dim_names)
            or cfg.num_experts % mesh_axis_size(mesh, "model") != 0):
        return moe_block(x2d, params, cfg, mesh)

    group = mesh.get_group("model")
    E_loc = cfg.num_experts // mesh_axis_size(mesh, "model")
    e0 = mesh.get_local_rank("model") * E_loc

    probs = router_probs(x2d, params["router"])
    gates, idx = topk_gates(_FromModel.apply(probs, group),
                            cfg.experts_per_token)
    aux = switch_aux(probs, idx)
    w = [_OwnExperts.apply(params[n], group, e0, E_loc)
         for n in ("w_gate", "w_up", "w_down")]
    y_partial = dispatch_combine(_FromModel.apply(x2d, group), gates, idx,
                                 *w, capacity(x2d.shape[0], cfg), e0)
    y = _Reduce.apply(y_partial, group, 1)   # the forward's ONE collective
    daxes = data_axes(mesh)
    if daxes:
        aux = _Reduce.apply(aux, _group(mesh, daxes),
                            1.0 / mesh_axis_size(mesh, daxes))
    return y, aux
