"""GPipe-style pipeline parallelism over a "pipe" mesh axis.

Counterpart of ``repro.training.pipeline``.  Layers are split into
n_stages contiguous groups; stage s runs on the ranks whose "pipe"
coordinate is s (params stacked (n_stages, L/S, ...)).  Microbatches flow
through the classic GPipe schedule: at tick t, stage s processes
microbatch (t - s); inter-stage activations move with ONE ring
send/receive over the pipe group per tick; bubble fraction =
(S-1)/(M+S-1).

Each rank is handed the global staged tree and the global input and
returns the global output (the last stage's, summed over "pipe" as the
reference's ``psum`` does).  Gradients flow back through the schedule:
the permute and the sum are ``torch.autograd.Function``s whose backward
runs the transposed collective, and the staged params and the input enter
through one that sums their gradients over the pipe group in its
backward, so ``loss.backward()`` on every rank leaves every rank with the
global gradient of the staged tree and of x (the reference differentiates
through ``ppermute`` the same way).  Every rank runs the same ops in the
same order -- the stage-0 input and the last stage's outputs are selected
by masks, not branches -- so the collectives of the backward pair up.

``pipeline_forward`` pipelines any per-layer body of signature
body(layer_params, x) -> x, e.g. the dense block.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

__all__ = ["stack_stages", "pipeline_forward"]


def stack_stages(stacked_params, n_stages: int):
    """(L, ...) stacked layer params -> (n_stages, L//n_stages, ...)."""
    def reshape(p):
        L = p.shape[0]
        assert L % n_stages == 0, (L, n_stages)
        return p.reshape((n_stages, L // n_stages) + p.shape[1:])

    return pytree.tree_map(reshape, stacked_params)


def _ring(y, group, send_to: int, recv_from: int):
    """Send ``y`` to the global rank ``send_to`` and return what
    ``recv_from`` sent."""
    y = y.contiguous()
    out = torch.empty_like(y)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, y, send_to, group),
        dist.P2POp(dist.irecv, out, recv_from, group)])
    for r in reqs:
        r.wait()
    return out


class _Permute(torch.autograd.Function):
    """The ring permute stage s -> s + 1; its transpose sends the
    cotangent back, s + 1 -> s."""

    @staticmethod
    def forward(ctx, y, group, nxt, prv):
        ctx.ring = (group, nxt, prv)
        return _ring(y, group, nxt, prv)

    @staticmethod
    def backward(ctx, g):
        group, nxt, prv = ctx.ring
        return _ring(g, group, prv, nxt), None, None, None


class _PSum(torch.autograd.Function):
    """The sum over the pipe group of a value every rank then holds as the
    same global result: the backward passes each rank's (equal) cotangent
    through unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """Global inputs entering the pipe: identity forward; the backward
    sums each gradient over the pipe group (each rank holds only its
    stage's part), in one fixed order on every rank."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        out = []
        for g in gs:
            g = g.clone()
            dist.all_reduce(g, group=ctx.group)
            out.append(g)
        return (None, *out)


def pipeline_forward(body, staged_params, x, mesh, *, n_microbatches: int,
                     pipe_axis: str = "pipe"):
    """Run x (B, ...) through all stages with the GPipe schedule.

    body(layer_params, x_mb) -> x_mb (applied L//S times per stage). B must
    be divisible by n_microbatches. Returns (B, ...) on every rank."""
    S = mesh.shape[tuple(mesh.mesh_dim_names).index(pipe_axis)]
    M = n_microbatches
    B = x.shape[0]
    assert B % M == 0, (B, M)
    group = mesh.get_group(pipe_axis)
    ranks = dist.get_process_group_ranks(group)
    sid = mesh.get_local_rank(pipe_axis)
    nxt, prv = ranks[(sid + 1) % S], ranks[(sid - 1) % S]

    leaves, treedef = pytree.tree_flatten(staged_params)
    *leaves, x = _Enter.apply(group, *leaves, x)
    # my stage's layers, one (L/S, ...) leaf each
    sp = pytree.tree_unflatten([p[sid] for p in leaves], treedef)
    n_layers = pytree.tree_leaves(sp)[0].shape[0]
    xs = x.reshape((M, B // M) + x.shape[1:])

    def stage_apply(h):
        for l in range(n_layers):
            h = body(pytree.tree_map(lambda p: p[l], sp), h)
        return h

    first = float(sid == 0)
    inflight = torch.zeros_like(xs[0])
    outs = [torch.zeros_like(xs[0]) for _ in range(M)]
    for t in range(M + S - 1):
        x_in = first * xs[min(t, M - 1)] + (1.0 - first) * inflight
        y = stage_apply(x_in)
        # hand y to the next stage (ring permute; last -> 0 ignored)
        inflight = y if S == 1 else _Permute.apply(y, group, nxt, prv)
        out_t = t - (S - 1)
        if 0 <= out_t < M:
            outs[out_t] = y * float(sid == S - 1)
    # only the last stage holds real outputs; broadcast over the ring
    out = _PSum.apply(torch.stack(outs), group)
    return out.reshape((B,) + out.shape[2:])
