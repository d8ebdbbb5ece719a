"""Collective helpers: hierarchical gradient sync + int8/bf16 compression.

Counterpart of ``repro.parallel.collectives``, on the process groups of a
named ``torch.distributed`` DeviceMesh.  On the multi-pod mesh the gradient
all-reduce is hierarchical: a full-precision reduce inside a pod (the fast
links), a COMPRESSED all-reduce across pods (the slow ones).
``compressed_psum`` quantizes to int8 with stochastic rounding (unbiased)
or truncates to bf16 before the cross-pod sum and rescales after -- 4x / 2x
less traffic across pods per step.

The reference runs these inside ``shard_map`` with an axis name; here every
rank calls them with the mesh and the mesh dim's name, and the sum runs on
that dim's process group.  The stochastic rounding draws from an explicit
``torch.Generator`` where the reference takes a PRNG key.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum",
           "hierarchical_grad_sync"]


def _stochastic_int8(y, generator):
    """y rounded down or up at random, up with probability y - floor(y),
    then clipped to int8's symmetric range."""
    lo = torch.floor(y)
    up = torch.rand(y.shape, generator=generator, device=y.device) < (y - lo)
    return (lo + up.to(y.dtype)).clamp_(-127, 127).to(torch.int8)


def quantize_int8(x, generator=None):
    """Stochastic-rounding int8 quantization. Returns (q, scale).

    Unbiased: E[dequant(quant(x))] = x, so compressed gradient sync keeps
    SGD convergence guarantees (at slightly higher variance)."""
    xf = x.float()
    scale = xf.abs().max() / 127.0 + 1e-30
    return _stochastic_int8(xf / scale, generator), scale


def dequantize_int8(q, scale):
    return q.float() * scale


def compressed_psum(x, mesh, axis_name: str, generator=None,
                    method: str = "int8"):
    """The sum of ``x`` over the mesh dim ``axis_name``, compressed on the
    wire: "none" (x's dtype), "bf16", or "int8" (one scale shared by the
    group, its max, then the int8 payloads summed as int32)."""
    group = mesh.get_group(axis_name)
    if method == "none":
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out
    if method == "bf16":
        out = x.to(torch.bfloat16)
        dist.all_reduce(out, group=group)
        return out.to(x.dtype)
    if method == "int8":
        if generator is None:
            raise ValueError("compressed_psum: method='int8' needs a "
                             "generator for its stochastic rounding")
        xf = x.float()
        smax = xf.abs().max() / 127.0 + 1e-30
        dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
        # int8 wire payload; widen to int32 for the reduction arithmetic
        tot = _stochastic_int8(xf / smax, generator).to(torch.int32)
        dist.all_reduce(tot, group=group)
        return tot.float() * smax
    raise ValueError(f"compressed_psum: unknown method {method!r}")


def hierarchical_grad_sync(grads, mesh, *, data_axis="data", pod_axis=None,
                           generator=None, method="int8"):
    """Mean-reduce a gradient tree: a full-precision sum over ``data_axis``
    (intra-pod), then a compressed sum over ``pod_axis`` (cross-pod), each
    divided by its dim's size.  Every rank calls it with its own
    gradients; the int8 rounding draws leaf by leaf from ``generator``."""
    group = mesh.get_group(data_axis)
    n_data = dist.get_world_size(group)

    def mean(g):
        g = g.clone()
        dist.all_reduce(g, group=group)
        return g / n_data

    grads = pytree.tree_map(mean, grads)
    if pod_axis is None:
        return grads
    n_pod = dist.get_world_size(mesh.get_group(pod_axis))
    return pytree.tree_map(
        lambda g: compressed_psum(g, mesh, pod_axis, generator, method)
        / n_pod, grads)
