"""Built-in engine backends: the torch.func reference oracle, the paper's
L0/L1/L2 schedules, and the mesh-sharded schedules (``sharded``,
``sharded_rows`` on a ``torch.distributed`` DeviceMesh).  Counterpart of
``repro.engine.backends``.

The CUDA kernel backend registers itself from ``repro_torch.kernels.ops``.
"""

from __future__ import annotations

import torch

from repro_torch.core import api, distributed, ref
from repro_torch.core.funclock import func_locked

from .registry import (BackendSpec, DTYPE_POLICIES, policy_compute_dtype,
                       register_backend)

_ALL = frozenset({"hvp", "hessian", "batched_hvp", "batched_hessian",
                  "batched_hvp_ragged"})


# ---------------------------------------------------------------------------
# batched_hvp_ragged: the cross-n masked row path (serving scheduler)
# ---------------------------------------------------------------------------

def _ragged_hvp_make(plan):
    """(A, V, NE) -> R for mixed-n rows padded to one (m, n_pad) bucket.

    The plan's ``ragged_family`` option carries a ``RaggedFamily`` whose
    ``masked(x, n_eff)`` equals the family objective on ``x[:n_eff]`` with
    every term past the effective prefix multiplied by an exact 0 -- so
    gradient and Hessian entries outside the prefix are exactly zero, a
    per-row forward-over-reverse sweep at the padded width is exact, and
    ``R[i, :NE[i]]`` is the per-n answer regardless of the padding values.
    csize does not apply: one jvp-of-grad sweep per row replaces the
    chunked hDual schedule.  No kernel serves this workload, in the
    reference either: it is ``torch.func.vmap`` on every device."""
    masked = plan.opt("ragged_family").masked

    def one(a, v, n_eff):
        g = torch.func.grad(lambda x: masked(x, n_eff))
        return torch.func.jvp(g, (a,), (v,))[1]

    return func_locked(torch.func.vmap(one))


def _flat_supports(plan, workload):
    # the ragged workload only makes sense for plans that opted into a
    # shape-polymorphic family; every other workload is unconditional
    if workload == "batched_hvp_ragged":
        fam = plan.opt("ragged_family")
        return fam is not None and callable(getattr(fam, "masked", None))
    return True


# ---------------------------------------------------------------------------
# reference: forward-over-forward torch.func oracle (csize-independent)
# ---------------------------------------------------------------------------

def _reference_make(plan, workload):
    f = plan.f
    if workload == "hvp":
        return lambda a, v: ref.hvp_fwdfwd(f, a, v)
    if workload == "hessian":
        return lambda a: ref.hessian_fwdfwd(f, a)
    if workload == "batched_hvp":
        return func_locked(
            torch.func.vmap(lambda a, v: ref.hvp_fwdfwd(f, a, v)))
    if workload == "batched_hessian":
        return func_locked(
            torch.func.vmap(lambda a: ref.hessian_fwdfwd(f, a)))
    if workload == "batched_hvp_ragged":
        return _ragged_hvp_make(plan)
    raise KeyError(workload)


register_backend(BackendSpec(
    name="reference", make=_reference_make, workloads=_ALL, priority=0,
    supports=_flat_supports,
    doc="jacfwd-over-jacfwd oracle (correctness anchor, n^2 tangent work)"))


# ---------------------------------------------------------------------------
# vmap_l0 / vmap_l1 / vmap_l2: the paper's GPU schedules as batched programs
# ---------------------------------------------------------------------------

def _vmap_make(level):
    def make(plan, workload):
        f, c, sym = plan.f, plan.csize, plan.symmetric
        # the hDual sweeps run in cd while accumulation stays in the input
        # dtype; None = exact
        cd = policy_compute_dtype(plan.opt("dtype_policy", "fp32"))
        if workload == "hvp":
            return lambda a, v: api.hvp_impl(f, a, v, c, sym,
                                             compute_dtype=cd)
        if workload == "hessian":
            return lambda a: api.hessian_impl(f, a, c, sym, compute_dtype=cd)
        if workload == "batched_hvp":
            return lambda A, V: api.batched_hvp_impl(f, A, V, c, level, sym,
                                                     compute_dtype=cd)
        if workload == "batched_hessian":
            return lambda A: api._batched_hessian_impl(f, A, c, sym, cd)
        if workload == "batched_hvp_ragged":
            # the masked cross-n row path is level-independent (no chunk
            # schedule); registering it on every vmap level keeps plans
            # with a pinned vmap backend coalescible across n
            return _ragged_hvp_make(plan)
        raise KeyError(workload)
    return make


for _level, _prio, _doc in (
        ("L0", 5, "thread-per-instance; rows+chunks sequential (Alg. 9)"),
        ("L1", 10, "thread-per-(instance,row); chunks sequential (Alg. 10)"),
        ("L2", 20, "fully batched rows x chunks + segment reduce (Fig. 2)")):
    register_backend(BackendSpec(
        name=f"vmap_{_level.lower()}", make=_vmap_make(_level),
        workloads=_ALL, priority=_prio, doc=_doc, supports=_flat_supports,
        dtype_policies=frozenset(DTYPE_POLICIES)))


# ---------------------------------------------------------------------------
# sharded: instances over the mesh data axes (production batched path)
# ---------------------------------------------------------------------------

def _sharded_make(plan, workload):
    mesh, f = plan.mesh, plan.f
    level = plan.opt("level", "L2")
    axes = plan.opt("data_axes", ("data",))

    def run(A, V):
        return distributed.distributed_batched_hvp(
            mesh, f, A, V, csize=plan.csize, level=level,
            symmetric=plan.symmetric, data_axes=axes)
    return run


# no supports() veto on m-divisibility: a plan that carries a mesh asked
# for sharding, so an indivisible batch must fail loudly (ValueError)
# rather than silently fall back to an unsharded schedule at the paper's
# 0.5M-instance scale
register_backend(BackendSpec(
    name="sharded", make=_sharded_make, workloads=frozenset({"batched_hvp"}),
    priority=30, requires_mesh=True,
    doc="instances split over the mesh data axes, blocks all-gathered "
        "(L0 distribution)"))


# ---------------------------------------------------------------------------
# sharded_rows: L1 row sharding of a single HVP / Hessian over the model axis
# ---------------------------------------------------------------------------

def _sharded_rows_make(plan, workload):
    mesh, f = plan.mesh, plan.f
    axis = plan.opt("model_axis", "model")
    # "cyclic" (default) = the snake row-block deal with the below-diagonal
    # triangle DROPPED from the per-shard cell enumeration; "block" keeps
    # the evaluated-and-masked contiguous layout as a parity baseline
    layout = plan.opt("row_layout", "cyclic")

    if workload == "hvp":
        def run(a, v):
            return distributed.distributed_hvp_rows(
                mesh, f, a, v, csize=plan.csize, model_axis=axis,
                symmetric=plan.symmetric, row_layout=layout)
        return run
    if workload == "hessian":
        def run_h(a):
            return distributed.distributed_hessian_rows(
                mesh, f, a, csize=plan.csize, model_axis=axis,
                symmetric=plan.symmetric, row_layout=layout)
        return run_h
    raise KeyError(workload)


def _sharded_rows_supports(plan, workload):
    # row sharding distributes over ONE named model axis; a mesh without it
    # (e.g. a pure data mesh) has no row axis to map L1 onto, so the plan
    # falls through to the single-device backends.  Any n >= 1 is served:
    # ragged row/chunk tails are masked in-shard.
    mesh = plan.mesh
    return mesh is not None and plan.opt("model_axis", "model") in tuple(
        mesh.mesh_dim_names or ())


register_backend(BackendSpec(
    name="sharded_rows", make=_sharded_rows_make,
    workloads=frozenset({"hvp", "hessian"}),
    priority=30, requires_mesh=True, supports=_sharded_rows_supports,
    doc="Hessian rows of a single HVP/Hessian split over the model axis "
        "(L1 distribution; ragged + symmetric schedules)"))
