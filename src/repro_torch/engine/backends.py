"""Built-in engine backends: the torch.func reference oracle and the paper's
L0/L1/L2 schedules.  Counterpart of ``repro.engine.backends`` (its flat
single-device part).

The CUDA kernel backend registers itself from ``repro_torch.kernels.ops``.
"""

from __future__ import annotations

import torch

from repro_torch.core import api, ref

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

    return torch.func.vmap(one)


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
        return torch.func.vmap(lambda a, v: ref.hvp_fwdfwd(f, a, v))
    if workload == "batched_hessian":
        return torch.func.vmap(lambda a: ref.hessian_fwdfwd(f, a))
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
