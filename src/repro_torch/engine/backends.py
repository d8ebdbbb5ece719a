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

_ALL = frozenset({"hvp", "hessian", "batched_hvp", "batched_hessian"})


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
    raise KeyError(workload)


register_backend(BackendSpec(
    name="reference", make=_reference_make, workloads=_ALL, priority=0,
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
        raise KeyError(workload)
    return make


for _level, _prio, _doc in (
        ("L0", 5, "thread-per-instance; rows+chunks sequential (Alg. 9)"),
        ("L1", 10, "thread-per-(instance,row); chunks sequential (Alg. 10)"),
        ("L2", 20, "fully batched rows x chunks + segment reduce (Fig. 2)")):
    register_backend(BackendSpec(
        name=f"vmap_{_level.lower()}", make=_vmap_make(_level),
        workloads=_ALL, priority=_prio, doc=_doc,
        dtype_policies=frozenset(DTYPE_POLICIES)))
