"""Backend registry for the CurvatureEngine.

Counterpart of ``repro.engine.registry``.  A *backend* is a named strategy
for executing one or more curvature workloads: a factory
``make(plan, workload) -> callable`` plus a capability declaration.  The
planner's ``backend="auto"`` selection and the callable cache pick it up.

Workloads (positional tensor signatures of the produced callable):

  "hvp"             (a, v)   -> r          single instance, flat vectors
  "hessian"         (a,)     -> H          dense Hessian, flat vector
  "batched_hvp"     (A, V)   -> R          m instances, (m, n) tensors
  "batched_hessian" (A,)     -> Hs         (m, n) -> (m, n, n)

``backend="auto"`` decides by topology (a mesh-carrying plan narrows to the
mesh-native backends), then by priority.  The reference's learned history
(autotune winners, execution telemetry) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

__all__ = [
    "BackendSpec", "register_backend", "get_backend", "list_backends",
    "resolve_backend", "WORKLOADS", "DTYPE_POLICIES", "policy_compute_dtype",
]

WORKLOADS = ("hvp", "hessian", "batched_hvp", "batched_hessian")

# dual-number dtype policies: "fp32" runs the hDual sweeps in the input
# dtype (default), "bf16" casts the seed point so every tangent component is
# bfloat16 while accumulation stays in the input dtype, "fp64" widens.
DTYPE_POLICIES = ("fp32", "bf16", "fp64")


def policy_compute_dtype(policy: str):
    """The compute dtype a policy casts tangent sweeps to (None = keep the
    input dtype, i.e. the "fp32" default on fp32 inputs)."""
    if policy in (None, "fp32"):
        return None
    if policy == "bf16":
        return torch.bfloat16
    if policy == "fp64":
        return torch.float64
    raise ValueError(
        f"unknown dtype_policy {policy!r}; expected one of {DTYPE_POLICIES}")


@dataclass(frozen=True)
class BackendSpec:
    """One executable strategy in the registry.

    make(plan, workload) returns the callable for the workload; the planner
    counts and caches it.  ``supports`` may veto a (plan, workload)
    combination that the static declaration alone cannot rule out (device,
    csize, the form of f)."""
    name: str
    make: Callable
    workloads: frozenset
    priority: int = 0
    requires_mesh: bool = False
    flat_only: bool = True
    supports: Optional[Callable] = None
    doc: str = ""
    dtype_policies: frozenset = frozenset({"fp32"})

    def can_run(self, plan, workload: str) -> bool:
        if workload not in self.workloads:
            return False
        if self.requires_mesh and plan.mesh is None:
            return False
        if self.flat_only and plan.n is None:
            return False
        if plan.opt("dtype_policy", "fp32") not in self.dtype_policies:
            return False
        if self.supports is not None and not self.supports(plan, workload):
            return False
        return True


_REGISTRY: dict[str, BackendSpec] = {}
_ENSURED = False


def register_backend(spec: BackendSpec) -> BackendSpec:
    """Idempotent by name: re-registration replaces (supports reload)."""
    _REGISTRY[spec.name] = spec
    return spec


def _ensure_builtin_backends() -> None:
    """Import the modules that self-register backends.  No import is
    optional: importing ``kernels.ops`` builds and loads nothing (the CUDA
    kernel is built at its first launch), so a failure here is a bug."""
    global _ENSURED
    if _ENSURED:
        return
    import repro_torch.engine.backends  # noqa: F401  (reference / vmap)
    import repro_torch.kernels.ops  # noqa: F401  (cuda)
    _ENSURED = True


def get_backend(name: str) -> BackendSpec:
    _ensure_builtin_backends()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def list_backends() -> dict[str, BackendSpec]:
    _ensure_builtin_backends()
    return dict(_REGISTRY)


def resolve_backend(plan, workload: str) -> BackendSpec:
    """Pick the backend for a (plan, workload) pair.

    Explicit names are honored (error if incapable).  "auto" resolution is
    topology-aware first: a mesh-carrying plan narrows the candidates to the
    mesh-native backends when any is capable; then the highest priority
    wins (ties by name)."""
    _ensure_builtin_backends()
    if plan.backend != "auto":
        spec = get_backend(plan.backend)
        if not spec.can_run(plan, workload):
            raise ValueError(
                f"backend {spec.name!r} cannot run workload {workload!r} "
                f"for plan {plan.describe()}")
        return spec
    candidates = [s for s in _REGISTRY.values() if s.can_run(plan, workload)]
    if not candidates:
        raise ValueError(
            f"no registered backend supports workload {workload!r} for "
            f"plan {plan.describe()}; registered: {sorted(_REGISTRY)}")
    if plan.mesh is not None:
        mesh_native = [s for s in candidates if s.requires_mesh]
        if mesh_native:
            candidates = mesh_native
    return max(candidates, key=lambda s: (s.priority, s.name))
