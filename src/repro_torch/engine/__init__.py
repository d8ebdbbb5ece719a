"""repro_torch.engine -- the CurvatureEngine (plan/execute), on PyTorch.

Counterpart of ``repro.engine``, flat single-device workloads::

    from repro_torch import engine

    p = engine.plan(f, n, csize="auto", device="cuda")
    r  = p.hvp(a, v)              # single HVP
    H  = p.hessian(a)             # dense Hessian
    R  = p.batched_hvp(A, V)      # m instances
    r2 = p.execute(a, v)          # shape-dispatched single entry point
    fut = p.submit(a, v)          # coalesced by the CurvatureService

Planning decisions:
  csize   : "auto" -> paper §5 scalar-op model argmin, or an explicit int.
  backend : "auto" -> topology, then registry priority (the hand-written
            CUDA kernel ``cuda`` wins ``batched_hvp`` on a CUDA plan whose f
            has a device form; ``vmap_l2`` elsewhere); or any registered
            name -- reference | vmap_l0 | vmap_l1 | vmap_l2 | cuda.
  device  : "cuda" by default; planning raises when no CUDA device is
            present unless ``device="cpu"`` is passed.

Serving: ``CurvatureService`` coalesces single-point requests into
power-of-two micro-batches on the plans' devices (admission, scheduler and
dispatch layers in ``repro_torch.serving``); ``RaggedFamily`` plans also
coalesce across n.  Every executed bucket is recorded
(``execution_stats``, ``bucket_telemetry``, ``client_stats``).
"""

from .plan import (CurvaturePlan, plan, clear_cache, trace_count,
                   cache_size, bucket_size, pad_rows, pad_cols,
                   RaggedFamily)
from .registry import (BackendSpec, register_backend, get_backend,
                       list_backends, resolve_backend, WORKLOADS,
                       DTYPE_POLICIES, policy_compute_dtype,
                       record_execution, execution_stats, clear_telemetry,
                       bucket_telemetry, client_stats)
from .opmodel import (model_csize, csize_candidates,
                      pruned_csize_candidates, mults_chunk_hess,
                      mults_schunk_hess, exact_mults,
                      suggest_dispatch_knobs, ragged_padding_waste)
from .pytree import PytreeSpec, spec_of
from .service import (CurvatureService, ServiceClosed, ServiceQueueFull,
                      ServiceOverloaded, AdmissionController, ClientPolicy,
                      get_service, configure_service, shutdown_service)

__all__ = [
    "CurvaturePlan", "plan", "clear_cache", "trace_count", "cache_size",
    "bucket_size", "pad_rows", "pad_cols", "RaggedFamily",
    "BackendSpec", "register_backend", "get_backend", "list_backends",
    "resolve_backend", "WORKLOADS", "DTYPE_POLICIES", "policy_compute_dtype",
    "record_execution", "execution_stats", "clear_telemetry",
    "bucket_telemetry", "client_stats",
    "model_csize", "csize_candidates", "pruned_csize_candidates",
    "mults_chunk_hess", "mults_schunk_hess", "exact_mults",
    "suggest_dispatch_knobs", "ragged_padding_waste",
    "PytreeSpec", "spec_of",
    "CurvatureService", "ServiceClosed", "ServiceQueueFull",
    "ServiceOverloaded", "AdmissionController", "ClientPolicy",
    "get_service", "configure_service", "shutdown_service",
]
