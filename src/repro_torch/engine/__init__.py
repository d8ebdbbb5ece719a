"""repro_torch.engine -- the CurvatureEngine (plan/execute), on PyTorch.

Counterpart of ``repro.engine``, flat single-device workloads::

    from repro_torch import engine

    p = engine.plan(f, n, csize="auto", device="cuda")
    r  = p.hvp(a, v)              # single HVP
    H  = p.hessian(a)             # dense Hessian
    R  = p.batched_hvp(A, V)      # m instances
    r2 = p.execute(a, v)          # shape-dispatched single entry point

Planning decisions:
  csize   : "auto" -> paper §5 scalar-op model argmin, or an explicit int.
  backend : "auto" -> topology, then registry priority (the hand-written
            CUDA kernel ``cuda`` wins ``batched_hvp`` on a CUDA plan whose f
            has a device form; ``vmap_l2`` elsewhere); or any registered
            name -- reference | vmap_l0 | vmap_l1 | vmap_l2 | cuda.
  device  : "cuda" by default; planning raises when no CUDA device is
            present unless ``device="cpu"`` is passed.
"""

from .plan import (CurvaturePlan, plan, clear_cache, trace_count,
                   cache_size, bucket_size, pad_rows, pad_cols)
from .registry import (BackendSpec, register_backend, get_backend,
                       list_backends, resolve_backend, WORKLOADS,
                       DTYPE_POLICIES, policy_compute_dtype)
from .opmodel import (model_csize, csize_candidates,
                      pruned_csize_candidates, mults_chunk_hess,
                      mults_schunk_hess, exact_mults)

__all__ = [
    "CurvaturePlan", "plan", "clear_cache", "trace_count", "cache_size",
    "bucket_size", "pad_rows", "pad_cols",
    "BackendSpec", "register_backend", "get_backend", "list_backends",
    "resolve_backend", "WORKLOADS", "DTYPE_POLICIES", "policy_compute_dtype",
    "model_csize", "csize_candidates", "pruned_csize_candidates",
    "mults_chunk_hess", "mults_schunk_hess", "exact_mults",
]
