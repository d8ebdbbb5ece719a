"""repro_torch.engine -- the CurvatureEngine (plan/execute), on PyTorch.

Counterpart of ``repro.engine``::

    from repro_torch import engine

    p = engine.plan(f, n, csize="auto", device="cuda")
    r  = p.hvp(a, v)              # single HVP
    H  = p.hessian(a)             # dense Hessian
    R  = p.batched_hvp(A, V)      # m instances
    r2 = p.execute(a, v)          # shape-dispatched single entry point
    fut = p.submit(a, v)          # coalesced by the CurvatureService

    q = engine.plan(loss, None, device="cuda", n_probes=4)  # pytree plan
    hv = q.hvp(params, v_tree)    # also q.ggn / q.fisher / q.quadform
    d  = q.diag(params, seed)     # Hutchinson diag (probes from the seed)

    mesh = launch.mesh.make_test_mesh((1, 1), ("data", "model"))
    s = engine.plan(f, n, mesh=mesh)   # a torch.distributed DeviceMesh
    R = s.batched_hvp(A, V)       # sharded: instances over "data"
    r = s.hvp(a, v)               # sharded_rows: rows over "model"

Planning decisions:
  csize   : "auto" -> paper §5 scalar-op model argmin; "autotune" -> the
            joint csize x backend x blk_m microbenchmark on the plan's
            device (persisted to ``$REPRO_TORCH_AUTOTUNE_CACHE``; a warm
            store plans with ``probe_count() == 0``); or an explicit int.
  backend : "auto" -> topology (a mesh plan: ``sharded`` for
            batched_hvp, ``sharded_rows`` for hvp / hessian), then learned
            history (the tuner's winners, then execution telemetry), then
            registry priority (the CUDA kernel ``cuda`` wins
            ``batched_hvp`` on a mesh-less CUDA plan whose f traces into a
            device form that fits; ``vmap_l2`` elsewhere); or any
            registered name --
            reference | vmap_l0 | vmap_l1 | vmap_l2 | cuda | sharded |
            sharded_rows | pytree_fwdrev (hvp, diag, ggn, fisher and the
            service's batched forms on parameter trees) | pytree_fwd
            (quadform).
  device  : "cuda" by default; planning raises when no CUDA device is
            present unless ``device="cpu"`` is passed.

Serving: ``CurvatureService`` coalesces single-point requests into
power-of-two micro-batches on the plans' devices (admission, scheduler and
dispatch layers in ``repro_torch.serving``); ``RaggedFamily`` plans also
coalesce across n.  Every executed bucket is recorded
(``execution_stats``, ``bucket_telemetry``, ``client_stats``), and the
service re-tunes its observed buckets with ``autotune_buckets``.
"""

from .plan import (CurvaturePlan, plan, clear_cache, trace_count,
                   cache_size, bucket_size, pad_rows, pad_cols,
                   RaggedFamily, resolve_device)
from .registry import (BackendSpec, register_backend, get_backend,
                       list_backends, resolve_backend, WORKLOADS,
                       DTYPE_POLICIES, policy_compute_dtype,
                       record_execution, execution_stats, clear_telemetry,
                       bucket_telemetry, client_stats)
from .opmodel import (model_csize, csize_candidates,
                      pruned_csize_candidates, mults_chunk_hess,
                      mults_schunk_hess, exact_mults,
                      suggest_dispatch_knobs, ragged_padding_waste,
                      probe_chunk_cost, probe_csize_candidates,
                      model_csize_probes)
from .pytree import PytreeSpec, spec_of
from .autotune import (autotune, autotune_csize, clear_autotune_cache,
                       TunedConfig, function_fingerprint, lookup_tuned,
                       probe_count, store_path, load_store, save_store,
                       autotune_buckets, BucketTunedConfig,
                       apply_bucket_config, verify_dtype_policy,
                       DtypePolicyRejected, DEFAULT_DTYPE_TOL)
from .service import (CurvatureService, ServiceClosed, ServiceQueueFull,
                      ServiceOverloaded, AdmissionController, ClientPolicy,
                      get_service, configure_service, shutdown_service)

__all__ = [
    "CurvaturePlan", "plan", "clear_cache", "trace_count", "cache_size",
    "resolve_device",
    "bucket_size", "pad_rows", "pad_cols", "RaggedFamily",
    "BackendSpec", "register_backend", "get_backend", "list_backends",
    "resolve_backend", "WORKLOADS", "DTYPE_POLICIES", "policy_compute_dtype",
    "record_execution", "execution_stats", "clear_telemetry",
    "bucket_telemetry", "client_stats",
    "model_csize", "csize_candidates", "pruned_csize_candidates",
    "mults_chunk_hess", "mults_schunk_hess", "exact_mults",
    "suggest_dispatch_knobs", "ragged_padding_waste",
    "probe_chunk_cost", "probe_csize_candidates", "model_csize_probes",
    "PytreeSpec", "spec_of",
    "autotune", "autotune_csize", "clear_autotune_cache", "TunedConfig",
    "function_fingerprint", "lookup_tuned", "probe_count",
    "store_path", "load_store", "save_store",
    "autotune_buckets", "BucketTunedConfig", "apply_bucket_config",
    "verify_dtype_policy", "DtypePolicyRejected", "DEFAULT_DTYPE_TOL",
    "CurvatureService", "ServiceClosed", "ServiceQueueFull",
    "ServiceOverloaded", "AdmissionController", "ClientPolicy",
    "get_service", "configure_service", "shutdown_service",
]
