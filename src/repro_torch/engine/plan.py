"""CurvaturePlan: the plan/execute heart of the CurvatureEngine.

Counterpart of ``repro.engine.plan``.  ``plan(f, n, ...)`` makes every
decision the paper leaves to the caller -- chunk size (§5 op model), backend
(registry lookup honoring device, mesh and the form of f) -- and returns a
frozen ``CurvaturePlan`` bound to one device.  Executing a plan hits a
process-wide cache of built callables keyed on the static signature
``(f, n, csize, symmetric, backend, mesh, device, workload, options)``, so
two plans with the same signature share ONE callable.  PyTorch runs eagerly,
so there is no trace to cache: ``trace_count`` counts how many times a
callable was built, and stays flat on cache hits.

A plan runs on the card unless asked otherwise: ``device`` defaults to
``"cuda"``, and planning raises when no CUDA device is present.  Pass
``device="cpu"`` to run on the CPU.

Usage::

    p = plan(f, n, csize="auto", device="cuda")
    R = p.batched_hvp(A, V)        # (m, n), (m, n) -> (m, n)
"""

from __future__ import annotations

import collections
import threading
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from . import opmodel
from .registry import DTYPE_POLICIES, get_backend, resolve_backend

__all__ = ["CurvaturePlan", "plan", "clear_cache", "trace_count",
           "cache_size", "CACHE_MAXSIZE", "bucket_size", "pad_rows",
           "pad_cols"]

# LRU-bounded: cache keys strong-reference f, so per-call closures would
# otherwise pin one callable per call forever in a long-running process.
CACHE_MAXSIZE = 512
_EXECUTABLES: collections.OrderedDict = collections.OrderedDict()
_TRACE_COUNTS: collections.Counter = collections.Counter()
_TOTAL_TRACES: int = 0           # monotonic; survives LRU eviction
_CACHE_LOCK = threading.Lock()


def clear_cache() -> None:
    """Drop every cached callable and build count (tests / memory)."""
    global _TOTAL_TRACES
    with _CACHE_LOCK:
        _EXECUTABLES.clear()
        _TRACE_COUNTS.clear()
        _TOTAL_TRACES = 0


def cache_size() -> int:
    return len(_EXECUTABLES)


def trace_count(key=None) -> int:
    """Total number of callables built (or for one cache key).

    The total is monotonic even when LRU eviction drops per-key counts."""
    if key is None:
        return _TOTAL_TRACES
    return _TRACE_COUNTS[key]


# ---------------------------------------------------------------------------
# micro-batch bucketing
# ---------------------------------------------------------------------------

def bucket_size(k: int, max_batch: Optional[int] = None) -> int:
    """Smallest power of two >= k (optionally capped at ``max_batch``)."""
    if k < 1:
        raise ValueError(f"bucket_size: k={k} must be >= 1")
    if max_batch is not None and k > max_batch:
        raise ValueError(f"bucket_size: k={k} exceeds max_batch={max_batch}")
    b = 1
    while b < k:
        b *= 2
    if max_batch is not None:
        b = min(b, max_batch)
    return b


def _edge_pad(X, size, what):
    """Pad axis 0 of X up to ``size`` by replicating its last entry.  numpy
    in -> numpy out; tensors stay tensors on their device."""
    k = X.shape[0]
    if k > size:
        raise ValueError(f"{what}: {k} entries exceed {size}")
    if k == size:
        return X
    if isinstance(X, np.ndarray):
        pad = np.broadcast_to(X[-1:], (size - k,) + X.shape[1:])
        return np.concatenate([X, pad], axis=0)
    X = torch.as_tensor(X)
    return torch.cat([X, X[-1:].expand((size - k,) + X.shape[1:])], dim=0)


def pad_rows(X, bucket: int):
    """Pad a stacked (k, ...) array up to ``bucket`` rows by replicating the
    last row.  Edge replication (not zeros) keeps the padding inside the
    function's domain -- Ackley's sqrt is non-differentiable at the origin,
    so zero rows would inject NaNs even though padded outputs are
    discarded."""
    return _edge_pad(X, bucket, "pad_rows")


def pad_cols(x, n_pad: int):
    """Pad a flat (n,) vector up to ``n_pad`` entries by replicating the
    last element -- the column-axis analogue of ``pad_rows``."""
    return _edge_pad(x, n_pad, "pad_cols")


@dataclass(frozen=True)
class CurvaturePlan:
    """An executable decision: what to compute, how, and on which device.

    f         : scalar objective written against ``repro_torch.core.hmath``
    n         : flat problem dimension
    m         : batch-size hint (backend selection only; NOT part of the
                cache key -- the batch extent comes from the tensors)
    csize     : resolved chunk size (int; "auto" is resolved by ``plan()``)
    symmetric : exploit Hessian symmetry (paper Alg. 6/8 schedules)
    backend   : registry name or "auto" (resolved per workload)
    mesh      : topology handle; no mesh-native backend is ported yet, so a
                mesh plan resolves to the single-device backends
    options   : hashable (key, value) pairs of backend tunables
    device    : the torch.device every input must live on
    """

    f: Callable
    n: Optional[int]
    m: Optional[int] = None
    csize: int = 1
    symmetric: bool = True
    backend: str = "auto"
    mesh: Any = None
    options: tuple = ()
    device: torch.device = torch.device("cpu")

    # -- introspection -----------------------------------------------------
    def opt(self, key: str, default=None):
        return dict(self.options).get(key, default)

    def describe(self) -> str:
        fname = getattr(self.f, "__name__", repr(self.f))
        return (f"CurvaturePlan(f={fname}, n={self.n}, m={self.m}, "
                f"csize={self.csize}, symmetric={self.symmetric}, "
                f"backend={self.backend}, mesh={'yes' if self.mesh else 'no'}"
                f", device={self.device})")

    def backend_for(self, workload: str) -> str:
        """Concrete backend name this plan resolves to for a workload."""
        return resolve_backend(self, workload).name

    def cache_key(self, workload: str, backend_name: str):
        return (self.f, self.n, self.csize, self.symmetric, backend_name,
                self.mesh, self.device, workload, self.options)

    # -- building ----------------------------------------------------------
    def executable(self, workload: str) -> Callable:
        """The cached callable for ``workload``; hits return the SAME
        object and do not count as a build."""
        global _TOTAL_TRACES
        spec = resolve_backend(self, workload)
        key = self.cache_key(workload, spec.name)
        with _CACHE_LOCK:
            fn = _EXECUTABLES.get(key)
            if fn is None:
                fn = spec.make(self, workload)
                _TRACE_COUNTS[key] += 1
                _TOTAL_TRACES += 1
                _EXECUTABLES[key] = fn
                while len(_EXECUTABLES) > CACHE_MAXSIZE:
                    old_key, _ = _EXECUTABLES.popitem(last=False)
                    _TRACE_COUNTS.pop(old_key, None)
            else:
                _EXECUTABLES.move_to_end(key)
            return fn

    def _input(self, x):
        """numpy (or nested sequences) go to the plan's device; a tensor on
        any other device is the caller's mistake and raises."""
        if isinstance(x, torch.Tensor):
            if x.device != self.device:
                raise ValueError(
                    f"tensor on {x.device} passed to a plan on "
                    f"{self.device}; move it with .to({str(self.device)!r})")
            return x
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _run(self, workload, *arrays):
        return self.executable(workload)(*(self._input(x) for x in arrays))

    # -- workload entry points --------------------------------------------
    def hvp(self, a, v):
        """r = H_f(a) @ v (flat vectors)."""
        return self._run("hvp", a, v)

    def hessian(self, a):
        """Dense (n, n) Hessian at a."""
        return self._run("hessian", a)

    def batched_hvp(self, A, V):
        """(m, n), (m, n) -> (m, n): one HVP per instance."""
        return self._run("batched_hvp", A, V)

    def batched_hessian(self, A):
        """(m, n) -> (m, n, n)."""
        return self._run("batched_hessian", A)

    def execute(self, *args):
        """Single entry point: dispatch on argument shapes.

          (a[n], v[n])       -> hvp
          (A[m,n], V[m,n])   -> batched_hvp
          (a[n],)            -> hessian
          (A[m,n],)          -> batched_hessian
        """
        args = tuple(self._input(x) for x in args)
        nds = tuple(x.dim() for x in args)
        if len(args) == 2:
            if nds == (1, 1):
                return self.hvp(*args)
            if nds == (2, 2):
                return self.batched_hvp(*args)
        elif len(args) == 1:
            if nds == (1,):
                return self.hessian(args[0])
            if nds == (2,):
                return self.batched_hessian(args[0])
        raise ValueError(
            f"cannot infer workload from {len(args)} args with ndims {nds}")


def _resolve_csize(n, csize, symmetric):
    if isinstance(csize, int):
        # csize > n is legal: the chunk schedules mask the ragged tail
        if csize < 1:
            raise ValueError(f"csize={csize} must be >= 1")
        return csize
    if csize == "auto":
        return opmodel.model_csize(n, symmetric)
    if csize == "autotune":
        raise NotImplementedError(
            "csize='autotune' is not ported yet (ROADMAP queue A, item 6: "
            "Tuning); use csize='auto' or an explicit int")
    raise ValueError(f"csize must be int, 'auto' or 'autotune'; got {csize!r}")


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "plan(): no CUDA device is available; pass device='cpu' to "
                "plan on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def plan(f, n=None, m=None, csize="auto", backend="auto", symmetric=True,
         mesh=None, level=None, device="cuda", options=None,
         **extra_options):
    """Build a CurvaturePlan (the engine's single planning entry point).

    level  : "L0"/"L1"/"L2" selects the matching vmap backend when backend
             is "auto".
    device : where the plan runs; "cuda" (the default) raises when no CUDA
             device is present -- pass "cpu" explicitly for the CPU.
    options / **extra_options : backend tunables, must be hashable.
    """
    if n is None:
        raise NotImplementedError(
            "pytree plans (n=None) are not ported yet (ROADMAP queue A, "
            "item 8: Pytree curvature)")
    n = int(n)
    device = _resolve_device(device)
    opts = dict(options or {})
    opts.update(extra_options)
    policy = opts.get("dtype_policy")
    if policy is not None:
        if policy not in DTYPE_POLICIES:
            raise ValueError(
                f"unknown dtype_policy {policy!r}; expected one of "
                f"{DTYPE_POLICIES}")
        if policy == "fp32":
            # the default: drop it so the plan's cache signature is identical
            # to a plan that never mentioned a policy
            del opts["dtype_policy"]
    if backend != "auto":
        # fail at plan time on a typo or a mesh-requiring backend without a
        # mesh, not at the first call
        spec = get_backend(backend)
        if spec.requires_mesh and mesh is None:
            raise ValueError(
                f"backend {backend!r} requires a mesh; pass mesh=... to "
                "plan() (or use backend='auto' for single-device plans)")
    if level is not None:
        if level not in ("L0", "L1", "L2"):
            raise ValueError(f"unknown level {level!r}")
        if backend == "auto" and mesh is None:
            backend = f"vmap_{level.lower()}"
        else:
            opts.setdefault("level", level)
    if m is not None:
        m = int(m)
        if m < 1:
            raise ValueError(
                f"m={m} must be >= 1; m is a batch-size hint for backend "
                "selection only -- omit it for single-instance plans")
    csize = _resolve_csize(n, csize, symmetric)
    return CurvaturePlan(f=f, n=n, m=m, csize=int(csize),
                         symmetric=bool(symmetric), backend=backend,
                         mesh=mesh, options=tuple(sorted(opts.items())),
                         device=device)
