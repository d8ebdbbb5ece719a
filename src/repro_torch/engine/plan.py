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
``device="cpu"`` to run on the CPU.  ``csize="autotune"`` measures the
chunk size, backend and the kernel's instances per CTA on that device
(``engine.autotune``).

``plan(f, None, ...)`` is a pytree plan: f takes a parameter tree (a dict
of tensors), and the pytree backends (``core.curvature``) serve hvp,
diag, ggn, fisher and quadform on it; its csize is the probe-chunk size of
the diag workload.  A tree's tensors must live on the plan's device.

Usage::

    p = plan(f, n, csize="auto", device="cuda")
    R = p.batched_hvp(A, V)        # (m, n), (m, n) -> (m, n)
    q = plan(loss, None, device="cuda", n_probes=4)
    d = q.diag(params, seed)       # Hutchinson diag(H), a tree
"""

from __future__ import annotations

import collections
import threading
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import opmodel
from .registry import DTYPE_POLICIES, get_backend, resolve_backend

__all__ = ["CurvaturePlan", "plan", "clear_cache", "trace_count",
           "cache_size", "CACHE_MAXSIZE", "bucket_size", "pad_rows",
           "pad_cols", "RaggedFamily"]

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


class RaggedFamily:
    """A shape-polymorphic objective family: one function served at any n.

    Cross-``n`` ragged coalescing needs more than a callable per ``n`` --
    it needs the *masked* form ``masked(x_pad, n_eff)`` that equals
    ``fn(x_pad[:n_eff])`` for every ``n_eff <= len(x_pad)``, with
    ``n_eff`` a tensor.  Because the masking is multiplicative (terms past
    the effective prefix multiplied by an exact 0), the gradient and
    Hessian entries outside the prefix are exactly zero, so a padded-``n``
    HVP row sliced back to ``n_eff`` entries is the exact per-``n`` answer
    -- that is what the ``batched_hvp_ragged`` workload executes.

    ``name`` is the family's identity: two ``RaggedFamily`` objects with
    the same name hash and compare equal (so plans built by independent
    clients coalesce), which also means names must be globally unique per
    distinct function.  The family is itself callable (``fam(x)`` ==
    ``fn(x)``), so it is passed directly as a plan's ``f``; ``plan()``
    auto-injects the ``ragged_family`` option for such plans, which is
    the scheduler's opt-in signal for cross-``n`` bucketing.

    A family's dense plan computes ``fn(x)``, so its kernel forms are
    ``fn``'s: ``kernel_fn``, ``kernel_consts`` and ``device_fn`` are read
    from ``fn`` (``kernels.ops.kernel_form``), and a family of a function
    with a CUDA device form reaches the ``cuda`` backend on a CUDA plan.

    ``masked=None`` derives a default by zero-masking the input
    (``fn(x * (iota < n_eff))``) -- only correct for families where a
    zero tail reproduces the prefix value AND stays differentiable there
    (e.g. plain quadratics; NOT Ackley, whose mean spans the full length
    and whose sqrt is singular at 0).  The paper test functions ship
    hand-written masked forms in ``core/testfns.ragged_family``.
    """

    __slots__ = ("name", "fn", "masked")

    def __init__(self, name: str, fn: Callable,
                 masked: Optional[Callable] = None):
        self.name = str(name)
        self.fn = fn
        if masked is None:
            def masked(x, n_eff, _fn=fn):
                keep = (torch.arange(x.shape[0], device=x.device)
                        < n_eff).to(x.dtype)
                return _fn(x * keep)
        self.masked = masked

    @property
    def __name__(self) -> str:          # describe() / telemetry labels
        return f"ragged:{self.name}"

    @property
    def kernel_fn(self):
        return getattr(self.fn, "kernel_fn", self.fn)

    @property
    def kernel_consts(self) -> tuple:
        return tuple(getattr(self.fn, "kernel_consts", ()))

    @property
    def device_fn(self) -> Optional[str]:
        return getattr(self.fn, "device_fn", None)

    def __call__(self, x):
        return self.fn(x)

    def __hash__(self):
        return hash(("RaggedFamily", self.name))

    def __eq__(self, other):
        return isinstance(other, RaggedFamily) and other.name == self.name

    def __repr__(self):
        return f"RaggedFamily({self.name!r})"


@dataclass(frozen=True)
class CurvaturePlan:
    """An executable decision: what to compute, how, and on which device.

    f         : scalar objective written against ``repro_torch.core.hmath``
                (flat plans), or of a parameter tree (pytree plans)
    n         : flat problem dimension; None for a pytree plan
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

    def _tree(self, tree):
        """A parameter tree with every leaf on the plan's device (numpy
        leaves go there; a tensor elsewhere raises, as ``_input``)."""
        return pytree.tree_map(self._input, tree)

    # -- workload entry points --------------------------------------------
    def hvp(self, a, v):
        """r = H_f(a) @ v (flat vectors, or trees on a pytree plan)."""
        if self.n is None:
            return self.executable("hvp")(self._tree(a), self._tree(v))
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

    def diag(self, params, key):
        """Hutchinson diag estimate on a parameter tree: diag(H), or diag(G)
        when the plan carries ``diag_of="ggn"``.  ``key`` is an int seed:
        the probes are drawn from a generator on the plan's device."""
        return self.executable("diag")(self._tree(params), key)

    def ggn(self, params, v):
        """Gauss-Newton product (J^T H_head J) v on a parameter tree.

        Needs ``model_fn`` (params -> outputs) and ``head_loss``
        (outputs -> scalar) in the plan options -- ``models.targets``
        builds both for an LM."""
        return self.executable("ggn")(self._tree(params), self._tree(v))

    def fisher(self, params, v):
        """Empirical Fisher product (1/B) J_L^T J_L v on a parameter tree.
        Needs ``per_example_fn`` (params -> (B,) losses) in the plan
        options."""
        return self.executable("fisher")(self._tree(params), self._tree(v))

    def quadform(self, params, v, w=None):
        """w^T H v with no reverse sweep (pytree backends)."""
        v = self._tree(v)
        return self.executable("quadform")(
            self._tree(params), v, v if w is None else self._tree(w))

    # -- async serving -----------------------------------------------------
    def submit(self, a, v=None, *, workload=None, n_probes=None,
               service=None, block=True, timeout=None):
        """Submit one request to the coalescing CurvatureService.

        Returns a ``concurrent.futures.Future`` of host numpy:

          submit(a, v) -> future of H_f(a) @ v      (coalesced batched_hvp)
          submit(a)    -> future of the dense H(a)  (coalesced batched_hessian)

        Requests from concurrent callers that share this plan's signature
        are padded into one power-of-two micro-batch and executed by one
        cached batched callable on the plan's device.  ``service``
        overrides the process-default service; ``block``/``timeout``
        control backpressure when its queue is full.

        Pytree plans (``n is None``) coalesce too: requests are keyed on
        the tree's structure, raveled on the host and padded into the same
        micro-bucket path (futures resolve to host numpy trees):

          submit(params, v_tree)                  -> future of H @ v
          submit(params, seed, workload="diag")   -> future of the diag

        Diag submits take a per-request probe budget ``n_probes=k``
        (``1 <= k <=`` the plan's ``n_probes`` option); mixed budgets
        coalesce into one bucket."""
        if service is None:
            service = self.service()
        return service.submit(self, a, v, workload=workload,
                              n_probes=n_probes, block=block,
                              timeout=timeout)

    def service(self):
        """The process-default CurvatureService (created on first use)."""
        from .service import get_service
        return get_service()

    def execute(self, *args):
        """Single entry point: dispatch on argument shapes.

          (a[n], v[n])       -> hvp
          (A[m,n], V[m,n])   -> batched_hvp
          (a[n],)            -> hessian
          (A[m,n],)          -> batched_hessian
          (params_tree, v_tree) with n=None -> hvp (pytree)
        """
        if self.n is None:
            if len(args) != 2:
                raise ValueError("pytree plans execute (params, v) -> Hv")
            return self.hvp(*args)
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


def _resolve_csize(n, csize, symmetric, options=()):
    if isinstance(csize, int):
        # csize > n is legal: the chunk schedules mask the ragged tail
        if csize < 1:
            raise ValueError(f"csize={csize} must be >= 1")
        return csize
    if n is None and csize in ("auto", "autotune"):
        # pytree workloads chunk over the PROBE axis (Hutchinson /
        # GGN-diag): the probe-chunk op model picks the argmin over the
        # divisors of n_probes.  For measured tuning run
        # engine.autotune(f, None, workload="diag", example=params) and
        # pass its csize explicitly.
        return opmodel.model_csize_probes(
            int(dict(options).get("n_probes", 4)))
    if csize == "auto":
        return opmodel.model_csize(n, symmetric)
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


def _check_blk_m(f, n: int, csizes, device: torch.device, blk_m) -> None:
    """A card plan's ``blk_m`` (the ``cuda`` backend's instances per CTA)
    must be one that ``kernels.chess_hvp.instance_blocks`` lists at n and
    one of ``csizes``: ValueError otherwise, rather than a plan whose
    ``cuda`` backend is vetoed and whose work quietly runs on a vmap
    backend.  A CPU plan never runs the kernel and is not checked."""
    if blk_m is None or device.type != "cuda":
        return
    from repro_torch.kernels.chess_hvp import (instance_blocks,
                                               is_instance_block)
    from repro_torch.kernels.ops import kernel_form
    device_fn = kernel_form(f)[2]
    if not any(is_instance_block(device_fn, n, c, blk_m) for c in csizes):
        listed = {c: instance_blocks(device_fn, n, c) if device_fn else []
                  for c in csizes}
        raise ValueError(
            f"plan(): blk_m={blk_m!r} is not an instances per CTA that the "
            f"cuda kernel takes for {getattr(f, '__name__', f)!r} at n={n} "
            f"(kernels.chess_hvp.instance_blocks by csize: {listed})")


def plan(f, n=None, m=None, csize="auto", backend="auto", symmetric=True,
         mesh=None, level=None, device="cuda", options=None,
         **extra_options):
    """Build a CurvaturePlan (the engine's single planning entry point).

    n      : the flat problem dimension, or None for a pytree plan (f of a
             parameter tree; hvp, diag, ggn, fisher and quadform)
    csize  : an int, "auto" (the §5 op-model argmin) or "autotune" (the
             joint csize x backend x blk_m microbenchmark of
             ``autotune.autotune`` on this plan's device, of batched_hvp
             when ``m`` is given, else of hvp; memoized in-process and
             persisted, so a warm store plans without a probe).  A ``cuda``
             winner's ``blk_m`` (instances per CTA) is threaded into the
             plan's options; the backend stays "auto" and resolves to the
             winner through the tuner's consult table.  On a pytree plan
             both "auto" and "autotune" take the probe-chunk model's
             argmin over the divisors of the ``n_probes`` option.
    level  : "L0"/"L1"/"L2" selects the matching vmap backend when backend
             is "auto".
    device : where the plan runs; "cuda" (the default) raises when no CUDA
             device is present -- pass "cpu" explicitly for the CPU.
    options / **extra_options : backend tunables, must be hashable
             (``blk_m``: the ``cuda`` backend's instances per CTA, one of
             ``kernels.chess_hvp.instance_blocks``; a card plan raises
             ValueError on any other).
    """
    if n is not None:
        n = int(n)
    device = _resolve_device(device)
    opts = dict(options or {})
    opts.update(extra_options)
    if isinstance(f, RaggedFamily) and n is not None:
        # a family-built flat plan is implicitly coalescible across n: the
        # option is the scheduler's opt-in signal and part of the cache and
        # telemetry signature (hashable -- families hash by name)
        opts.setdefault("ragged_family", f)
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
    opt_items = tuple(sorted(opts.items()))
    if csize == "autotune" and n is not None:
        from .autotune import autotune
        # the sweep keeps a pinned blk_m to the csizes that take it
        _check_blk_m(f, n, opmodel.pruned_csize_candidates(n, symmetric),
                     device, opts.get("blk_m"))
        cfg = autotune(f, n, m=m, symmetric=bool(symmetric), backend=backend,
                       mesh=mesh, options=opt_items,
                       workload="batched_hvp" if m else "hvp", device=device)
        csize = cfg.csize
        if cfg.backend == "cuda" and cfg.blk_m and "blk_m" not in opts:
            # thread the swept instances per CTA into the plan so the kernel
            # runs the WINNING configuration; the plan's backend stays
            # "auto" (other workloads need other backends) and
            # resolve_backend re-finds cfg.backend via the tuned consult
            opts["blk_m"] = cfg.blk_m
            opt_items = tuple(sorted(opts.items()))
    else:
        csize = _resolve_csize(n, csize, symmetric, opt_items)
        if n is not None:
            _check_blk_m(f, n, [csize], device, opts.get("blk_m"))
    return CurvaturePlan(f=f, n=n, m=m, csize=int(csize),
                         symmetric=bool(symmetric), backend=backend,
                         mesh=mesh, options=opt_items, device=device)
