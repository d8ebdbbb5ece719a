"""Joint (csize, backend, blk_m) microbenchmark autotuner, persisted to disk.

Counterpart of ``repro.engine.autotune``.  The §5 op model predicts the
scalar-work argmin, but on real hardware the best configuration also depends
on occupancy, memory traffic and the schedule itself -- which backend runs
the sweep, and, for the CUDA kernel, how many instances one CTA takes.
``csize="autotune"`` therefore runs a JOINT sweep:

  csize    : §5-model-pruned candidate set (``opmodel.pruned_csize_
             candidates`` -- the model seeds the grid, measurement decides)
  backend  : every capable non-oracle backend when the plan's backend is
             "auto" (``cuda`` on a CUDA plan of f that traces, then
             vmap_l2/l1/l0); just the named one otherwise
  blk_m    : swept for the ``cuda`` backend only, over ``[None] +
             chess_hvp.instance_blocks(form, n, csize)`` of the form the
             backend runs f on (``kernels.ops.backend_form``): the kernel's
             instances per CTA, None being the wrapper's own choice (the
             reference's dial of the same name is the Pallas kernel's
             instance block, swept for any f)

Candidates that ``can_run`` refuses are dropped before timing.  Each
candidate is built once and wall-clocked best-of-k under a deadline budget
(``_time_once``), its device synchronized after every call; a candidate
that raises is skipped, never counted as a measurement, and is kept in the
winner's ``failures`` -- except a ``cuda`` candidate on a CUDA device: the
grid already left out what the kernel cannot take, so its error is a kernel
that failed to build or launch, and the sweep raises it.  The
winner is memoized in-process AND persisted to a small JSON store keyed on
``(function fingerprint, n, workload, symmetric, probe m, backend,
platform)`` -- a serving restart with a warm store plans
``csize="autotune"`` without running a single timed probe (``probe_count()``
is the witness).

The store is the port's own: ``$REPRO_TORCH_AUTOTUNE_CACHE`` (default
``~/.cache/repro_torch/autotune.json``), never the reference's
``$REPRO_AUTOTUNE_CACHE``: both packages rewrite the whole file from their
own snapshot, and a record of one must never answer for the other.  The
platform in a key is the plan's device -- ``cuda:<device name>`` or ``cpu``
-- so a winner tuned on one card is not restored on another kind, nor on
the CPU.  The reference's ``include_pallas`` key axis has no counterpart:
``cuda`` is kept off every non-CUDA plan by its own ``supports``, so there
is no backend to opt into.

Identity: both caches key functions by ``function_fingerprint(f)``
(qualname + source/closure hash, tensors by content), so the in-memory LRU
and the on-disk store never disagree about which ``f`` a record belongs to.

Warm start: ``registry`` execution telemetry seeds the sweep order, so the
measured-best configuration from live traffic is probed first and survives
a tight ``deadline_s``.  ``backend="auto"`` planning consults the persisted
winners at resolve time (``registry.resolve_backend`` / ``lookup_tuned``).

``autotune_buckets`` is the online half: the same sweep at the service's
OBSERVED bucket sizes, timed in the dispatcher's own window (operands on
the device before the clock starts, the result read back to host numpy
before it stops), so the tuned baseline and the live telemetry measure the
same thing.  It is the ``CurvatureService``'s default tuner.

The Hutchinson ``diag`` workload sweeps the PROBE-chunk axis (the divisors
of the plan's ``n_probes``, the probe-chunk model's argmin first).  Pytree
plans tune by example: ``autotune(f, None, workload="diag" or "hvp",
example=params)`` probes the given tree on the device; such tunes are
memoized in-process but not persisted (the tree's structure and the probe
options are not part of the store key).  On the card a pytree sweep has no
``cuda`` candidate: the kernel serves flat plans only.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import inspect
import json
import os
import tempfile
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import opmodel

__all__ = [
    "autotune", "autotune_csize", "clear_autotune_cache", "TunedConfig",
    "function_fingerprint", "lookup_tuned", "probe_count",
    "store_path", "load_store", "save_store",
    "autotune_buckets", "BucketTunedConfig", "apply_bucket_config",
    "verify_dtype_policy", "DtypePolicyRejected", "DEFAULT_DTYPE_TOL",
]

_TUNABLE_WORKLOADS = ("batched_hvp", "hvp", "hessian", "diag")
# backends whose schedule ignores csize: sweeping it would re-measure the
# same program under different cache keys
_NON_CHUNKED = frozenset({"reference"})


def _csize_swept(backend: str, workload: str) -> bool:
    """Whether this (backend, workload) pair's schedule varies with csize.
    pytree_fwdrev ignores csize everywhere EXCEPT the chunked Hutchinson /
    GGN diag path."""
    if backend in _NON_CHUNKED:
        return False
    if backend == "pytree_fwdrev":
        return workload == "diag"
    return True


# LRU-bounded like the plan callable cache; keys carry the function
# FINGERPRINT (not f itself), so per-request closures are never pinned
AUTOTUNE_CACHE_MAXSIZE = 64
_AUTOTUNE_CACHE: collections.OrderedDict = collections.OrderedDict()
# consult table for backend="auto" resolution: store-key -> TunedConfig.
# _TUNED_VERSION bumps on every mutation so resolve-time consults can be
# memoized (registry._learned_backend) without re-scanning per dispatch.
_TUNED: dict = {}
_TUNED_VERSION = 0
_LOCK = threading.Lock()

_PROBES_RUN = 0                     # timed executions since process start


def tuned_version() -> int:
    """Monotonic counter of consult-table mutations (memo invalidation)."""
    return _TUNED_VERSION


@dataclass(frozen=True)
class TunedConfig:
    """One joint-tune answer: the winning configuration and its measured
    best-of-k wall time (``time_s``; 0.0 for records restored from disk,
    whose probe ran in another process).

    A sweep's answer also carries what the sweep did: ``trials``, one
    ``(backend, csize, blk_m, time_s)`` per measured candidate in sweep
    order, ``failures``, one ``(backend, csize, blk_m, error)`` per
    candidate that raised (skipped, never measured), and ``sweep_s``, the
    sweep's wall time.  All empty for a restored record."""
    csize: int
    backend: str
    blk_m: Optional[int]
    time_s: float
    source: str                     # "sweep" | "memory" | "disk"
    dtype_policy: str = "fp32"      # dual dtype (registry.DTYPE_POLICIES)
    trials: tuple = ()
    failures: tuple = ()
    sweep_s: float = 0.0


# normalized-L2 error budget for a reduced-precision dual policy, checked
# against the fwd-fwd oracle.  bf16 carries ~8 mantissa bits (eps ~ 7.8e-3);
# a chunked HVP accumulates a few of those, so 5e-2 accepts healthy bf16
# tangents while anything structurally wrong lands orders of magnitude
# above it.  Plans override via the ``dtype_tol`` option.
DEFAULT_DTYPE_TOL = 5e-2


class DtypePolicyRejected(ValueError):
    """A reduced-precision dual policy exceeded the plan's oracle-error
    tolerance.  Raised (never silently kept) on explicit verification; the
    sweep records the rejection and falls back to exact duals."""


def probe_count() -> int:
    """Timed probe executions (incl. warmups) since process start -- the
    persistence tests assert this stays 0 on a warm store."""
    return _PROBES_RUN


def clear_autotune_cache() -> None:
    """Drop the in-memory memo, the consult table, and the loaded disk
    snapshot (the store FILE is untouched; the next lookup re-reads it)."""
    global _DISK, _DISK_PATH, _TUNED_VERSION
    with _LOCK:
        _AUTOTUNE_CACHE.clear()
        _TUNED.clear()
        _TUNED_VERSION += 1
        _DISK, _DISK_PATH = None, None


# ---------------------------------------------------------------------------
# function identity
# ---------------------------------------------------------------------------

_FP_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
# hashable objects that take no weak reference (``RaggedFamily`` has
# __slots__): memoized strongly, LRU-bound -- resolve_backend fingerprints
# the plan's f on every execution
_FP_STRONG: collections.OrderedDict = collections.OrderedDict()
_FP_STRONG_MAXSIZE = 512


def _hash_update(h, obj, depth: int = 0) -> None:
    """Feed a closure/argument value into the fingerprint hash, stably
    across processes (no ids, no memory addresses)."""
    if depth > 4:
        h.update(b"<deep>")
        return
    if obj is None or isinstance(obj, (bool, int, float, complex, str,
                                       bytes)):
        h.update(repr(obj).encode())
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        h.update(str(arr.dtype).encode())
        h.update(repr(arr.shape).encode())
        h.update(arr.tobytes())
    elif isinstance(obj, torch.Tensor):
        # by content, wherever it lies: Fletcher-Powell's coefficients are
        # tensors in its closure, on the plan's device
        t = obj.detach().to("cpu").contiguous()
        h.update(str(t.dtype).encode())
        h.update(repr(tuple(t.shape)).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    elif isinstance(obj, (tuple, list)):
        h.update(type(obj).__name__.encode())
        for x in obj:
            _hash_update(h, x, depth + 1)
    elif isinstance(obj, dict):
        for k in sorted(obj, key=repr):
            _hash_update(h, k, depth + 1)
            _hash_update(h, obj[k], depth + 1)
    elif isinstance(obj, functools.partial):
        _hash_update(h, obj.func, depth + 1)
        _hash_update(h, obj.args, depth + 1)
        _hash_update(h, obj.keywords, depth + 1)
    elif inspect.ismodule(obj):
        h.update(f"module:{obj.__name__}".encode())
    elif callable(obj):
        _hash_callable(h, obj, depth + 1)
    else:
        # lossy fallback: type identity only (stable, never an address)
        h.update(f"<{type(obj).__module__}.{type(obj).__qualname__}>".encode())


def _hash_callable(h, f, depth: int = 0) -> None:
    h.update(getattr(f, "__module__", "").encode())
    h.update((getattr(f, "__qualname__", None)
              or getattr(f, "__name__", type(f).__qualname__)).encode())
    code = getattr(f, "__code__", None)
    if code is not None:
        try:
            h.update(inspect.getsource(f).encode())
        except (OSError, TypeError):
            h.update(code.co_code)
            h.update(repr(code.co_consts).encode())
        for cell in (getattr(f, "__closure__", None) or ()):
            try:
                _hash_update(h, cell.cell_contents, depth + 1)
            except ValueError:          # empty cell
                h.update(b"<empty-cell>")
        _hash_update(h, getattr(f, "__defaults__", None), depth + 1)
    elif isinstance(f, functools.partial):
        _hash_update(h, f, depth)
    else:
        # callable instance: hash its type's __call__ and its __dict__ (a
        # RaggedFamily has none: its identity is its name, in the
        # fingerprint's prefix, as its __eq__ says)
        call = getattr(type(f), "__call__", None)
        if getattr(call, "__code__", None) is not None:
            _hash_callable(h, call, depth + 1)
        _hash_update(h, getattr(f, "__dict__", None), depth + 1)


def function_fingerprint(f) -> str:
    """Stable cross-process identity for a target function: qualname plus a
    hash of its source (bytecode as fallback) and closure/default values --
    numpy arrays and torch tensors hashed by content.  Used as the function
    key of BOTH the in-memory autotune LRU and the on-disk store, so the two
    never disagree about identity; results are memoized per object."""
    try:
        hit = _FP_CACHE.get(f)
        weak = True
    except TypeError:
        weak = False
        with _LOCK:
            try:
                hit = _FP_STRONG.get(f)
            except TypeError:           # unhashable: no memo at all
                hit = None
    if hit is not None:
        return hit
    h = hashlib.sha256()
    _hash_update(h, f)
    name = getattr(f, "__qualname__", None) or getattr(
        f, "__name__", type(f).__qualname__)
    fp = f"{name}:{h.hexdigest()[:16]}"
    if weak:
        _FP_CACHE[f] = fp
    else:
        with _LOCK:
            try:
                _FP_STRONG[f] = fp
            except TypeError:
                return fp
            while len(_FP_STRONG) > _FP_STRONG_MAXSIZE:
                _FP_STRONG.popitem(last=False)
    return fp


# ---------------------------------------------------------------------------
# on-disk store
# ---------------------------------------------------------------------------

STORE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
_DISK: Optional[dict] = None
_DISK_PATH: Optional[str] = None
_STORE_WARNED = False

_DISABLE_SENTINELS = ("", "0", "off")


def store_path() -> str:
    """Store location: ``$REPRO_TORCH_AUTOTUNE_CACHE`` if set (empty, "0" or
    "off" disable persistence and fall through to the default location),
    else ``$XDG_CACHE_HOME/repro_torch/autotune.json`` (XDG_CACHE_HOME
    defaulting to ``~/.cache``)."""
    p = os.environ.get(STORE_ENV)
    if p and p not in _DISABLE_SENTINELS:
        return p
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "repro_torch", "autotune.json")


def _persist_enabled() -> bool:
    return os.environ.get(STORE_ENV, "on") not in _DISABLE_SENTINELS


def load_store(path: Optional[str] = None) -> dict:
    """The parsed on-disk store (cached per path; corrupt/missing -> {};
    {} without touching disk when persistence is env-disabled and no
    explicit path is given)."""
    global _DISK, _DISK_PATH
    if path is None and not _persist_enabled():
        return {}
    path = path or store_path()
    with _LOCK:
        if _DISK is not None and _DISK_PATH == path:
            return _DISK
    try:
        with open(path) as fh:
            data = json.load(fh)
        if not isinstance(data, dict):
            data = {}
    except (OSError, ValueError):
        data = {}
    with _LOCK:
        _DISK, _DISK_PATH = data, path
        return data


def save_store(path: Optional[str] = None) -> Optional[str]:
    """Atomically write the in-memory store snapshot, merged over whatever
    is currently on disk (concurrent processes lose single keys at worst,
    never the file).  Returns the path, or None if the location is
    unwritable (warned once; tuning still works, it just re-probes) or
    persistence is env-disabled and no explicit path is given."""
    global _DISK, _DISK_PATH, _STORE_WARNED
    if path is None and not _persist_enabled():
        return None
    path = path or store_path()
    try:
        with open(path) as fh:
            on_disk = json.load(fh)
        if not isinstance(on_disk, dict):
            on_disk = {}
    except (OSError, ValueError):
        on_disk = {}
    with _LOCK:
        on_disk.update(_DISK or {})
        data = dict(on_disk)
    try:
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".autotune-")
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(data, fh, indent=2, sort_keys=True)
                fh.write("\n")
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except OSError as e:
        if not _STORE_WARNED:
            _STORE_WARNED = True
            import warnings
            warnings.warn(f"autotune store not persisted to {path!r}: {e!r}")
        return None
    with _LOCK:
        _DISK, _DISK_PATH = data, path
    return path


_DEVICE_NAMES: dict = {}


def _platform(device) -> str:
    """The platform of a plan's device: ``cuda:<device name>`` (spaces as
    underscores) or ``cpu``.  Winners tuned on one card must not be
    restored on a different kind of card, nor on the CPU; a CUDA device
    whose name cannot be read (no card in this process) is
    ``cuda:unknown``."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    name = _DEVICE_NAMES.get(device)
    if name is None:
        try:
            name = torch.cuda.get_device_name(device).replace(" ", "_")
        except (AssertionError, RuntimeError):     # no CUDA in this build
            return "cuda:unknown"
        _DEVICE_NAMES[device] = name
    return f"cuda:{name}"


def _store_key(fp: str, n: int, workload: str, symmetric: bool, mm: int,
               backend: str, platform: str) -> str:
    return "|".join([fp, f"n{n}", workload, f"sym{int(bool(symmetric))}",
                     f"m{mm}", backend, platform])


def _cfg_from_entry(entry, source: str) -> Optional[TunedConfig]:
    try:
        blk_m = entry.get("blk_m")
        return TunedConfig(csize=int(entry["csize"]),
                           backend=str(entry["backend"]),
                           blk_m=int(blk_m) if blk_m else None,
                           time_s=float(entry.get("time_s", 0.0)),
                           source=source,
                           dtype_policy=str(entry.get("dtype_policy",
                                                      "fp32")))
    except (AttributeError, KeyError, TypeError, ValueError):
        return None


def _persist(skey: str, cfg: TunedConfig,
             extra: Optional[dict] = None) -> None:
    load_store()                    # ensure snapshot loaded for this path
    with _LOCK:
        if _DISK is None:
            return
        entry = {"csize": cfg.csize, "backend": cfg.backend,
                 "blk_m": cfg.blk_m, "time_s": round(cfg.time_s, 6),
                 "torch": torch.__version__,
                 "saved_at": round(time.time(), 1)}
        if cfg.dtype_policy != "fp32":
            entry["dtype_policy"] = cfg.dtype_policy
        if extra:
            entry.update(extra)
        _DISK[skey] = entry
    save_store()


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def _time_once(fn, reps: int = 3,
               deadline_s: Optional[float] = 0.25) -> float:
    """Best-of-k wall time under a deadline budget.

    One untimed call builds and warms the callable (and the kernel, at its
    first launch), then up to ``reps`` timed reps run, stopping early (after
    at least one) once ``deadline_s`` of measurement has elapsed.  ``fn``
    must return only when its work is done (the callers synchronize the
    plan's device, or read the result back to the host).  Returns the
    MINIMUM: anything above the fastest rep is scheduler/allocator noise."""
    global _PROBES_RUN
    _PROBES_RUN += 1
    fn()                                 # build + warmup
    best = float("inf")
    t_start = time.perf_counter()
    for _ in range(max(1, int(reps))):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
        _PROBES_RUN += 1
        if (deadline_s is not None
                and time.perf_counter() - t_start >= deadline_s):
            break
    return best


def _synced(fn, device: torch.device):
    """fn, then a wait for the device's queued work: an offline probe's
    time is the work's, not its enqueue's."""
    if device.type != "cuda":
        return fn

    def run():
        fn()
        torch.cuda.synchronize(device)
    return run


def _kernel_fault(bk: str, device, c: int, bm, err: Exception) -> None:
    """Raise where a sweep may not skip a failed candidate: on a CUDA
    device the grid holds only ``cuda`` candidates that ``can_run``
    accepts, so one that raises is a kernel that did not build or launch,
    not an infeasible configuration.  Skipping it would let a vmap
    candidate win on the card without a word."""
    if bk == "cuda" and torch.device(device).type == "cuda":
        raise RuntimeError(
            f"autotune: the cuda candidate (csize={c}, blk_m={bm}) raised "
            f"on {device}: {type(err).__name__}: {err}") from err


def _mesh_group(mesh):
    """The process group over every dim of a mesh of more than one rank,
    else None."""
    if mesh is None or mesh.size() == 1:
        return None
    from repro_torch.core.distributed import _group
    return _group(mesh, tuple(mesh.mesh_dim_names))


def _mesh_max(group, mesh, values) -> list:
    """Each of ``values`` reduced with MAX over ``group``: one SPMD
    program's wall time is its slowest rank's, and a flag raised on one
    rank is raised on all."""
    import torch.distributed as dist
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t.tolist()


def _probe_m(m, probe_m: int = 32) -> int:
    mm = int(m) if m else probe_m
    return max(8, min(mm, probe_m * 4))


def _telemetry_hint(fp: str, n: int, symmetric: bool, workload: str,
                    mesh=None, device=None):
    """(backend, csize, blk_m) of the best live-traffic measurement for this
    (f, n, symmetric, workload, mesh, device), or None.  Seeds the sweep
    order so a tight deadline still probes the known-good configuration
    first.  Keyed like the resolve-time consult: history of another mesh or
    device never reorders this sweep."""
    from .registry import execution_stats
    best, best_us = None, float("inf")
    for rec in execution_stats():
        if rec.get("workload") != workload:
            continue
        sig = rec.get("signature")
        try:
            sf, sn, sc, ssym, _sbk, smesh, sdev, _swl, sopts = sig
        except (TypeError, ValueError):
            continue
        if (sn != n or bool(ssym) != bool(symmetric) or smesh != mesh
                or sdev != device):
            continue
        try:
            if function_fingerprint(sf) != fp:
                continue
        except Exception:
            continue
        us = min((b["us_per_point_min"] for b in rec["by_bucket"].values()),
                 default=None)
        if us is not None and us < best_us:
            blk_m = dict(sopts).get("blk_m") if sopts else None
            best = (rec["backend"], int(sc), blk_m)
            best_us = us
    return best


def _derive(base, csize: int, backend: str, blk_m=None, dtype_policy=None):
    """``base`` with csize, backend and the blk_m / dtype_policy options
    replaced: how every probe plan and every hot-swapped bucket plan is
    built, so that equal configurations give equal cache keys."""
    opts = {k: v for k, v in base.options
            if k not in ("blk_m", "dtype_policy")}
    if blk_m:
        opts["blk_m"] = int(blk_m)
    if dtype_policy and dtype_policy != "fp32":
        opts["dtype_policy"] = dtype_policy
    return dataclasses.replace(base, csize=int(csize), backend=backend,
                               options=tuple(sorted(opts.items())))


def _combo_grid(fp: str, base, workload: str,
                pinned_blk_m: Optional[int] = None):
    """The joint candidate grid for the probe plan ``base`` (its n, probe m,
    symmetric, backend, mesh, device and options), in measurement order:
    telemetry hint first, then the §5 model argmin, then the rest by static
    priority.  ``cuda`` sweeps ``blk_m`` over ``[None] + instance_blocks``
    of ``backend_form(f, n)`` at each csize (None: the wrapper's own
    choice, so today's configuration is always in the grid); other
    backends take ``[None]``.  A caller-pinned
    blk_m is honored, not swept: on a card plan it stays in the tuned plan
    whatever backend wins, so only the csizes that take it are swept.
    Candidates that ``can_run`` refuses are left out."""
    from repro_torch.kernels.chess_hvp import (instance_blocks,
                                               is_instance_block)
    from repro_torch.kernels.ops import backend_form
    from repro_torch.kernels.trace import TraceRefused

    from .registry import get_backend, list_backends
    n, symmetric, mesh = base.n, base.symmetric, base.mesh
    if workload == "diag":
        # the probe-chunk axis: divisors of the plan's n_probes
        n_probes = int(base.opt("n_probes", 4))
        csizes = opmodel.probe_csize_candidates(n_probes)
        argmin = opmodel.model_csize_probes(n_probes)
    elif n is None:
        # example-based pytree probe of a non-chunked path: csize inert
        csizes, argmin = [4], 4
    else:
        csizes = opmodel.pruned_csize_candidates(n, symmetric)
        argmin = opmodel.model_csize(n, symmetric)
    csizes = [argmin] + [c for c in csizes if c != argmin]
    # the form the cuda backend runs f on (a card plan's only: the kernel
    # never runs on another device, whose cuda candidates can_run drops)
    form = None
    if n is not None and base.device.type == "cuda":
        try:
            form = backend_form(base.f, n)
        except TraceRefused:
            pass
    if pinned_blk_m is not None and base.device.type == "cuda":
        csizes = [c for c in csizes
                  if is_instance_block(form, n, c, pinned_blk_m)]

    if mesh is not None:
        # never steal a mesh plan from the mesh-native backends: csize-only
        # sweep through the plan-level "auto" resolution, which is
        # topology-aware (batched_hvp -> sharded, hvp/hessian ->
        # sharded_rows); the winner is recorded mesh-keyed in the memo and
        # never persisted
        backends = ["auto"]
    elif base.backend != "auto":
        backends = [base.backend]
    else:
        # requires_mesh backends are skipped: a flat sweep has no mesh to
        # run them on
        backends = [
            name for name, s in sorted(list_backends().items(),
                                       key=lambda kv: -kv[1].priority)
            if workload in s.workloads and not s.requires_mesh
            and name != "reference"]

    combos = []
    for bk in backends:
        for c in (csizes if _csize_swept(bk, workload) else csizes[:1]):
            if bk != "cuda":
                blk_ms = [None]
            elif pinned_blk_m is not None:
                blk_ms = [int(pinned_blk_m)]
            else:
                blk_ms = [None] + (instance_blocks(form, n, c)
                                   if form is not None else [])
            for bm in blk_ms:
                if bk == "auto" or get_backend(bk).can_run(
                        _derive(base, c, bk, bm, base.opt("dtype_policy")),
                        workload):
                    combos.append((bk, c, bm))

    # a mesh of several ranks sweeps one grid in one order on every rank:
    # each rank's telemetry is its own, so no hint reorders it
    hint = (None if _mesh_group(mesh) is not None else
            _telemetry_hint(fp, n, symmetric, workload, mesh, base.device))
    if hint is not None:
        if hint in combos:
            combos.remove(hint)
            combos.insert(0, hint)
        else:
            # recorded plans often carry no blk_m option, and mesh sweeps
            # carry combos under backend "auto" while telemetry records the
            # RESOLVED backend name -- fall back to a (backend, csize) match
            for i, (bk, c, _bm) in enumerate(combos):
                if (bk == hint[0] or bk == "auto") and c == hint[1]:
                    combos.insert(0, combos.pop(i))
                    break
    return combos


# ---------------------------------------------------------------------------
# the joint tuner
# ---------------------------------------------------------------------------

def autotune(f, n, m=None, symmetric: bool = False,
             backend: str = "auto", mesh=None, options=(),
             workload: str = "batched_hvp", probe_m: int = 32,
             reps: int = 3, seed: int = 0,
             deadline_s: Optional[float] = None,
             rep_deadline_s: Optional[float] = 0.25,
             use_store: bool = True, device="cuda",
             example=None) -> TunedConfig:
    """Measured argmin over the joint (csize, backend, blk_m) grid for
    ``workload`` of ``f`` at dimension n, on ``device`` (the card unless
    the caller asks for the CPU, as ``plan()``).

    Resolution order: in-memory memo -> on-disk store (no probes run on a
    hit -- the persistence contract) -> microbenchmark sweep.  The sweep
    builds each candidate and wall-clocks it best-of-``reps`` on a seeded
    probe batch of ``_probe_m(m)`` rows already on the device,
    synchronizing the device after every call; ``deadline_s`` bounds the
    WHOLE sweep (the telemetry-hinted and model-argmin candidates go first,
    so an exhausted budget still returns a sensible winner),
    ``rep_deadline_s`` each candidate's timed reps.  A candidate that
    raises is skipped and listed in the winner's ``failures``; if EVERY
    candidate fails the configuration is broken and a RuntimeError chains
    the last error.  A ``cuda`` candidate that raises on a CUDA device is
    not skipped: it is a kernel fault, and raises (``_kernel_fault``).
    On a mesh of several ranks every rank must call it (``plan()`` does):
    the sweep is one SPMD program, each candidate run ``reps`` times on
    every rank, its time the MAX over the mesh and its failure any rank's,
    so every rank takes the same winner.

    Memoized on (fingerprint, n, workload, probe m, symmetric, backend,
    mesh, options, device); persisted (mesh-less plans only) under
    (fingerprint, n, workload, symmetric, probe m, backend, platform of the
    device) -- options shape the probe but are not part of the persistent
    key.  ``plan(csize="autotune")`` tunes batched_hvp when an m hint is
    given, else hvp.

    Pytree plans (n=None) tune by passing ``example``, a representative
    parameter tree the probes run against, on ``device``:
    ``workload="diag"`` sweeps the probe-chunk csize of the chunked
    Hutchinson path (seed ``seed``), ``"hvp"`` the backend choice.  Such
    tunes are memoized in-process (keyed on the tree's spec) but NOT
    persisted: the tree's structure and the probe options are not part of
    the store key, so a disk hit could answer for the wrong instance."""
    from .plan import resolve_device
    from .plan import plan as make_plan

    if workload not in _TUNABLE_WORKLOADS:
        raise ValueError(f"cannot autotune workload {workload!r}")
    if backend != "auto":
        from .registry import get_backend
        get_backend(backend)            # fail fast on typos
    spec = None
    if example is not None:
        from .pytree import spec_of
        if workload not in ("hvp", "diag"):
            raise ValueError(f"example-based tuning serves the per-point "
                             f"pytree workloads (hvp, diag), not "
                             f"{workload!r}")
        spec = spec_of(example)
        n = None if n is None else int(n)
    elif n is None:
        raise ValueError("autotune: n=None requires a representative "
                         "``example`` parameter tree to probe against")
    else:
        n = int(n)
    device = resolve_device(device)
    mm = _probe_m(m, probe_m)
    options = tuple(options)
    fp = function_fingerprint(f)

    # example-based tunes key on the tree's spec as well: two structures
    # of equal size never share a memo slot
    key = (fp, n, workload, mm, bool(symmetric), backend, mesh, options,
           device, spec)
    with _LOCK:
        hit = _AUTOTUNE_CACHE.get(key)
        if hit is not None:
            _AUTOTUNE_CACHE.move_to_end(key)
            return hit

    skey = _store_key(fp, n, workload, symmetric, mm, backend,
                      _platform(device))
    persistable = (use_store and mesh is None and spec is None
                   and _persist_enabled())
    if persistable:
        entry = load_store().get(skey)
        cfg = _cfg_from_entry(entry, "disk") if entry else None
        if cfg is not None and _feasible(cfg, workload):
            _remember(key, skey, cfg,
                      consultable=(backend == "auto"
                                   and cfg.backend != "auto"))
            return cfg

    # a pinned blk_m goes to the grid, which keeps it to the csizes that
    # take it, and not to the csize-1 probe plan
    pinned_blk_m = dict(options).get("blk_m")
    base = make_plan(f, n, m=mm, csize=1, backend=backend,
                     symmetric=symmetric, mesh=mesh, device=device,
                     options={k: v for k, v in options if k != "blk_m"})
    # seeded probe operands, on the device before any clock starts
    if spec is None:
        rng = np.random.RandomState(seed)
        A = torch.as_tensor(np.asarray(rng.uniform(-2, 2, (mm, n)),
                                       np.float32), device=device)
        V = torch.as_tensor(np.asarray(rng.randn(mm, n), np.float32),
                            device=device)
        probe_a, probe_v = A[0], V[0]
    else:
        probe_a = base._tree(example)
        probe_v = torch.utils._pytree.tree_map(torch.ones_like, probe_a)

    best = None
    last_err = None
    trials, failures = [], []
    # a mesh of several ranks runs the sweep as one SPMD program: every
    # rank runs the same candidates in the same order with a fixed number
    # of reps (the collectives inside a candidate pair up), and every
    # decision is agreed over the mesh
    spmd = _mesh_group(mesh)
    if spmd is not None:
        rep_deadline_s = None
    t_sweep = time.perf_counter()
    for bk, c, bm in _combo_grid(fp, base, workload,
                                 pinned_blk_m=pinned_blk_m):
        if deadline_s is not None and best is not None:
            late = time.perf_counter() - t_sweep >= deadline_s
            if spmd is not None:
                late = _mesh_max(spmd, mesh, [late])[0] > 0
            if late:
                break
        err = None
        try:
            p = _derive(base, c, bk, bm, base.opt("dtype_policy"))
            if workload == "batched_hvp":
                run = functools.partial(p.batched_hvp, A, V)
            elif workload == "hvp":
                run = functools.partial(p.hvp, probe_a, probe_v)
            elif workload == "diag":
                run = functools.partial(p.diag, probe_a, seed)
            else:
                run = functools.partial(p.hessian, probe_a)
            t = _time_once(_synced(run, device), reps=reps,
                           deadline_s=rep_deadline_s)
        except Exception as e:   # a single infeasible candidate is fine
            _kernel_fault(bk, device, c, bm, e)
            err, t = e, float("inf")
        if spmd is not None:
            # the slowest rank's time; a failure on any rank fails all
            t, failed = _mesh_max(spmd, mesh, [t, err is not None])
            if failed and err is None:
                err = RuntimeError("the candidate raised on another rank")
        if err is not None:
            last_err = err
            failures.append((bk, c, bm, f"{type(err).__name__}: {err}"))
            continue
        trials.append((bk, c, bm, t))
        if best is None or t < best[3]:
            best = (bk, c, bm, t)
    if best is None:
        # EVERY candidate failed: f/backend/mesh is broken, not untuned
        raise RuntimeError(
            f"autotune: no (csize, backend, blk_m) candidate ran for n={n}, "
            f"backend={backend!r} on {device}") from last_err
    bk, c, bm, t = best
    best = TunedConfig(csize=c, backend=bk, blk_m=bm, time_s=t,
                       source="sweep", trials=tuple(trials),
                       failures=tuple(failures),
                       sweep_s=time.perf_counter() - t_sweep)
    _remember(key, skey, best,
              consultable=(backend == "auto" and mesh is None
                           and spec is None and best.backend != "auto"))
    if persistable:
        _persist(skey, best)
    return best


def _feasible(cfg: TunedConfig, workload: str) -> bool:
    """A restored record must name a live backend that still serves the
    workload (registry contents can change across versions)."""
    if cfg.backend == "auto":
        return True
    try:
        from .registry import get_backend
        return workload in get_backend(cfg.backend).workloads
    except KeyError:
        return False


def _remember(key, skey: str, cfg: TunedConfig, *, consultable: bool) -> None:
    global _TUNED_VERSION
    with _LOCK:
        _AUTOTUNE_CACHE[key] = cfg
        while len(_AUTOTUNE_CACHE) > AUTOTUNE_CACHE_MAXSIZE:
            _AUTOTUNE_CACHE.popitem(last=False)
        # only concrete joint winners steer backend="auto" resolution: a
        # mesh sweep resolves per-plan (cfg.backend == "auto") and its store
        # key omits the mesh, so writing it would clobber the flat plan's
        # winner for the same (f, n, workload)
        if consultable:
            _TUNED[skey] = cfg
            _TUNED_VERSION += 1


def lookup_tuned(plan, workload: str) -> Optional[TunedConfig]:
    """The joint-tune winner matching a plan's signature (flat, mesh-less,
    backend swept as "auto", the platform of the plan's device), or None.
    This is the consult ``registry.resolve_backend`` performs for
    ``backend="auto"`` plans -- it never runs a probe, only reads the
    in-memory table and the disk snapshot."""
    if plan.n is None or plan.mesh is not None:
        return None
    if workload not in _TUNABLE_WORKLOADS:
        return None
    fp = function_fingerprint(plan.f)
    skey = _store_key(fp, plan.n, workload, plan.symmetric,
                      _probe_m(plan.m), "auto", _platform(plan.device))
    with _LOCK:
        cfg = _TUNED.get(skey)
    if cfg is not None:
        return cfg
    if not _persist_enabled():
        return None
    entry = load_store().get(skey)
    if not entry:
        return None
    cfg = _cfg_from_entry(entry, "disk")
    if cfg is None or not _feasible(cfg, workload):
        return None
    global _TUNED_VERSION
    with _LOCK:
        _TUNED[skey] = cfg
        _TUNED_VERSION += 1
    return cfg


def autotune_csize(f, n: int, m=None, symmetric: bool = False,
                   backend: str = "auto", mesh=None, options=(),
                   workload: str = "batched_hvp", probe_m: int = 32,
                   reps: int = 3, seed: int = 0, device="cuda") -> int:
    """Measured argmin csize (facade over the joint tuner: same sweep,
    returns only the chunk size).  See ``autotune``."""
    return autotune(f, n, m=m, symmetric=symmetric, backend=backend,
                    mesh=mesh, options=options, workload=workload,
                    probe_m=probe_m, reps=reps, seed=seed,
                    device=device).csize


# ---------------------------------------------------------------------------
# dtype-policy guardrail (the fwd-fwd oracle accuracy assertion)
# ---------------------------------------------------------------------------

def verify_dtype_policy(plan, workload: str = "batched_hvp", m: int = 8,
                        seed: int = 0, tol: Optional[float] = None,
                        raise_on_reject: bool = True) -> float:
    """Normalized L2 error of a plan's dual dtype policy against the
    forward-over-forward oracle on a seeded probe batch.

    The oracle runs the SAME f at the same points through the reference
    backend in full input precision, on the plan's device; the candidate
    runs the plan's own configuration (backend, csize, policy).  Error
    above ``tol`` (default: the plan's ``dtype_tol`` option, else
    ``DEFAULT_DTYPE_TOL``) raises ``DtypePolicyRejected`` -- a too-lossy
    policy is rejected, never silently kept.  Returns the measured error
    (0.0 for the exact "fp32" policy, which needs no probe)."""
    policy = plan.opt("dtype_policy", "fp32")
    if policy == "fp32":
        return 0.0
    if tol is None:
        tol = float(plan.opt("dtype_tol", DEFAULT_DTYPE_TOL))
    if plan.n is None:
        raise ValueError("dtype policies apply to flat (hDual) plans")
    from .plan import plan as make_plan
    n = int(plan.n)
    rng = np.random.RandomState(seed)
    A = np.asarray(rng.uniform(-2, 2, (int(m), n)), np.float32)
    V = np.asarray(rng.randn(int(m), n), np.float32)
    # the oracle plan drops the policy (and the instance-block dial): exact
    # duals through the reference backend
    clean = tuple(sorted((k, v) for k, v in plan.options
                         if k not in ("dtype_policy", "blk_m")))
    oracle = make_plan(plan.f, n, m=int(m), csize=1,
                       symmetric=plan.symmetric, backend="reference",
                       device=plan.device, options=dict(clean))
    if workload in ("batched_hvp", "hvp"):
        out = plan.batched_hvp(A, V)
        ref = oracle.batched_hvp(A, V)
    elif workload in ("batched_hessian", "hessian"):
        out = plan.batched_hessian(A)
        ref = oracle.batched_hessian(A)
    else:
        raise ValueError(f"cannot verify dtype policy for {workload!r}")
    out = out.detach().cpu().double().numpy()
    ref = ref.detach().cpu().double().numpy()
    err = float(np.linalg.norm(out - ref) / (np.linalg.norm(ref) + 1e-30))
    if raise_on_reject and not err <= tol:
        raise DtypePolicyRejected(
            f"dtype_policy={policy!r} rejected for "
            f"{getattr(plan.f, '__name__', plan.f)!r} (n={n}): normalized "
            f"oracle error {err:.3e} exceeds tolerance {tol:.3e}")
    return err


# ---------------------------------------------------------------------------
# the online bucket-aware tuner (the service's steady-state controller)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BucketTunedConfig:
    """The joint winner for ONE observed service bucket: configuration plus
    its measured us/point at exactly that batch shape.  ``rejected`` lists
    (policy, error) pairs the oracle guardrail refused during this sweep."""
    bucket: int
    csize: int
    backend: str
    blk_m: Optional[int]
    dtype_policy: str
    us_per_point: float
    source: str                     # "sweep" | "disk"
    rejected: tuple = ()


def apply_bucket_config(base_plan, cfg: BucketTunedConfig):
    """The executable plan a bucket winner denotes: the base plan with the
    tuned csize/backend and the tuned blk_m / dtype_policy options.

    Built EXACTLY like the tuner's own probe plans (``_derive``), so the
    derived plan's cache key equals the probed plan's key -- the winning
    callable is already built (and its kernel loaded) when the service
    hot-swaps to it."""
    return _derive(base_plan, cfg.csize, cfg.backend, cfg.blk_m,
                   cfg.dtype_policy)


def _bucket_store_key(fp: str, n: int, workload: str, symmetric: bool,
                      bucket: int, backend: str, platform: str) -> str:
    # "svc" marks per-bucket online winners: same store file, disjoint key
    # space from the offline probe-m records (whose m is _probe_m-clamped,
    # not an observed bucket)
    return _store_key(fp, n, workload, symmetric, int(bucket), backend,
                      platform) + "|svc"


def _bucket_cfg_from_entry(entry, bucket: int) -> Optional[BucketTunedConfig]:
    if not isinstance(entry, dict):
        return None
    cfg = _cfg_from_entry(entry, "disk")
    if cfg is None:
        return None
    return BucketTunedConfig(
        bucket=int(bucket), csize=cfg.csize, backend=cfg.backend,
        blk_m=cfg.blk_m, dtype_policy=cfg.dtype_policy,
        us_per_point=float(entry.get("us_per_point", 0.0)), source="disk")


def _served_window(p, workload: str, A, V):
    """One bucket timed as the dispatcher times it: the operands already on
    the plan's device, then the cached callable, then the result read back
    to host numpy (``serving.dispatch.Dispatcher.execute``)."""
    from repro_torch.serving.dispatch import _on_device, _readback

    def run():
        with _on_device(p.device):
            exe = p.executable(workload)
            return _readback(exe(A, V) if workload == "batched_hvp"
                             else exe(A))[0]
    return run


def autotune_buckets(f, n: int, buckets, *, symmetric: bool = False,
                     backend: str = "auto", options=(),
                     workload: str = "batched_hvp", reps: int = 3,
                     seed: int = 0, deadline_s: Optional[float] = None,
                     rep_deadline_s: Optional[float] = 0.25,
                     dtype_policies=None, use_store: bool = True,
                     force: bool = False, device="cuda") -> dict:
    """Joint (csize, backend, blk_m, dtype_policy) sweep at the OBSERVED
    service bucket sizes -- the online half of the tuner, and the
    ``CurvatureService``'s default tuner.

    ``buckets`` is an iterable of bucket sizes or a ``{bucket: weight}``
    traffic mix; heavier buckets are swept first and get a proportional
    share of ``deadline_s``.  Each bucket's candidates run at exactly
    (bucket, n) on ``device``, in the dispatcher's timing window (operands
    on the device before the clock starts, the result read back to host
    numpy before it stops), so the objective is the real per-bucket
    us/point the service's drift detector compares against.  A ``cuda``
    candidate that raises on a CUDA device raises the sweep (as in
    ``autotune``), so the service counts a re-tune error and swaps nothing.

    The dtype-policy axis defaults to ("fp32", "bf16"), as the
    reference's: a served bucket may be swapped to bf16 duals on a vmap
    backend (``cuda`` is fp32 only), whose results are approximate, within
    the plan's ``dtype_tol`` (default ``DEFAULT_DTYPE_TOL``, a normalized
    error of 5e-2).  Every non-exact policy is pre-verified against the
    fwd-fwd oracle under that tolerance and REJECTED from the grid on
    failure (recorded in the returned configs' ``rejected``); pass
    ``dtype_policies=("fp32",)`` or pin ``dtype_policy`` to keep results
    exact.  A policy pinned in ``options`` is
    honored but still verified -- failing the guard raises
    ``DtypePolicyRejected``.

    Winners persist per (fingerprint, n, workload, symmetric, bucket,
    backend, platform) in the same JSON store as the offline tuner (key
    suffix "svc"): a fresh service warm-starts its per-bucket hot-swap map
    with zero probes.  ``force=True`` ignores stored winners (the drift
    re-tune path) and overwrites them with fresh measurements.

    Returns ``{bucket: BucketTunedConfig}``."""
    from repro_torch.serving.dispatch import _to_device

    from .plan import resolve_device
    from .plan import plan as make_plan
    from .registry import get_backend

    if workload not in ("batched_hvp", "batched_hessian"):
        raise ValueError(
            f"autotune_buckets serves the coalesced flat workloads "
            f"(batched_hvp, batched_hessian), not {workload!r}")
    n = int(n)
    device = resolve_device(device)
    options = tuple(sorted(dict(options).items()))
    opts_d = dict(options)
    if isinstance(buckets, dict):
        mix = {int(b): float(w) for b, w in buckets.items() if w > 0}
    else:
        mix = {int(b): 1.0 for b in buckets}
    if not mix or min(mix) < 1:
        raise ValueError(f"buckets must be positive sizes, got {buckets!r}")
    order = sorted(mix, key=lambda b: (-mix[b], b))
    fp = function_fingerprint(f)
    platform = _platform(device)

    pinned_policy = opts_d.get("dtype_policy")
    if dtype_policies is None:
        dtype_policies = (pinned_policy,) if pinned_policy else \
            ("fp32", "bf16")
    dtype_policies = tuple(dtype_policies)

    out: dict = {}
    to_sweep = []
    for b in order:
        skey = _bucket_store_key(fp, n, workload, symmetric, b, backend,
                                 platform)
        if use_store and not force and _persist_enabled():
            cfg = _bucket_cfg_from_entry(load_store().get(skey, None), b)
            if cfg is not None and _feasible(cfg, workload):
                out[b] = cfg
                continue
        to_sweep.append((b, skey))
    if not to_sweep:
        return out

    # oracle guardrail, once per call on the heaviest swept bucket: the
    # policy's error is a property of (f, dtype), not of the batch shape
    rejected = []
    kept_policies = []
    guard_b = to_sweep[0][0]
    tol = float(opts_d.get("dtype_tol", DEFAULT_DTYPE_TOL))
    for pol in dtype_policies:
        if pol in (None, "fp32"):
            kept_policies.append("fp32")
            continue
        try:
            probe = make_plan(f, n, m=guard_b, csize=1, backend="auto",
                              symmetric=symmetric, device=device,
                              options={**{k: v for k, v in opts_d.items()
                                          if k != "blk_m"},
                                       "dtype_policy": pol})
            err = verify_dtype_policy(probe, workload=workload, m=guard_b,
                                      seed=seed, raise_on_reject=False)
        except Exception:
            if pol == pinned_policy:
                raise
            rejected.append((pol, float("inf")))
            continue
        if err <= tol:
            kept_policies.append(pol)
        else:
            rejected.append((pol, err))
            if pol == pinned_policy:
                raise DtypePolicyRejected(
                    f"pinned dtype_policy={pol!r} rejected for "
                    f"{getattr(f, '__name__', f)!r} (n={n}): error "
                    f"{err:.3e} > tolerance {tol:.3e}")
    rejected = tuple(rejected)
    if not kept_policies:
        kept_policies = ["fp32"]

    rng = np.random.RandomState(seed)
    w_sweep = sum(mix[b] for b, _ in to_sweep) or 1.0
    for b, skey in to_sweep:
        budget = (deadline_s * mix[b] / w_sweep
                  if deadline_s is not None else None)
        A = np.asarray(rng.uniform(-2, 2, (b, n)), np.float32)
        V = np.asarray(rng.randn(b, n), np.float32)
        A, V = _to_device(A, device), _to_device(V, device)
        base = make_plan(f, n, m=b, csize=1, backend=backend,
                         symmetric=symmetric, device=device,
                         options={k: v for k, v in opts_d.items()
                                  if k not in ("dtype_policy", "blk_m")})
        best = None
        last_err = None
        t_sweep = time.perf_counter()
        for bk, c, bm in _combo_grid(fp, base, workload,
                                     pinned_blk_m=opts_d.get("blk_m")):
            if (budget is not None and best is not None
                    and time.perf_counter() - t_sweep >= budget):
                break
            bk_policies = [p for p in kept_policies
                           if p == "fp32"
                           or p in get_backend(bk).dtype_policies]
            for pol in bk_policies:
                try:
                    p = _derive(base, c, bk, bm, pol)
                    t = _time_once(_served_window(p, workload, A, V),
                                   reps=reps, deadline_s=rep_deadline_s)
                except Exception as e:
                    _kernel_fault(bk, device, c, bm, e)
                    last_err = e
                    continue
                us_pp = t / b * 1e6
                if best is None or us_pp < best.us_per_point:
                    best = BucketTunedConfig(
                        bucket=b, csize=c, backend=bk, blk_m=bm,
                        dtype_policy=pol, us_per_point=us_pp,
                        source="sweep", rejected=rejected)
        if best is None:
            raise RuntimeError(
                f"autotune_buckets: no candidate ran for n={n}, "
                f"bucket={b}, backend={backend!r} on {device}") from last_err
        out[b] = best
        if use_store and _persist_enabled():
            _persist(skey, TunedConfig(
                csize=best.csize, backend=best.backend, blk_m=best.blk_m,
                time_s=best.us_per_point * b / 1e6, source="sweep",
                dtype_policy=best.dtype_policy),
                extra={"us_per_point": round(best.us_per_point, 4)})
    return out
