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
  "batched_hvp_ragged" (A, V, NE) -> R     mixed-n HVP rows padded to one
                                           (m, n_pad) bucket; NE[i] is row
                                           i's effective n (serving)
  "diag"            (params, key) -> tree  Hutchinson diag estimate
  "quadform"        (params, v, w) -> s    w^T H v
  "ggn" / "fisher"  (params, v) -> tree    structured curvature products
  "batched_diag"    (A, K, P) -> R         raveled param rows, seed rows,
                                           per-row probe budgets (serving)

``backend="auto"`` decides by topology (a mesh-carrying plan narrows to the
mesh-native backends), then by what it learned (``_learned_backend``: the
joint autotuner's persisted winner for the plan's signature, then the
execution telemetry the serving dispatcher writes through
``record_execution``), and only then by static priority.  Learned history is
keyed on the plan's device as well as its mesh, so history recorded on the
CPU never steers a plan on the card, nor the other way round.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch import obs

__all__ = [
    "BackendSpec", "register_backend", "get_backend", "list_backends",
    "resolve_backend", "WORKLOADS", "DTYPE_POLICIES", "policy_compute_dtype",
    "record_execution", "execution_stats", "client_stats",
    "bucket_telemetry", "clear_telemetry",
]

WORKLOADS = ("hvp", "hessian", "batched_hvp", "batched_hessian", "diag",
             "quadform", "ggn", "fisher", "batched_diag",
             "batched_hvp_ragged")

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
    csize, the form of f): it returns True, or False or a string saying
    why, which the error of an explicit backend that cannot run quotes."""
    name: str
    make: Callable
    workloads: frozenset
    priority: int = 0
    requires_mesh: bool = False
    flat_only: bool = True
    supports: Optional[Callable] = None
    doc: str = ""
    dtype_policies: frozenset = frozenset({"fp32"})

    def refusal(self, plan, workload: str):
        """None where the backend can run (plan, workload); else False, or
        a string saying why (``supports``')."""
        if (workload not in self.workloads
                or (self.requires_mesh and plan.mesh is None)
                or (self.flat_only and plan.n is None)
                or plan.opt("dtype_policy", "fp32") not in self.dtype_policies):
            return False
        if self.supports is not None:
            ok = self.supports(plan, workload)
            if isinstance(ok, str) or not ok:
                return ok or False
        return None

    def can_run(self, plan, workload: str) -> bool:
        return self.refusal(plan, workload) is None


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
    import repro_torch.core.curvature  # noqa: F401  (pytree backends)
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
    mesh-native backends when any is capable; within the candidates, learned
    history is consulted (``_learned_backend``: the joint autotuner's
    winner, then device- and mesh-keyed execution telemetry), and only then
    the highest priority wins (ties by name)."""
    _ensure_builtin_backends()
    if plan.backend != "auto":
        spec = get_backend(plan.backend)
        why = spec.refusal(plan, workload)
        if why is not None:
            raise ValueError(
                f"backend {spec.name!r} cannot run workload {workload!r} "
                f"for plan {plan.describe()}" + (f": {why}" if why else ""))
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
    learned = _learned_backend(plan, workload, candidates)
    if learned is not None:
        return learned
    return max(candidates, key=lambda s: (s.priority, s.name))


# ---------------------------------------------------------------------------
# execution telemetry
# ---------------------------------------------------------------------------
#
# Every executed bucket can be reported here: (plan signature, backend,
# workload) -> measured us/point samples, tagged with the padded bucket size.
# The serving dispatcher records each dispatch; the service's online re-tune
# reads the per-bucket window (``bucket_telemetry``), and ``backend="auto"``
# resolution consults the per-signature best (``_learned_backend``).

_TELEMETRY_MAXSAMPLES = 256          # ring buffer per (signature, bucket)
_TELEMETRY: collections.OrderedDict = collections.OrderedDict()
_TELEMETRY_MAXKEYS = 512             # keys strong-reference f: LRU-bound
_TELEMETRY_VERSION = 0               # bumps on mutation (consult memo)
_TELEMETRY_LOCK = threading.Lock()
# decay/expiry of the consult-path best: one transient fast (or slow)
# measurement must not pin backend="auto" forever, so the best a signature
# advertises is the minimum over its most recent _TELEMETRY_WINDOW samples,
# each inflated by 2**(age / halflife) -- sample-count rollover AND
# wall-clock age both un-pin a stale winner.
_TELEMETRY_WINDOW = 64               # samples the consult best considers
_TELEMETRY_HALFLIFE_S = 600.0        # age doubling period for old samples
_TELEMETRY_DRIFT = 1.05              # upward best drift tolerated silently
_BUCKET_RECENT = 32                  # timestamped window per (sig, bucket)

# per-client serving totals: the dispatcher tags every executed bucket with
# the clients whose rows it carried (points = real rows served, batches =
# buckets the client had at least one row in)
_CLIENT_TOTALS: dict = {}


def clear_telemetry() -> None:
    global _TELEMETRY_VERSION
    with _TELEMETRY_LOCK:
        _TELEMETRY.clear()
        _CLIENT_TOTALS.clear()
        _TELEMETRY_VERSION += 1


class _ExecMetrics:
    """Cached children for the execution emit (once per executed BUCKET,
    not per request).  Only the us/point distribution and the execution
    count are written here; per-client totals are served by the
    scrape-time ``_collect_clients`` collector over ``client_stats()``."""

    __slots__ = ("_exec", "_us", "_by_bw")

    def __init__(self):
        reg = obs.default_registry()
        self._exec = reg.counter(
            "repro_executions_total", "Executed buckets by executable.",
            labelnames=("backend", "workload"))
        self._us = reg.histogram(
            "repro_execution_us_per_point",
            "Measured microseconds per real point per executed bucket.",
            labelnames=("backend", "workload"))
        self._by_bw = {}

    def children(self, backend: str, workload: str):
        key = (backend, workload)
        ent = self._by_bw.get(key)
        if ent is None:
            ent = self._by_bw[key] = (
                self._exec.child(backend=backend, workload=workload),
                self._us.child(backend=backend, workload=workload))
        return ent


_EXEC_MX = None


def _exec_mx() -> _ExecMetrics:
    global _EXEC_MX
    if _EXEC_MX is None:
        _EXEC_MX = _ExecMetrics()
    return _EXEC_MX


def _flush_exec_mx() -> None:
    global _EXEC_MX
    _EXEC_MX = None


obs.on_reset(_flush_exec_mx)


def _collect_clients(reg) -> None:
    """Scrape-time collector: per-client serving totals as views over the
    ``client_stats()`` telemetry the dispatcher already maintains."""
    if not obs.enabled():
        return
    totals = client_stats()
    if not totals:
        return
    pts = reg.counter("repro_client_points_total",
                      "Rows executed on behalf of each client.",
                      labelnames=("client",))
    bat = reg.counter("repro_client_batches_total",
                      "Buckets that carried at least one row of each "
                      "client.", labelnames=("client",))
    for cid, tot in totals.items():
        pts.child(client=cid).set(tot["points"])
        bat.child(client=cid).set(tot["batches"])


obs.default_registry().set_collector("engine.clients", _collect_clients)


def record_execution(signature, backend: str, workload: str, *,
                     bucket: int, n_points: int, elapsed_s: float,
                     now: Optional[float] = None,
                     clients: Optional[dict] = None) -> None:
    """Record one executed bucket: ``n_points`` real points served by an
    executable padded to ``bucket`` rows in ``elapsed_s`` seconds.

    ``signature`` is the plan's executable cache key (hashable); us/point is
    charged to the REAL points, so padding waste shows up as a higher
    us/point at ragged sizes.  Thread-safe: dispatch workers call this from
    their own threads.  ``now`` injects a clock for deterministic tests.

    The consult-path best this feeds is not monotonic: it is the minimum
    over the entry's most recent ``_TELEMETRY_WINDOW`` samples, each
    inflated by ``2 ** (age / _TELEMETRY_HALFLIFE_S)``, so a transient
    outlier un-pins once the window rolls past it or it ages out.

    ``clients`` optionally tags the bucket with ``{client_id: row_count}``
    (the serving dispatcher passes the per-client row mix): tags
    accumulate on the signature entry (``by_client``) and service-wide
    (``client_stats()``)."""
    global _TELEMETRY_VERSION
    if n_points <= 0:
        return
    t = time.monotonic() if now is None else float(now)
    us_per_point = elapsed_s / n_points * 1e6
    with _TELEMETRY_LOCK:
        entry = _TELEMETRY.get(signature)
        if entry is None:
            entry = {"backend": backend, "workload": workload,
                     "best_us": float("inf"), "by_bucket": {},
                     "by_bucket_recent": {}, "totals": {},
                     "recent": collections.deque(maxlen=_TELEMETRY_WINDOW)}
            _TELEMETRY[signature] = entry
            while len(_TELEMETRY) > _TELEMETRY_MAXKEYS:
                _TELEMETRY.popitem(last=False)
        else:
            _TELEMETRY.move_to_end(signature)
        entry["by_bucket"].setdefault(
            int(bucket), collections.deque(maxlen=_TELEMETRY_MAXSAMPLES)
        ).append(float(us_per_point))
        totals = entry["totals"].setdefault(int(bucket), [0, 0])
        totals[0] += 1
        totals[1] += int(n_points)
        # timestamped short window per bucket: what the online re-tuner's
        # drift detector reads (recent mean vs the tuned baseline)
        entry["by_bucket_recent"].setdefault(
            int(bucket), collections.deque(maxlen=_BUCKET_RECENT)
        ).append((float(us_per_point), t))
        if clients:
            by_client = entry.setdefault("by_client", collections.Counter())
            for cid, rows in clients.items():
                by_client[cid] += int(rows)
                tot = _CLIENT_TOTALS.setdefault(
                    cid, {"points": 0, "batches": 0})
                tot["points"] += int(rows)
                tot["batches"] += 1
        entry["recent"].append((float(us_per_point), t))
        best = min(us * 2.0 ** (max(0.0, t - ts) / _TELEMETRY_HALFLIFE_S)
                   for us, ts in entry["recent"])
        # bump the consult version on improvement or MATERIAL upward drift
        # (window/age rollover), but not on the continuous age creep of a
        # pinned old sample: bumping on every float change would invalidate
        # the _LEARNED_CACHE memo each bucket and put a telemetry scan back
        # on the serving hot path
        if (best < entry["best_us"]
                or best > entry["best_us"] * _TELEMETRY_DRIFT):
            entry["best_us"] = float(best)
            _TELEMETRY_VERSION += 1
    # emit the distribution OUTSIDE the telemetry lock; once per bucket,
    # so this does not scale with request rate
    if obs.enabled():
        exec_c, us_c = _exec_mx().children(backend, workload)
        exec_c.inc()
        us_c.observe(us_per_point)


def execution_stats() -> list[dict]:
    """Summarize recorded executions: one dict per plan signature with
    per-bucket ``count`` (samples kept, at most ``_TELEMETRY_MAXSAMPLES``),
    mean/min us/point over them, and the exact totals ``executions`` and
    ``points`` (real rows) since the last ``clear_telemetry``.  Plain
    data, safe to json-dump after stringifying keys."""
    out = []
    with _TELEMETRY_LOCK:
        items = [(k, {"backend": v["backend"], "workload": v["workload"],
                      "by_bucket": {b: list(s)
                                    for b, s in v["by_bucket"].items()},
                      "totals": {b: tuple(t)
                                 for b, t in v["totals"].items()}})
                 for k, v in _TELEMETRY.items()]
    for sig, entry in items:
        buckets = {}
        for b, samples in sorted(entry["by_bucket"].items()):
            executions, points = entry["totals"][b]
            buckets[b] = {
                "count": len(samples),
                "us_per_point_mean": sum(samples) / len(samples),
                "us_per_point_min": min(samples),
                "executions": executions,
                "points": points,
            }
        out.append({"signature": sig, "backend": entry["backend"],
                    "workload": entry["workload"], "by_bucket": buckets})
    return out


def client_stats() -> dict:
    """Service-wide per-client serving totals: ``{client_id: {"points",
    "batches"}}`` accumulated from every ``record_execution`` call that
    carried client tags.  Cleared by ``clear_telemetry``."""
    with _TELEMETRY_LOCK:
        return {cid: dict(tot) for cid, tot in _CLIENT_TOTALS.items()}


def bucket_telemetry(signature) -> dict:
    """Per-bucket recent telemetry for one plan signature: ``{bucket:
    {"count", "recent_us_mean", "recent_us_min", "last_t"}}`` over the
    timestamped short window (``_BUCKET_RECENT`` newest samples).  This is
    the live objective the online re-tuner compares against its learned
    winner -- ``count`` is the samples kept for the bucket (at most
    ``_TELEMETRY_MAXSAMPLES``), the ``recent_*`` fields summarize only the
    window."""
    with _TELEMETRY_LOCK:
        entry = _TELEMETRY.get(signature)
        if entry is None:
            return {}
        out = {}
        for b, samples in entry["by_bucket"].items():
            recent = list(entry["by_bucket_recent"].get(b, ()))
            info = {"count": len(samples)}
            if recent:
                us = [u for u, _t in recent]
                info.update(recent_us_mean=sum(us) / len(us),
                            recent_us_min=min(us),
                            last_t=recent[-1][1])
            out[int(b)] = info
        return out


def _telemetry_best(plan, workload: str, names: dict, fp: str):
    """The capable backend with the best recorded windowed us/point for
    this exact (f, n, csize, symmetric, mesh, device, workload) signature,
    or None.

    Signatures are the plan cache keys the dispatcher reports, ``(f, n,
    csize, symmetric, backend, mesh, device, workload, options)``; the
    function slot is matched by identity first, fingerprint second, so
    history recorded by another plan object for the same function still
    counts.  Decisions use the per-signature windowed, age-decayed best
    (``record_execution``).  History is keyed on mesh AND device: CPU
    history never promotes a pick for a plan on the card, nor the other
    way round.  Negative-priority backends never steal auto resolution
    here, however good their recorded numbers look."""
    from .autotune import function_fingerprint
    with _TELEMETRY_LOCK:
        items = [(k, v["backend"], v["workload"],
                  v.get("best_us", float("inf")))
                 for k, v in _TELEMETRY.items()]
    best_name, best_us = None, float("inf")
    for sig, backend, wl, us in items:
        spec = names.get(backend)
        if (wl != workload or spec is None or spec.priority < 0
                or not us < float("inf")):
            continue
        try:
            sf, sn, sc, ssym, _sbk, smesh, sdev = sig[:7]
        except (TypeError, ValueError):
            continue
        if (sn != plan.n or sc != plan.csize
                or bool(ssym) != plan.symmetric or smesh != plan.mesh
                or sdev != plan.device):
            continue
        if sf is not plan.f:
            try:
                if function_fingerprint(sf) != fp:
                    continue
            except Exception:   # pragma: no cover - consult must not break
                continue
        if us < best_us:
            best_name, best_us = backend, us
    return best_name


# memoized consult decisions: the learned pick for a plan signature only
# changes when the tuner's consult table or the telemetry table mutate, so
# resolve_backend (called on EVERY plan execution) pays two dict lookups on
# the steady-state path instead of a telemetry scan
_LEARNED_CACHE: collections.OrderedDict = collections.OrderedDict()
_LEARNED_CACHE_MAXSIZE = 512


def _learned_backend(plan, workload: str, candidates):
    """What ``backend="auto"`` learned about this plan: the joint
    autotuner's persisted winner first (exact csize match, so a tuned
    record never steers a differently-chunked plan), then execution
    telemetry, before static priorities get a say.

    The whole pipeline is keyed on mesh and device: the tuner's records
    carry the platform of the plan's device, telemetry only matches
    signatures of the same mesh and device, and the memo key carries both
    -- so learned history never leaks across topologies or devices."""
    if plan.n is None:
        return None
    names = {s.name: s for s in candidates}
    # name-level imports: the package re-exports the autotune FUNCTION
    # under the submodule's name
    try:
        from .autotune import (function_fingerprint, lookup_tuned,
                               tuned_version)
        fp = function_fingerprint(plan.f)
    except Exception:       # pragma: no cover - consult must never break
        return None
    key = (fp, plan.n, plan.csize, plan.symmetric, plan.m, workload,
           plan.mesh, plan.device)
    versions = (tuned_version(), _TELEMETRY_VERSION)
    with _TELEMETRY_LOCK:
        hit = _LEARNED_CACHE.get(key)
        if hit is not None and hit[0] == versions:
            _LEARNED_CACHE.move_to_end(key)
            return names.get(hit[1])

    try:
        cfg = lookup_tuned(plan, workload)
    except Exception:       # pragma: no cover - consult must never break
        cfg = None
    if (cfg is not None and cfg.backend in names
            and cfg.csize == plan.csize):
        name = cfg.backend
    else:
        name = _telemetry_best(plan, workload, names, fp)
    with _TELEMETRY_LOCK:
        _LEARNED_CACHE[key] = (versions, name)
        while len(_LEARNED_CACHE) > _LEARNED_CACHE_MAXSIZE:
            _LEARNED_CACHE.popitem(last=False)
    return names.get(name)
