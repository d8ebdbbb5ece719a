"""CurvatureService: async request coalescing over CurvaturePlan callables.

Counterpart of ``repro.engine.service``.  The paper's headline result is
0.5M *independent* HVPs evaluated as one batched program (§6-7); in a
serving setting those arrive as many small requests from many clients, not
one pre-built (m, n) array.  This module is the facade over the layered
serving stack that bridges the two (``repro_torch.serving``):

  transport  (serving/frontend.py)  line-delimited JSON over TCP; optional
  admission  (serving/admission.py) per-client token buckets, priority
                                    classes, high-water load shedding
  scheduler  (serving/scheduler.py) bounded per-plan queues, micro-bucket
                                    triggers, weighted-fair dequeue,
                                    cross-n ragged coalescing
  dispatch   (serving/dispatch.py)  worker threads that execute buckets on
                                    their plans' devices and resolve futures

``plan.submit(a, v)`` returns a future, requests accumulate in a bounded
per-plan queue, and dispatch workers coalesce them into padded
power-of-two micro-batches executed via the plan's ordinary cached
``batched_hvp`` / ``batched_hessian`` callables -- on a CUDA plan of a
function with a device form, ``batched_hvp`` is the hand-written
``chess_hvp`` kernel.

Flat HVP plans built on a ``RaggedFamily`` (``engine.plan.RaggedFamily``,
``core.testfns.ragged_family``) additionally coalesce ACROSS row widths:
when a partial bucket dispatches, the scheduler tops it up with requests
of other ``n`` from the same family, pads every row to ``n_pad = max(n)``
and runs the family's masked ``batched_hvp_ragged`` callable -- gated by
the ``opmodel.ragged_padding_waste`` model so merging never pays more than
``coalesce_waste_max`` padding.

Why power-of-two buckets: the serving stack keeps its shape set bounded --
log2(max_batch) batch shapes per plan signature -- as the reference does
for its compiled programs.  Padding replicates the last row (see
``plan.pad_rows``) and padded outputs are sliced off before futures
resolve.

The two knobs are the classic latency/throughput dial:

  max_batch   : dispatch immediately once this many requests are pending
                (full bucket, no padding waste).
  max_wait_us : a partially filled queue is flushed once its OLDEST request
                has waited this long.  0 flushes on every dispatcher pass
                (lowest latency); larger values trade tail latency for
                fuller buckets.

Every executed bucket is reported to ``registry.record_execution`` --
measured us/point per (plan signature, bucket), with per-client row counts
when requests carry a ``client=`` tag.  The service can tune itself
against that history: a re-tune pass watches each flat plan queue's live
traffic (arrival rate, bucket mix, per-bucket us/point from
``registry.bucket_telemetry``) and, when the mix shifts to untuned buckets
or a tuned bucket drifts past ``drift_factor`` x its learned baseline,
sweeps per-bucket winners at the OBSERVED bucket shapes -- with
``autotune.autotune_buckets`` on the plan's device by default (on the card
its grid includes the kernel's instances per CTA), or an injected
``tuner``.  Winners are hot-swapped per bucket (``PlanQueue.exec_by_bucket``,
the plan ``autotune.apply_bucket_config`` derives, whose callable the sweep
already built) under the service lock -- queued requests are untouched and
in-flight futures resolve normally -- and the learned us/point drives the
dispatcher knobs via ``opmodel.suggest_dispatch_knobs``.

Pytree plans coalesce too: ``submit(plan, params, v)`` queues an HVP and
``submit(plan, params, seed, workload="diag", n_probes=k)`` a Hutchinson
diag with its own probe budget; requests are keyed on the tree's structure
and raveled to host rows, and mixed budgets share one bucket.  Pytree
queues are served as planned, never re-tuned (the reference's rule).

Usage::

    from repro_torch import engine

    p = engine.plan(f, n, csize="auto", symmetric=False, device="cuda")
    futs = [p.submit(a, v) for a, v in requests]     # process-default service
    results = [f.result() for f in futs]             # == [p.hvp(a, v) ...]

    # explicit service with custom knobs (and deterministic tests):
    with engine.CurvatureService(max_batch=64, max_wait_us=500) as svc:
        fut = svc.submit(p, a, v)

    # admission-controlled, client-tagged serving:
    adm = engine.AdmissionController(high_water=1024)
    with engine.CurvatureService(admission=adm) as svc:
        fut = svc.submit(p, a, v, client="trainer-0", priority="interactive")

Determinism for tests: construct with ``start=False`` and drive the
dispatch by hand with ``poll()`` / ``flush()``; pass ``clock=`` a fake
monotonic clock to test the wait-budget logic without sleeping.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Optional

from repro_torch import obs
from repro_torch.serving.admission import (DEFAULT_PRIORITY,
                                           AdmissionController, ClientPolicy,
                                           ServiceClosed, ServiceOverloaded,
                                           ServiceQueueFull)

from . import opmodel, registry
from .autotune import apply_bucket_config, autotune_buckets
from .plan import CurvaturePlan

__all__ = [
    "CurvatureService", "ServiceClosed", "ServiceQueueFull",
    "ServiceOverloaded", "AdmissionController", "ClientPolicy",
    "get_service", "configure_service", "shutdown_service",
    "DEFAULT_MAX_BATCH", "DEFAULT_MAX_WAIT_US", "DEFAULT_MAX_QUEUE",
]

DEFAULT_MAX_BATCH = 256
DEFAULT_MAX_WAIT_US = 200.0
DEFAULT_MAX_QUEUE = 4096

class CurvatureService:
    """Coalesces single-point curvature requests into micro-batches.

    A thin facade wiring the serving layers together: an optional
    ``AdmissionController`` (rate limits / shedding), the ``Scheduler``
    (queues, fairness, cross-n coalescing) and the ``Dispatcher`` (worker
    threads, one per visible CUDA device by default).  Requests are keyed
    on the plan's callable cache signature, so two plan objects with the
    same static signature share a queue (and the same built callable).
    All public methods are thread-safe.
    """

    def __init__(self, *, max_batch: int = DEFAULT_MAX_BATCH,
                 max_wait_us: float = DEFAULT_MAX_WAIT_US,
                 max_queue: int = DEFAULT_MAX_QUEUE,
                 clock: Callable[[], float] = time.monotonic,
                 start: bool = True,
                 admission: Optional[AdmissionController] = None,
                 workers: Optional[int] = None,
                 coalesce_across_n: bool = True,
                 coalesce_waste_max: float = 0.4,
                 retune_interval_s: Optional[float] = None,
                 retune_deadline_s: float = 1.0,
                 retune_min_points: int = 32,
                 retune_min_share: float = 0.05,
                 drift_factor: float = 1.5,
                 wait_cap_us: float = 5000.0,
                 tuner: Optional[Callable] = None,
                 tune_dispatch: bool = True):
        """Serving knobs:

        admission : optional ``AdmissionController`` -- per-client token
            buckets, priority-aware load shedding at its ``high_water``
            depth (wired to this service's live queue depth), and the
            per-client fair-dequeue weights.  None admits everything.
        workers : dispatch worker threads.  None (default) = one per
            visible CUDA device, or one without CUDA; an int pins the pool
            size.  Each bucket runs on its own plan's device.
        coalesce_across_n : allow mixed-n ragged buckets for plans built
            on a ``RaggedFamily`` (cross-n coalescing OFF turns every
            queue back into per-n dispatch).
        coalesce_waste_max : padding-waste ceiling for a merged ragged
            bucket (``opmodel.ragged_padding_waste``); candidates that
            would push waste past this are left in their own queue.

        Online-tuning knobs (all optional; tuning is OFF by default):

        retune_interval_s : period of the background re-tune thread.  None
            (default) disables the thread -- ``retune()`` can still be
            called synchronously (tests, embeddings driving their own
            loop).
        retune_deadline_s : wall-clock budget handed to one tuner sweep.
        retune_min_points : a queue is not examined until this many points
            have been served since its last re-tune pass (noise floor).
        retune_min_share  : buckets below this share of the epoch's traffic
            are ignored -- the tuner only sweeps shapes that matter.
        drift_factor      : a tuned bucket whose recent measured us/point
            exceeds ``drift_factor`` x its learned baseline is re-tuned
            with ``force=True`` (the stored winner is stale).
        wait_cap_us       : latency ceiling the learned dispatcher knobs
            must honor (``opmodel.suggest_dispatch_knobs``).
        tuner             : override the sweep (tests, custom
            objectives): ``tuner(plan, workload, buckets, force,
            deadline_s) -> {bucket: BucketTunedConfig}``.  None (default)
            uses ``autotune.autotune_buckets`` on the plan's device.
        tune_dispatch     : also learn per-queue ``max_batch`` /
            ``max_wait_us`` from arrival rate + tuned us/point.
        """
        if max_batch < 1:
            raise ValueError(f"max_batch={max_batch} must be >= 1")
        if max_wait_us < 0:
            raise ValueError(f"max_wait_us={max_wait_us} must be >= 0")
        if max_queue < 1:
            raise ValueError(f"max_queue={max_queue} must be >= 1")
        if retune_interval_s is not None and retune_interval_s <= 0:
            raise ValueError(
                f"retune_interval_s={retune_interval_s} must be > 0 (or "
                f"None to disable the re-tune thread)")
        if not 0.0 <= coalesce_waste_max < 1.0:
            raise ValueError(
                f"coalesce_waste_max={coalesce_waste_max} must be in "
                f"[0, 1)")
        # the serving layers import engine.plan/registry/opmodel; importing
        # them lazily here keeps `import repro_torch.engine` cycle-free and
        # free of serving machinery until a service is actually constructed
        from repro_torch.serving.dispatch import Dispatcher
        from repro_torch.serving.scheduler import Scheduler
        self.retune_interval_s = retune_interval_s
        self.retune_deadline_s = float(retune_deadline_s)
        self.retune_min_points = int(retune_min_points)
        self.retune_min_share = float(retune_min_share)
        self.drift_factor = float(drift_factor)
        self.wait_cap_us = float(wait_cap_us)
        self.tune_dispatch = bool(tune_dispatch)
        self._tuner = tuner
        self._clock = clock
        self.admission = admission
        self._stats = {"submitted": 0, "dispatched": 0, "batches": 0,
                       "padded_rows": 0, "retunes": 0, "retune_errors": 0,
                       "hot_swaps": 0, "ragged_batches": 0,
                       "ragged_points": 0,
                       "buckets": collections.Counter()}
        self._sched = Scheduler(
            max_batch=max_batch, max_wait_us=max_wait_us,
            max_queue=max_queue, clock=clock, stats=self._stats,
            admission=admission, coalesce_across_n=coalesce_across_n,
            coalesce_waste_max=coalesce_waste_max)
        self._dispatcher = Dispatcher(self._sched, workers=workers)
        # scrape-time metrics: the scheduler snapshots its live telemetry
        # into the registry when an exporter asks -- nothing per request.
        # Keyed per instance; shutdown() takes one final snapshot and
        # removes it so a later service's counters own the series.
        self._collector_key = f"service-{id(self)}"
        obs.default_registry().set_collector(
            self._collector_key, self._sched.collect_metrics)
        self._retune_stop = threading.Event()
        self._retune_thread: Optional[threading.Thread] = None
        if start:
            self._dispatcher.start()
            if self.retune_interval_s is not None:
                self._retune_thread = threading.Thread(
                    target=self._retune_loop, name="curvature-retune",
                    daemon=True)
                self._retune_thread.start()

    # -- shared-state views (scheduler owns the lock and the queues) --------

    @property
    def max_batch(self) -> int:
        return self._sched.max_batch

    @max_batch.setter
    def max_batch(self, v) -> None:
        self._sched.max_batch = int(v)

    @property
    def max_wait_us(self) -> float:
        return self._sched.max_wait_us

    @max_wait_us.setter
    def max_wait_us(self, v) -> None:
        self._sched.max_wait_us = float(v)

    @property
    def max_queue(self) -> int:
        return self._sched.max_queue

    @max_queue.setter
    def max_queue(self, v) -> None:
        self._sched.max_queue = int(v)

    @property
    def _lock(self):
        return self._sched.lock

    @property
    def _queues(self):
        return self._sched.queues

    @property
    def _closed(self) -> bool:
        return self._sched.closed

    @property
    def _thread(self) -> Optional[threading.Thread]:
        """First dispatch worker (None for start=False services)."""
        ts = self._dispatcher.threads
        return ts[0] if ts else None

    # -- client side --------------------------------------------------------

    def submit(self, plan: CurvaturePlan, a, v=None, *,
               workload: Optional[str] = None,
               n_probes: Optional[int] = None, block: bool = True,
               timeout: Optional[float] = None,
               client: Optional[str] = None,
               priority: str = DEFAULT_PRIORITY,
               trace=None):
        """Enqueue one request; returns a Future of the single-point result.

          ``v`` given  -> future resolves to H_f(a) @ v  (shape (n,))
          ``v`` None   -> future resolves to H_f(a)      (shape (n, n))

        ``client`` / ``priority`` tag the request for the admission and
        fairness layers: an ``AdmissionController`` (if configured) may
        refuse with ``ServiceOverloaded`` (rate limit or high-water load
        shedding), ``priority="interactive"`` requests drain strictly
        before ``"batch"`` ones, and clients inside one queue are served
        by weighted fair round-robin.

        Results are host numpy arrays (the serving payload); inputs are
        host-marshalled too, so numpy inputs are the fast path.  The bucket
        runs on the plan's device.

        Backpressure: when ``max_queue`` requests are already pending the
        call blocks until space frees (``timeout`` seconds at most), or
        raises ``ServiceQueueFull`` immediately when ``block=False``.

        ``workload=`` / ``n_probes=`` select the pytree workloads: on a
        pytree plan ``submit(plan, params, v)`` is an HVP and
        ``submit(plan, params, seed, workload="diag", n_probes=k)`` a
        Hutchinson diag averaging the first k probes of the seed's
        sequence (k <= the plan's ``n_probes``); futures resolve to host
        numpy trees.  Flat plans refuse both.
        """
        return self._sched.submit(
            plan, a, v, workload=workload, n_probes=n_probes, block=block,
            timeout=timeout, client=client, priority=priority, trace=trace)

    # -- dispatch side ------------------------------------------------------

    def poll(self, now: Optional[float] = None) -> int:
        """One dispatch pass; returns the number of requests dispatched.

        Dispatches every queue that has either (a) a full ``max_batch``
        bucket pending, or (b) an oldest request older than the
        ``max_wait_us`` budget at time ``now`` (service clock).  Public so
        tests (and ``start=False`` embeddings) can drive the service
        deterministically."""
        return self._dispatcher.run_once(now=now)

    def flush(self) -> int:
        """Dispatch everything pending regardless of age; returns count."""
        return self._dispatcher.run_once(force=True)

    def _take_ready_batch(self, now, force: bool = False):
        return self._sched.take_ready_batch(now, force=force)

    def _execute(self, q, reqs) -> None:
        self._dispatcher.execute(q, reqs)

    # -- online tuning ------------------------------------------------------

    def _arrival_rate(self, q) -> Optional[float]:
        """Requests/second over the queue's sliding arrival window (service
        clock); None until two arrivals span measurable time."""
        if len(q.arrivals) < 2:
            return None
        span = q.arrivals[-1] - q.arrivals[0]
        if span <= 0:
            return None
        return (len(q.arrivals) - 1) / span

    def _exec_key_for(self, q, bucket: int) -> tuple:
        ent = q.exec_by_bucket.get(bucket)
        return ent[2] if ent is not None else q.key

    def _examine_queue(self, q):
        """Decide what (if anything) to re-tune for one queue.  Caller
        holds the lock.  Returns (mix, need, forced) or None.

        mix    : {bucket: share of epoch points}, thresholded at
                 ``retune_min_share`` -- the observed traffic the tuner
                 sweeps against.
        need   : {bucket: weight} subset actually requiring a sweep --
                 buckets never tuned, or tuned but drifted.
        forced : buckets whose stored winner must be re-probed (drift).
        """
        # pytree queues (ravel width is data-dependent, callables are
        # spec-specialized), mesh plans (the sharded layout IS the tuning
        # decision) and ragged-family queues (mixed-n batches run the
        # GROUP plan's callable, so per-bucket history no longer
        # describes the queue's own dense callable) are served as-is; only
        # flat single-device per-n queues join the loop
        if q.spec is not None or q.plan.n is None or q.plan.mesh is not None:
            return None
        if q.group is not None:
            return None
        if q.epoch_points < self.retune_min_points:
            return None
        total = sum(q.epoch_counts.values())
        if total <= 0:
            return None
        mix = {b: c / total for b, c in q.epoch_counts.items()
               if c / total >= self.retune_min_share}
        if not mix:
            return None
        need, forced, drift = {}, set(), {}
        for b, w in mix.items():
            if b not in q.tuned_us:
                need[b] = w             # new bucket in the traffic mix
                continue
            # drift: recent measured us/point vs the tuned baseline
            base = q.tuned_us.get(b)
            tel = registry.bucket_telemetry(
                self._exec_key_for(q, b)).get(b)
            if (base and tel
                    and tel.get("recent_us_mean", 0.0)
                    > self.drift_factor * base):
                need[b] = w
                forced.add(b)
                drift[b] = tel["recent_us_mean"] / base
        return mix, need, forced, drift

    def _run_tuner(self, q, need: dict, forced: set) -> dict:
        """One sweep against the observed buckets (no locks held: the tuner
        builds and times probe callables on the plan's device)."""
        if self._tuner is not None:
            return self._tuner(q.plan, q.workload, dict(need), bool(forced),
                               self.retune_deadline_s) or {}
        p = q.plan
        return autotune_buckets(
            p.f, p.n, dict(need), symmetric=p.symmetric, backend=p.backend,
            options=p.options, workload=q.workload,
            deadline_s=self.retune_deadline_s, force=bool(forced),
            device=p.device)

    def _apply_tuned(self, q, tuned: dict):
        """Install winner callables per bucket.  Caller holds the lock.

        The swap is a dict assignment: queued requests are untouched, the
        next execute for that bucket simply resolves to the new (already
        built -- ``apply_bucket_config`` reproduces the probe plan's cache
        key) callable.  Zero dropped requests by design.

        Returns (swaps, changes): ``changes`` describes each per-bucket
        decision -- old/new (backend, csize, blk_m, dtype_policy) plus the
        new tuned us/point baseline -- and feeds the structured retune
        event the flight recorder keeps."""

        def _cfg_view(ep, backend):
            return {"backend": backend, "csize": ep.csize,
                    "blk_m": ep.opt("blk_m"),
                    "dtype_policy": ep.opt("dtype_policy", "fp32")}

        swaps, changes = 0, []
        for b, cfg in tuned.items():
            if cfg is None:
                continue
            ep = apply_bucket_config(q.plan, cfg)
            key = ep.cache_key(q.workload, cfg.backend)
            prev = q.exec_by_bucket.get(int(b))
            if prev is not None and prev[2] == key:
                q.tuned_us[int(b)] = cfg.us_per_point  # refreshed baseline
                changes.append({"bucket": int(b), "swapped": False,
                                "new": _cfg_view(ep, cfg.backend),
                                "tuned_us": cfg.us_per_point})
                continue
            old = (_cfg_view(prev[0], prev[1]) if prev is not None
                   else _cfg_view(q.plan, q.backend))
            q.exec_by_bucket[int(b)] = (ep, cfg.backend, key)
            q.tuned_us[int(b)] = cfg.us_per_point
            swaps += 1
            changes.append({"bucket": int(b), "swapped": True, "old": old,
                            "new": _cfg_view(ep, cfg.backend),
                            "tuned_us": cfg.us_per_point})
        return swaps, changes

    def _tune_queue_knobs(self, q) -> None:
        """Fit the per-queue dispatcher knobs from arrival rate + learned
        us/point (caller holds the lock)."""
        rate = self._arrival_rate(q)
        us_table = {}
        for b in set(q.tuned_us) | set(q.epoch_counts):
            tel = registry.bucket_telemetry(
                self._exec_key_for(q, b)).get(b) or {}
            us = tel.get("recent_us_mean") or q.tuned_us.get(b)
            if us:
                us_table[b] = us
        knobs = opmodel.suggest_dispatch_knobs(
            rate, us_table, wait_cap_us=self.wait_cap_us,
            max_batch_cap=self.max_batch)
        if knobs is not None:
            q.max_batch, q.max_wait_us = int(knobs[0]), float(knobs[1])

    def retune(self) -> dict:
        """One synchronous re-tune pass over every queue; returns a summary
        ``{queues_examined, queues_tuned, hot_swaps, errors}``.

        This is exactly what the background thread runs every
        ``retune_interval_s``; tests (and embeddings pacing their own loop)
        call it directly for determinism.  Tuner sweeps run with NO service
        lock held -- submits and dispatches proceed concurrently -- and the
        resulting callable swaps are single dict assignments under the
        lock."""
        summary = {"queues_examined": 0, "queues_tuned": 0,
                   "hot_swaps": 0, "errors": 0}
        with self._lock:
            work = []
            for q in self._queues.values():
                decision = self._examine_queue(q)
                if decision is None:
                    continue
                summary["queues_examined"] += 1
                work.append((q, *decision))
        for q, mix, need, forced, drift in work:
            # per-bucket trigger taxonomy for the structured event: a
            # bucket is re-tuned because it is NEW in the traffic mix or
            # because its winner DRIFTED past the baseline; a pass with
            # nothing to sweep is a fresh-epoch knob refit
            triggers = {b: ("drift" if b in forced else "new_bucket")
                        for b in need}
            tuned = {}
            if need:
                try:
                    tuned = self._run_tuner(q, need, forced)
                except Exception as e:
                    summary["errors"] += 1
                    with self._lock:
                        self._stats["retune_errors"] += 1
                    if obs.enabled():
                        obs.event(
                            "retune_error",
                            f=getattr(q.plan.f, "__name__", repr(q.plan.f)),
                            n=q.plan.n, workload=q.workload,
                            error=type(e).__name__)
                    continue
            with self._lock:
                swaps, changes = self._apply_tuned(q, tuned)
                if self.tune_dispatch:
                    self._tune_queue_knobs(q)
                knobs = (q.max_batch, q.max_wait_us)
                # the epoch resets AFTER a successful pass: the next shift
                # is judged against fresh traffic only
                q.epoch_counts.clear()
                q.epoch_points = 0
                self._stats["retunes"] += 1
                self._stats["hot_swaps"] += swaps
                summary["queues_tuned"] += 1
                summary["hot_swaps"] += swaps
            if obs.enabled():
                # answers "why did the service re-tune?": the trigger per
                # bucket, measured drift ratio vs the tuned baseline, the
                # old/new configs and the refit dispatcher knobs
                obs.event(
                    "retune",
                    f=getattr(q.plan.f, "__name__", repr(q.plan.f)),
                    n=q.plan.n, workload=q.workload,
                    mix={str(b): round(w, 4) for b, w in mix.items()},
                    triggers={str(b): t for b, t in triggers.items()},
                    drift={str(b): round(r, 3) for b, r in drift.items()},
                    changes=repr(changes), hot_swaps=swaps,
                    max_batch=knobs[0], max_wait_us=knobs[1])
                reg = obs.default_registry()
                rc = reg.counter(
                    "repro_retunes_total",
                    "Re-tune passes applied, by dominant trigger.",
                    labelnames=("trigger",))
                dominant = ("drift" if forced
                            else ("new_bucket" if need else "knob_refit"))
                rc.inc(trigger=dominant)
                if swaps:
                    reg.counter(
                        "repro_hot_swaps_total",
                        "Per-bucket executable hot-swaps installed by "
                        "re-tune passes.").inc(swaps)
        return summary

    def _retune_loop(self) -> None:
        while not self._retune_stop.wait(self.retune_interval_s):
            if self._closed:
                return
            try:
                self.retune()
            except Exception:           # pragma: no cover - defensive
                with self._lock:
                    self._stats["retune_errors"] += 1

    def tuning_report(self) -> list:
        """Snapshot of the learned state, one entry per flat queue:
        ``{f, n, workload, max_batch, max_wait_us, buckets: {bucket:
        {csize, backend, blk_m, dtype_policy, tuned_us}}}``."""
        out = []
        with self._lock:
            for q in self._queues.values():
                if q.spec is not None or q.plan.n is None:
                    continue
                buckets = {}
                for b, (ep, backend, _key) in sorted(q.exec_by_bucket.items()):
                    buckets[b] = {
                        "csize": ep.csize, "backend": backend,
                        "blk_m": ep.opt("blk_m"),
                        "dtype_policy": ep.opt("dtype_policy", "fp32"),
                        "tuned_us": q.tuned_us.get(b),
                    }
                out.append({
                    "f": getattr(q.plan.f, "__name__", repr(q.plan.f)),
                    "n": q.plan.n, "workload": q.workload,
                    "max_batch": q.max_batch, "max_wait_us": q.max_wait_us,
                    "buckets": buckets,
                })
        return out

    # -- lifecycle ----------------------------------------------------------

    def stats(self) -> dict:
        """Counters snapshot: submitted/dispatched/batches/padded_rows,
        the tuning counters (retunes/hot_swaps/retune_errors), the ragged
        coalescing counters (ragged_batches/ragged_points, cross_n_fills),
        a {bucket: batches} histogram, the current queue depth, and -- when
        an AdmissionController is configured -- its shed counters."""
        with self._lock:
            s = dict(self._stats)
            s["buckets"] = dict(self._stats["buckets"])
            s["pending"] = self._sched.pending
        if self.admission is not None:
            s["admission"] = self.admission.stats()
        return s

    def shutdown(self, wait: bool = True) -> None:
        """Stop accepting submits.  ``wait=True`` drains pending requests
        (dispatching them) and joins every worker; ``wait=False`` fails
        pending futures with ServiceClosed.

        Deterministic ordering (no daemon-thread races at interpreter
        exit): close the intake, stop and join the re-tune thread FIRST
        (no sweep can hot-swap mid-drain), then wake and join the dispatch
        workers (each drains the queues before exiting), then -- for
        ``start=False`` services -- drain inline.  Idempotent: a second
        call returns immediately."""
        sched = self._sched
        with sched.space:
            if sched.closed and self._thread is None:
                return
            sched.closed = True
            if not wait:
                sched.fail_pending(ServiceClosed("service shut down"))
            sched.space.notify_all()
        self._retune_stop.set()
        rt, self._retune_thread = self._retune_thread, None
        if rt is not None:
            rt.join()
        sched.wake.set()
        if not wait:
            # workers exit on their own via the drain branch (queues are
            # already empty -- pending futures were failed above)
            self._dispatcher.threads = []
            self._retire_collector()
            return
        had_workers = bool(self._dispatcher.threads)
        self._dispatcher.join()
        if not had_workers:
            self.flush()            # start=False services drain inline
        self._retire_collector()

    def _retire_collector(self) -> None:
        """Freeze this service's metric series at their final values and
        stop collecting for it (idempotent)."""
        key, self._collector_key = self._collector_key, None
        if key is None:
            return
        reg = obs.default_registry()
        try:
            self._sched.collect_metrics(reg)
        finally:
            reg.remove_collector(key)

    def close(self) -> None:
        """Alias for ``shutdown(wait=True)`` (drain and join)."""
        self.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(wait=exc[0] is None)


# ---------------------------------------------------------------------------
# process-default service (what plan.submit uses)
# ---------------------------------------------------------------------------

_DEFAULT: Optional[CurvatureService] = None
_DEFAULT_LOCK = threading.Lock()
_ATEXIT_REGISTERED = False


def _register_atexit_locked() -> None:
    """Drain the default service at interpreter exit (caller holds
    _DEFAULT_LOCK).  Daemon workers die abruptly during finalization;
    an orderly shutdown first resolves every in-flight future."""
    global _ATEXIT_REGISTERED
    if not _ATEXIT_REGISTERED:
        import atexit
        atexit.register(shutdown_service)
        _ATEXIT_REGISTERED = True


def get_service() -> CurvatureService:
    """The process-default CurvatureService, created on first use."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = CurvatureService()
            _register_atexit_locked()
        return _DEFAULT


def configure_service(**kwargs) -> CurvatureService:
    """Replace the process-default service (draining the old one).

    Accepts the CurvatureService constructor knobs: ``max_batch``,
    ``max_wait_us``, ``max_queue``, ``clock``, ``start``, the serving
    knobs (``admission``, ``workers``, ``coalesce_across_n``,
    ``coalesce_waste_max``) plus the online tuning knobs
    (``retune_interval_s``, ``drift_factor``, ...; see the
    CurvatureService docstring).  The new service
    is installed atomically BEFORE the old one drains, so a concurrent
    ``get_service()`` can never create (and leak) a third one."""
    global _DEFAULT
    svc = CurvatureService(**kwargs)
    with _DEFAULT_LOCK:
        old, _DEFAULT = _DEFAULT, svc
        _register_atexit_locked()
    if old is not None:
        old.shutdown(wait=True)
    return svc


def shutdown_service(wait: bool = True) -> None:
    """Shut down the process-default service (if one was created)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        svc, _DEFAULT = _DEFAULT, None
    if svc is not None:
        svc.shutdown(wait=wait)
