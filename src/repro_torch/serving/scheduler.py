"""Scheduler layer: bounded per-plan queues, fairness, cross-n coalescing.

Counterpart of ``repro.serving.scheduler``.  The serving stack (the
reference's docs/serving.md) is transport -> admission ->
**scheduler** -> dispatch.  This module owns everything between "a request
was admitted" and "a coalesced batch is handed to a dispatch worker":

  * **per-plan-signature queues** -- requests are keyed on the plan's
    executable cache signature, so two plan objects with the same static
    signature share a queue (and the same built callable).  Queues are
    bounded (``max_queue`` total pending) with condition-variable
    backpressure for blocking submitters.
  * **micro-bucket triggers** -- a queue dispatches when it holds a full
    ``max_batch`` bucket or its OLDEST request exceeds ``max_wait_us``
    (per-queue learned overrides take precedence; see the re-tune loop in
    ``engine/service.py``).
  * **weighted-fair dequeue** -- inside a queue, requests are organized
    into per-(priority, client) lanes.  Interactive lanes drain strictly
    before batch lanes; within a priority class, clients are served by
    weighted virtual-time round-robin (weight from the admission policy),
    so one greedy client cannot starve the others.  Untagged traffic
    (no client, default priority) takes a FIFO fast path that is
    bit-identical to the pre-layering service.
  * **cross-n ragged coalescing** -- flat HVP plans built on a
    ``RaggedFamily`` (engine/plan.py) share a ``RaggedGroup``.  When a
    member queue dispatches a PARTIAL bucket (deadline/flush trigger, not
    a full one), the scheduler tops it up with requests of OTHER row
    widths from sibling queues, provided the padded-``n`` waste stays
    under ``coalesce_waste_max`` (``opmodel.ragged_padding_waste``).  The
    dispatcher runs such mixed-``n`` batches through the family's
    ``batched_hvp_ragged`` executable at ``n_pad = max(n)``.

The scheduler knows nothing about threads-that-execute (dispatch layer)
or sockets (transport layer); it exposes ``take_ready_batch`` /
``next_deadline_delay`` and the ``wake`` event the dispatch workers park
on.
"""

from __future__ import annotations

import collections
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from repro_torch import obs
from repro_torch.engine.opmodel import ragged_padding_waste
from repro_torch.engine.plan import CurvaturePlan
from repro_torch.engine.plan import plan as build_plan
from repro_torch.engine.pytree import PytreeSpec, spec_of
from repro_torch.hostarray import to_host

from .admission import (DEFAULT_PRIORITY, AdmissionController, ServiceClosed,
                        ServiceQueueFull, priority_rank)

__all__ = ["Request", "PlanQueue", "RaggedGroup", "Scheduler"]


@dataclass
class Request:
    a: Any
    v: Any                       # None => hessian workload
    future: Future
    t_submit: float              # service clock, for the wait budget
    n: Optional[int] = None      # flat row width (cross-n ragged dispatch)
    p: Optional[int] = None      # per-request probe budget (diag only)
    client: Optional[str] = None
    priority: str = DEFAULT_PRIORITY
    trace: Optional[Any] = None  # obs.Trace (None when obs is disabled)
    # torch dtypes of a flat request's a and v: a host row may widen them
    # (hostarray holds bfloat16 as float32); None for pytree requests
    a_dtype: Optional[Any] = None
    v_dtype: Optional[Any] = None

    @property
    def tagged(self) -> bool:
        """Does this request need the fair scheduler (vs the FIFO path)?"""
        return self.client is not None or self.priority != DEFAULT_PRIORITY


@dataclass
class PlanQueue:
    """Pending requests sharing one (plan signature, workload).

    For pytree plans ``plan`` is the spec-carrying derived plan (the
    submitted plan plus a ``pytree_spec`` option) and ``spec`` is that
    spec: requests with different treedefs derive different plans, hence
    different cache keys, hence DIFFERENT queues -- mixed-treedef traffic
    can never be stacked into one bucket."""
    plan: CurvaturePlan
    workload: str                # "batched_hvp" | "batched_hessian" |
                                 # "batched_diag"
    backend: str
    key: tuple                   # the plan's executable cache key (also the
                                 # queue index and the telemetry key)
    spec: Optional[PytreeSpec] = None    # set for pytree queues
    requests: collections.deque = field(default_factory=collections.deque)
    # -- fairness state (scheduler lock): count of pending tagged requests
    # (client-identified or non-default priority) and the per-client
    # virtual-time clocks of the weighted round-robin
    tagged: int = 0
    fair_vt: dict = field(default_factory=dict)
    # cross-QUEUE arbitration clock: when several queues are ready at once
    # and any carries tagged traffic, the queue with the smallest virtual
    # time dispatches first, advancing by 1/(aggregate weight of its
    # waiting clients) -- so the signature serving heavier clients gets a
    # proportionally larger share of the dispatch slots
    queue_vt: float = 0.0
    # -- cross-n state: the RaggedGroup this queue belongs to (None for
    # plans without a ragged family)
    group: Optional["RaggedGroup"] = None
    # -- online-tuning state (flat queues only; all guarded by the service
    # lock).  ``exec_by_bucket`` maps bucket -> (derived plan, backend name,
    # telemetry key): the hot-swapped winner executable for that bucket.
    # ``tuned_us`` keeps the winner's tuned us/point baseline for drift
    # detection; ``max_batch``/``max_wait_us`` are learned per-queue
    # dispatcher-knob overrides (None = service defaults).  ``arrivals``
    # is a sliding window of submit timestamps (arrival-rate estimate) and
    # ``epoch_counts`` the per-bucket point counts since the last re-tune
    # pass (the observed traffic mix the tuner sweeps against).
    exec_by_bucket: dict = field(default_factory=dict)
    tuned_us: dict = field(default_factory=dict)
    max_batch: Optional[int] = None
    max_wait_us: Optional[float] = None
    arrivals: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=256))
    epoch_counts: collections.Counter = field(
        default_factory=collections.Counter)
    epoch_points: int = 0


class RaggedGroup:
    """The member queues of one RaggedFamily, plus its padded-n plans.

    ``plan_for(n_pad, device)`` lazily builds (and caches) the derived
    plan whose ``batched_hvp_ragged`` callable serves every member at
    ``n_pad`` on ``device`` (the members' plans' device) -- one callable
    per observed padded width, shared by all member queues and all clients
    of the family.  Guarded by the scheduler lock.
    """

    __slots__ = ("family", "members", "plans", "rr")

    def __init__(self, family):
        self.family = family
        self.members: list = []          # PlanQueue, one per distinct key
        self.plans: dict = {}    # (n_pad, device) -> (plan, backend, key)
        self.rr = 0                      # sibling rotation cursor

    def plan_for(self, n_pad: int, device):
        ent = self.plans.get((n_pad, device))
        if ent is None:
            # symmetric=False: the ragged row path is one jvp-of-grad per
            # row, the symmetric chunk schedules never apply
            gplan = build_plan(self.family, n_pad, symmetric=False,
                               device=device)
            backend = gplan.backend_for("batched_hvp_ragged")
            key = gplan.cache_key("batched_hvp_ragged", backend)
            ent = self.plans[(n_pad, device)] = (gplan, backend, key)
        return ent


class Scheduler:
    """Admission-aware queueing and batch selection (no execution here).

    Shared-state contract: ``lock`` guards every queue and counter;
    ``space`` (a Condition on that lock) parks blocked submitters;
    ``wake`` is the Event dispatch workers park on.  ``stats`` is the
    service-wide counter dict (shared with the dispatch layer, guarded by
    ``lock``)."""

    def __init__(self, *, max_batch: int, max_wait_us: float, max_queue: int,
                 clock: Callable[[], float],
                 stats: dict,
                 admission: Optional[AdmissionController] = None,
                 coalesce_across_n: bool = True,
                 coalesce_waste_max: float = 0.4):
        self.max_batch = int(max_batch)
        self.max_wait_us = float(max_wait_us)
        self.max_queue = int(max_queue)
        self.clock = clock
        self.stats = stats
        self.admission = admission
        self.coalesce_across_n = bool(coalesce_across_n)
        self.coalesce_waste_max = float(coalesce_waste_max)
        self.lock = threading.Lock()
        self.space = threading.Condition(self.lock)     # queue-full waiters
        self.wake = threading.Event()                   # dispatcher nudge
        self.queues: dict = collections.OrderedDict()   # key -> PlanQueue
        self.groups: dict = {}                          # family -> RaggedGroup
        # (id(plan), workload) -> (backend, key); holds a strong plan ref in
        # the value so the id stays valid.  Saves a registry resolve + plan
        # hash per submit on the hot path.
        self.routes: dict = {}
        self.pending = 0
        # per-priority submit counts (under ``lock``): the source the
        # scrape-time repro_requests_total collector snapshots -- an int
        # bump inside a lock we already hold, not a striped metric inc on
        # the hot path (docs/observability.md)
        self.by_priority: collections.Counter = collections.Counter()
        self.closed = False
        # admission sheds on the LIVE depth: wire our pending counter in
        # unless the controller came with its own depth source
        if admission is not None and admission.depth is None:
            admission.depth = lambda: self.pending

    def weight_of(self, client: Optional[str]) -> float:
        if self.admission is not None:
            return self.admission.weight(client)
        return 1.0

    # -- submit path --------------------------------------------------------

    def submit(self, plan: CurvaturePlan, a, v=None, *,
               workload: Optional[str] = None,
               n_probes: Optional[int] = None, block: bool = True,
               timeout: Optional[float] = None,
               client: Optional[str] = None,
               priority: str = DEFAULT_PRIORITY,
               trace=None) -> Future:
        """Validate, marshal, admit and enqueue one request.

        ``trace`` carries a pre-started obs.Trace (the frontend begins one
        at decode time so transport latency is on the trace); when absent
        and observability is enabled, a trace is started here."""
        priority_rank(priority)             # reject unknown classes early
        if trace is None and obs.enabled():
            trace = obs.trace_begin(client=client, priority=priority)
        n = p = a_dtype = v_dtype = None
        if plan.n is None:
            dplan, workload, backend, key, spec, a, v, p = \
                self._marshal_pytree(plan, a, v, workload, n_probes)
        else:
            if workload is not None:
                raise ValueError(
                    "workload= selects the pytree workload; flat plans "
                    "infer it from the arguments (v given -> hvp)")
            if n_probes is not None:
                raise ValueError(
                    "n_probes= is a probe budget for pytree diag submits; "
                    "flat HVP/Hessian requests have no probe axis")
            dplan, spec = plan, None
            n = int(plan.n)
            workload = "batched_hvp" if v is not None else "batched_hessian"
            route = self.routes.get((id(plan), workload))
            if route is None:
                backend = plan.backend_for(workload)
                key = plan.cache_key(workload, backend)
                if len(self.routes) > 4 * max(len(self.queues), 64):
                    self.routes.clear()  # id-reuse guard, keeps dict small
                route = self.routes[(id(plan), workload)] = (plan, backend,
                                                             key)
            _plan_ref, backend, key = route
            # marshal on the HOST: requests are stacked with np.stack and
            # shipped to the device as ONE array per bucket -- stacking k
            # device-resident rows instead costs one copy per row
            a, a_dtype = to_host(a)
            if a.shape != (plan.n,):
                raise ValueError(
                    f"submit expects a single point of shape ({plan.n},), "
                    f"got {a.shape}; batched arrays go through "
                    f"plan.{workload}")
            if v is not None:
                v, v_dtype = to_host(v)
                if v.shape != (plan.n,):
                    raise ValueError(
                        f"submit expects v of shape ({plan.n},), got "
                        f"{v.shape}")
        if trace is not None:
            trace.meta["workload"] = workload
            if n is not None:
                trace.meta["n"] = n
        fut: Future = Future()
        try:
            with self.space:
                if self.closed:
                    raise ServiceClosed("CurvatureService is shut down")
                if self.admission is not None:
                    # policy rejection (ServiceOverloaded) happens BEFORE
                    # the backpressure wait: a shed request must fail fast,
                    # not after blocking on a queue it was never going to
                    # enter
                    if trace is not None:
                        with trace.span("admit"):
                            self.admission.admit(client, priority=priority)
                    else:
                        self.admission.admit(client, priority=priority)
                if self.pending >= self.max_queue:
                    if not block:
                        raise ServiceQueueFull(
                            f"{self.pending} requests pending "
                            f"(max_queue={self.max_queue})")
                    ok = self.space.wait_for(
                        lambda: self.closed or self.pending < self.max_queue,
                        timeout)
                    if self.closed:
                        raise ServiceClosed("CurvatureService is shut down")
                    if not ok:
                        raise ServiceQueueFull(
                            f"queue still full after {timeout}s "
                            f"(max_queue={self.max_queue})")
                q = self.queues.get(key)
                if q is None:
                    q = PlanQueue(plan=dplan, workload=workload,
                                  backend=backend, key=key, spec=spec)
                    self.queues[key] = q
                    self._maybe_join_group(q)
                t = self.clock()
                req = Request(a, v, fut, t, n=n, p=p, client=client,
                              priority=priority, trace=trace,
                              a_dtype=a_dtype, v_dtype=v_dtype)
                if trace is not None:
                    trace.mark("enqueued")
                q.requests.append(req)
                if req.tagged:
                    q.tagged += 1
                q.arrivals.append(t)        # rate window for the knob model
                self.pending += 1
                self.stats["submitted"] += 1
                self.by_priority[priority] += 1
                # wake a dispatch worker only on the transitions it cares
                # about: a previously-empty service (workers may be in an
                # unbounded wait) or a queue reaching a full bucket
                # (dispatch now, not at deadline).  Anything in between is
                # already covered by the deadline timer, and an Event.set
                # per submit costs a lock on the hot path.
                nudge = (self.pending == 1
                         or len(q.requests) >= (q.max_batch
                                                or self.max_batch))
        except Exception as e:
            # shed / closed / queue-full: the request never entered a
            # queue; seal its trace so the rejection is visible in the
            # flight recorder rather than silently dropped
            if trace is not None:
                trace.finish(error=type(e).__name__)
            raise
        if nudge:
            self.wake.set()
        return fut

    def _maybe_join_group(self, q: PlanQueue) -> None:
        """Attach a new queue to its family's RaggedGroup (caller holds the
        lock).  Only flat single-device HVP queues whose plan carries a
        masked ``ragged_family`` opt in; everything else dispatches per-n
        exactly as before."""
        if not self.coalesce_across_n or q.spec is not None:
            return
        p = q.plan
        if p.n is None or p.mesh is not None or q.workload != "batched_hvp":
            return
        fam = p.opt("ragged_family")
        if fam is None or not callable(getattr(fam, "masked", None)):
            return
        g = self.groups.get(fam.name)
        if g is None:
            g = self.groups[fam.name] = RaggedGroup(fam)
        g.members.append(q)
        q.group = g

    def _marshal_pytree(self, plan: CurvaturePlan, a, v, workload, n_probes):
        """Resolve and host-marshal one pytree request.

        Coalescing key: a derived plan carrying the request's PytreeSpec as
        an option, so the ordinary callable cache / telemetry signature
        machinery separates treedefs.  The params (and tangent) trees ravel
        to one host row each; a diag seed passes through as a 0-d int64
        row.  Returns (derived plan, batched workload, backend, cache key,
        spec, a_row, v_row, probe budget)."""
        if workload in (None, "hvp"):
            if v is None:
                raise ValueError(
                    "pytree submits coalesce HVPs -- submit(plan, params, "
                    "v) -- or Hutchinson diag -- submit(plan, params, key, "
                    "workload='diag'); dense pytree Hessians are not a "
                    "service workload")
            if n_probes is not None:
                raise ValueError(
                    "n_probes= is a diag probe budget; HVP submits have "
                    "no probe axis")
            workload = "batched_hvp"
        elif workload == "diag":
            if v is None:
                raise ValueError(
                    "workload='diag' needs the probe seed as the second "
                    "argument: submit(plan, params, seed, workload='diag')")
            cap = int(plan.opt("n_probes", 4))
            if n_probes is None:
                n_probes = cap
            else:
                n_probes = int(n_probes)
                if not 1 <= n_probes <= cap:
                    raise ValueError(
                        f"n_probes={n_probes} out of range: the plan's "
                        f"probe budget is 1..{cap} (its n_probes option "
                        f"caps the shared callable)")
            workload = "batched_diag"
        else:
            raise ValueError(
                f"pytree submits support workload 'hvp' or 'diag', got "
                f"{workload!r}")
        spec = spec_of(a)
        route_key = (id(plan), workload, spec)
        route = self.routes.get(route_key)
        if route is None:
            import dataclasses
            opts = dict(plan.options)
            opts["pytree_spec"] = spec
            dplan = dataclasses.replace(
                plan, options=tuple(sorted(opts.items())))
            backend = dplan.backend_for(workload)
            key = dplan.cache_key(workload, backend)
            if len(self.routes) > 4 * max(len(self.queues), 64):
                self.routes.clear()
            route = self.routes[route_key] = (plan, dplan, backend, key)
        _plan_ref, dplan, backend, key = route
        a_row = spec.ravel(a)               # validates treedef + shapes
        if workload == "batched_hvp":
            v_row = spec.ravel(v)           # tangent must match the params
        else:
            v_row = np.asarray(int(v), np.int64)      # the probe seed
        return dplan, workload, backend, key, spec, a_row, v_row, n_probes

    # -- batch selection ----------------------------------------------------

    def take_ready_batch(self, now, force: bool = False):
        """Pop up to max_batch requests from the chosen ready queue.

        **Cross-queue arbitration**: when several queues are ready at the
        same instant and none of them carries tagged traffic, the first in
        rotation order is served and rotated to the back -- the exact
        pre-layering round-robin, so one continuously-full plan queue
        cannot starve the others past their wait budget.  When any ready
        queue DOES carry tagged requests, queues compete by weighted
        virtual time: the ready queue with the smallest ``queue_vt``
        dispatches and advances its clock by 1 / (aggregate weight of the
        distinct clients waiting in it), so a signature queue serving
        weight-4 clients receives 4x the dispatch slots of one serving
        weight-1 clients.  A queue re-joining after idling is clamped to
        the current floor -- one turn of credit, not an unbounded backlog
        of it.

        Returns (queue, requests) or None.  The requests may include
        cross-n fills pulled from the queue's RaggedGroup siblings (the
        dispatcher detects the mixed widths and routes the batch through
        the family's ragged executable)."""
        with self.space:
            ready = []
            for key, q in self.queues.items():
                if not q.requests:
                    continue
                # learned per-queue dispatcher knobs override the service
                # defaults once the re-tune loop has fit them
                eff_batch = q.max_batch or self.max_batch
                eff_wait = (q.max_wait_us if q.max_wait_us is not None
                            else self.max_wait_us)
                full = len(q.requests) >= eff_batch
                if not (force or full):
                    age_us = (now - q.requests[0].t_submit) * 1e6
                    if age_us < eff_wait:
                        continue
                ready.append((key, q, eff_batch, full))
            if not ready:
                return None
            if len(ready) == 1 or all(e[1].tagged == 0 for e in ready):
                key, q, eff_batch, full = ready[0]    # FIFO fast path
            else:
                floor = min(e[1].queue_vt for e in ready)
                key, q, eff_batch, full = min(
                    ready, key=lambda e: e[1].queue_vt)
                clients = {r.client for r in q.requests}
                agg = sum(self.weight_of(c) for c in clients)
                q.queue_vt = (max(q.queue_vt, floor)
                              + 1.0 / max(agg, 1e-9))
                if floor > 1e9:     # keep the clocks bounded
                    for qq in self.queues.values():
                        qq.queue_vt = max(qq.queue_vt - floor, 0.0)
            k = min(len(q.requests), eff_batch)
            reqs = self._select(q, k)
            if (q.group is not None and len(reqs) < eff_batch
                    and not full):
                # only PARTIAL buckets are topped up: a full bucket has
                # zero padding waste, merging can only dilute it
                self._fill_cross_n(q, reqs, eff_batch)
            self.pending -= len(reqs)
            self.queues.move_to_end(key)
            self.space.notify_all()
        # one clock read for the whole batch: selection is a batch-level
        # instant, and per-request clock calls are measurable at this rate
        t_sel = None
        for r in reqs:
            tr = r.trace
            if tr is not None:
                if t_sel is None:
                    t_sel = tr.clock()
                tr.marks["selected"] = t_sel
        return q, reqs

    def _select(self, q: PlanQueue, k: int) -> list:
        """Pick k requests from one queue honoring priority + fairness.

        Untagged queues (no request carries a client id or a non-default
        priority) pop FIFO -- the exact pre-layering behavior.  Otherwise
        requests are grouped into (priority rank, client) lanes; ranks
        drain strictly in order, and within a rank clients alternate by
        weighted virtual time: serving client c advances its clock by
        1/weight(c), and the lane with the SMALLEST clock goes next, so a
        weight-2 client receives 2x the dequeues of a weight-1 client and
        a client that floods the queue cannot starve the rest.  New
        clients join at the current minimum clock (no credit for having
        been absent).  Caller holds the lock."""
        if q.tagged == 0:
            return [q.requests.popleft() for _ in range(k)]
        lanes: collections.OrderedDict = collections.OrderedDict()
        for r in q.requests:
            lanes.setdefault(
                (priority_rank(r.priority), r.client), []).append(r)
        chosen: list = []
        vt = q.fair_vt
        for rank in sorted({rk for rk, _ in lanes}):
            if len(chosen) >= k:
                break
            active = collections.OrderedDict(
                (c, collections.deque(rs))
                for (rk, c), rs in lanes.items() if rk == rank)
            floor = min(vt.values()) if vt else 0.0
            for c in active:
                vt.setdefault(c, floor)
            while len(chosen) < k and active:
                c = min(active, key=lambda cc: vt[cc])
                chosen.append(active[c].popleft())
                vt[c] += 1.0 / max(self.weight_of(c), 1e-9)
                if not active[c]:
                    del active[c]
        picked = set(map(id, chosen))
        q.requests = collections.deque(
            r for r in q.requests if id(r) not in picked)
        q.tagged = sum(1 for r in q.requests if r.tagged)
        if vt:
            # keep the clocks bounded in a long-running service
            m = min(vt.values())
            if m > 1e9:
                for c in vt:
                    vt[c] -= m
        return chosen

    def _fill_cross_n(self, q: PlanQueue, reqs: list, eff_batch: int) -> None:
        """Top a partial bucket up with other-n requests from the queue's
        RaggedGroup siblings (caller holds the lock; mutates ``reqs`` and
        the sibling queues; does NOT touch ``self.pending`` -- the caller
        decrements once for the final count).

        Pull order rotates across siblings (group.rr) so one sibling is
        not always the donor.  Each candidate is gated by the §5-style
        padding-waste model: adding a row is refused once
        ``ragged_padding_waste`` of the would-be batch exceeds
        ``coalesce_waste_max``.  Siblings holding a FULL bucket of their
        own are skipped -- they are about to dispatch dense, stealing
        from them only adds padding."""
        room = eff_batch - len(reqs)
        if room <= 0:
            return
        group = q.group
        donors = [m for m in group.members
                  if m is not q and m.requests
                  and m.plan.n != q.plan.n
                  and len(m.requests) < (m.max_batch or self.max_batch)]
        if not donors:
            return
        start = group.rr % len(donors)
        group.rr += 1
        ns = [r.n for r in reqs]
        merged = 0
        for sib in donors[start:] + donors[:start]:
            while room > 0 and sib.requests:
                cand = ns + [sib.requests[0].n]
                if ragged_padding_waste(cand) > self.coalesce_waste_max:
                    break
                r = sib.requests.popleft()
                if r.tagged:
                    sib.tagged -= 1
                reqs.append(r)
                ns = cand
                room -= 1
                merged += 1
        if merged:
            self.stats["cross_n_fills"] = \
                self.stats.get("cross_n_fills", 0) + merged

    def next_deadline_delay(self) -> Optional[float]:
        """Seconds until the oldest pending request exceeds its queue's wait
        budget (None = sleep until nudged).  Caller holds the lock."""
        deadline = None
        for q in self.queues.values():
            if q.requests:
                wait = (q.max_wait_us if q.max_wait_us is not None
                        else self.max_wait_us)
                t = q.requests[0].t_submit + wait * 1e-6
                deadline = t if deadline is None else min(deadline, t)
        if deadline is None:
            return None
        remaining = deadline - self.clock()
        return max(remaining, 0.0) + 1e-4   # small slack past the deadline

    # -- observability ------------------------------------------------------

    def collect_metrics(self, reg) -> None:
        """Scrape-time collector: snapshot the live scheduler/dispatch/
        admission telemetry into the metrics registry.

        Registered per service instance (``CurvatureService`` keys it by
        id and removes it on shutdown after one final collect).  This is
        the whole trick that keeps the serving hot path metric-free: the
        counters below are views over state the stack already maintains
        under its own locks -- nothing here runs per request.  Skipped
        while observability is disabled so a disabled process exports
        frozen values."""
        if not obs.enabled():
            return
        with self.lock:
            pending = self.pending
            by_priority = dict(self.by_priority)
            stats = dict(self.stats)
            buckets = dict(stats.get("buckets", ()))
            shed = dict(self.admission.shed) if self.admission is not None \
                else {}
        reg.gauge("repro_pending",
                  "Requests currently queued or in flight.").child().set(
            pending)
        req = reg.counter("repro_requests_total",
                          "Requests accepted into the scheduler.",
                          labelnames=("priority",))
        for p, v in by_priority.items():
            req.child(priority=p).set(v)
        reg.counter(
            "repro_cross_n_fills_total",
            "Requests merged into a sibling queue's bucket (cross-n "
            "ragged coalescing).").child().set(
            stats.get("cross_n_fills", 0))
        reg.counter("repro_points_total",
                    "Real (un-padded) points executed.").child().set(
            stats.get("dispatched", 0))
        batches = reg.counter("repro_batches_total",
                              "Dispatched buckets by kind.",
                              labelnames=("kind",))
        ragged = stats.get("ragged_batches", 0)
        batches.child(kind="dense").set(stats.get("batches", 0) - ragged)
        batches.child(kind="ragged").set(ragged)
        reg.counter("repro_padded_rows_total",
                    "Padding rows executed (bucket size minus real "
                    "rows).").child().set(stats.get("padded_rows", 0))
        per_bucket = reg.counter("repro_bucket_batches_total",
                                 "Dispatched buckets by bucket size.",
                                 labelnames=("bucket",))
        for b, v in buckets.items():
            per_bucket.child(bucket=b).set(v)
        if shed:
            shed_c = reg.counter(
                "repro_admission_shed_total",
                "Requests shed by the admission controller.",
                labelnames=("reason",))
            for reason, v in shed.items():
                shed_c.child(reason=reason).set(v)

    # -- shutdown support ---------------------------------------------------

    def fail_pending(self, exc: Exception) -> None:
        """Drop every queued request, failing its future (caller holds the
        lock).  Used by ``shutdown(wait=False)``."""
        for q in self.queues.values():
            while q.requests:
                r = q.requests.popleft()
                self.pending -= 1
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(exc)
                if r.trace is not None:
                    r.trace.finish(error=type(exc).__name__)
            q.tagged = 0
