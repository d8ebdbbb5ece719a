"""Request tracing: spans, per-request trace contexts, flight recorder.

The observability pillar that answers "where did request X spend its
time?" (docs/observability.md).  A :class:`Trace` is created when a
request enters the system (``Scheduler.submit`` or frontend decode),
rides on the queued request object, accumulates spans through admission
-> scheduling -> dispatch -> device execute -> respond, and on
``finish()`` lands in the process :class:`FlightRecorder` -- a bounded
ring buffer with a separate slow-request ring and a structured-event
ring (retune decisions, shed storms).

Hot-path discipline (the reference's ``repro.obs`` is gated at <=5%
enabled by benchmarks/obs_bench; this copy keeps its design):

  * spans are stored as plain tuples ``(name, t0, t1, meta_or_None)`` --
    no per-span object allocation beyond the tuple; batch-identical
    spans are ONE shared tuple referenced by every member trace;
  * ``Trace`` uses ``__slots__`` and touches no lock until ``finish()``;
  * batch-level metadata (bucket id, pad waste, family) is ONE shared
    dict per dispatched batch, referenced by every member trace;
  * ``record()`` does NOT feed histograms inline: finished traces queue
    in a pending ring and are **digested in chunks** -- at scrape time
    (the registry collector) or when the ring hits ``_DIGEST_CHUNK`` --
    so the per-request cost is two deque appends and the span-duration
    histograms are paid in rare amortized bursts off the scrape path's
    critical requests.

Everything here is also injectable-clock for deterministic tests.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Callable, Optional

from .metrics import default_registry

__all__ = ["Trace", "FlightRecorder", "default_recorder"]

_trace_ids = itertools.count(1)

# pending-digest chunk: a full chunk digests inline (bounds memory); the
# burst is ~_DIGEST_CHUNK * spans histogram updates, amortized well under
# a microsecond per recorded trace
_DIGEST_CHUNK = 512


class _SpanCtx:
    """Context manager recording one span on a trace (tuple on exit)."""

    __slots__ = ("_trace", "_name", "_meta", "_t0")

    def __init__(self, trace: "Trace", name: str, meta):
        self._trace = trace
        self._name = name
        self._meta = meta

    def __enter__(self):
        self._t0 = self._trace.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._trace.add_span(self._name, self._t0, self._trace.clock(),
                             self._meta)
        return False


class Trace:
    """Per-request span accumulator.

    Created via ``obs.trace_begin(**meta)`` (which returns ``None`` when
    observability is disabled -- callers guard with ``if trace is not
    None``).  Not thread-safe per instance by design: each request's
    trace is only touched by one thread at a time (submit thread, then
    exactly one dispatch worker).
    """

    __slots__ = ("trace_id", "t_start", "meta", "spans", "marks",
                 "clock", "_recorder", "_done")

    def __init__(self, *, meta: Optional[dict] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 recorder: Optional["FlightRecorder"] = None):
        self.trace_id = next(_trace_ids)
        self.clock = clock
        self.t_start = clock()
        self.meta = meta if meta is not None else {}
        self.spans = []    # (name, t0, t1, meta_or_None)
        self.marks = {}    # name -> timestamp
        self._recorder = recorder
        self._done = False

    # -- recording ----------------------------------------------------------

    def mark(self, name: str) -> float:
        """Record a named instant (pairs of marks delimit later spans)."""
        t = self.clock()
        self.marks[name] = t
        return t

    def add_span(self, name: str, t0: float, t1: float,
                 meta: Optional[dict] = None) -> None:
        self.spans.append((name, t0, t1, meta))

    def span(self, name: str, meta: Optional[dict] = None) -> _SpanCtx:
        """``with trace.span("admit"): ...`` -- records on exit."""
        return _SpanCtx(self, name, meta)

    def finish(self, error: Optional[str] = None) -> None:
        """Seal the trace and hand it to the recorder (idempotent)."""
        if self._done:
            return
        self._done = True
        if error is not None:
            self.meta["error"] = error
        rec = self._recorder if self._recorder is not None \
            else default_recorder()
        rec.record(self)

    @property
    def duration_s(self) -> float:
        if not self.spans:
            return 0.0
        return max(t1 for _n, _t0, t1, _m in self.spans) - self.t_start

    # -- export -------------------------------------------------------------

    def to_dict(self) -> dict:
        """JSON-safe dict; span times are ms relative to trace start."""
        t0 = self.t_start
        spans = []
        for name, s0, s1, meta in self.spans:
            d = {"name": name, "start_ms": (s0 - t0) * 1e3,
                 "dur_ms": (s1 - s0) * 1e3}
            if meta:
                d["meta"] = {k: _jsonable(v) for k, v in meta.items()}
            spans.append(d)
        return {
            "trace_id": self.trace_id,
            "duration_ms": self.duration_s * 1e3,
            "meta": {k: _jsonable(v) for k, v in self.meta.items()},
            "spans": spans,
        }


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


class FlightRecorder:
    """Bounded rings of recent traces, slow traces, and events.

    * ``recent(k)`` -- the k most recently finished traces;
    * ``slowest(k)`` -- top-k by duration across the recent AND slow
      rings, so a slow outlier survives long after fast traffic has
      rotated it out of ``recent``;
    * ``record_event``/``events(k)`` -- structured one-shot events
      (retune decisions etc.), each stamped with wall + mono time.

    Every recorded trace ALSO feeds the per-span duration histogram
    ``repro_span_duration_us{span=...}`` and the ``repro_traces_total``
    counter -- but deferred: ``record`` queues the trace in a pending
    ring and ``digest()`` (called by the registry's scrape-time
    collector, or inline once ``_DIGEST_CHUNK`` traces have queued)
    drains it into the metrics registry.  Span latency distributions are
    therefore always current at export time and survive the trace
    rotating out of ``recent``, without per-request histogram updates on
    the serving hot path.
    """

    def __init__(self, *, capacity: int = 256, slow_capacity: int = 64,
                 slow_threshold_s: float = 0.1,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None):
        if capacity < 1 or slow_capacity < 1:
            raise ValueError("recorder capacities must be >= 1")
        self.capacity = capacity
        self.slow_capacity = slow_capacity
        self.slow_threshold_s = float(slow_threshold_s)
        self.clock = clock
        self._registry = registry
        self._lock = threading.Lock()
        self._recent: deque = deque(maxlen=capacity)
        self._slow: deque = deque(maxlen=slow_capacity)
        self._events: deque = deque(maxlen=capacity)
        self._pending: list = []
        self._recorded = 0
        self._span_children: dict = {}
        self._traces_total = None

    # -- metric children (cached; re-resolved after obs.reset) --------------

    def _span_child(self, name: str):
        c = self._span_children.get(name)
        if c is None:
            reg = self._registry if self._registry is not None \
                else default_registry()
            h = reg.histogram(
                "repro_span_duration_us",
                "Span durations across the request path (microseconds).",
                labelnames=("span",))
            c = h.child(span=name)
            self._span_children[name] = c
        return c

    def _flush_metric_cache(self) -> None:
        with self._lock:
            self._span_children.clear()
            self._traces_total = None

    # -- recording ----------------------------------------------------------

    def record(self, trace: Trace) -> None:
        """Queue one finished trace (hot path: two appends + slow check).

        The slow check uses the END OF THE LAST APPENDED SPAN as the
        trace end -- in the serving integration that is always the
        respond / device-execute span, i.e. the true end -- instead of a
        max() scan over all spans."""
        spans = trace.spans
        dur = (spans[-1][2] - trace.t_start) if spans else 0.0
        with self._lock:
            self._recent.append(trace)
            self._pending.append(trace)
            self._recorded += 1
            if dur >= self.slow_threshold_s:
                self._slow.append(trace)
            overflow = len(self._pending) >= _DIGEST_CHUNK
        if overflow:
            self.digest()

    def digest(self) -> None:
        """Drain pending traces into the metrics registry: one histogram
        observation per span, plus the absolute trace count.  Runs at
        scrape time (registry collector) or on pending-ring overflow."""
        with self._lock:
            batch = self._pending
            if batch:
                self._pending = []
            recorded = self._recorded
        children = self._span_children
        for tr in batch:
            for name, t0, t1, _meta in tr.spans:
                c = children.get(name)
                if c is None:
                    c = self._span_child(name)
                c.observe((t1 - t0) * 1e6)
        if self._traces_total is None:
            reg = self._registry if self._registry is not None \
                else default_registry()
            self._traces_total = reg.counter(
                "repro_traces_total",
                "Finished request traces recorded.").child()
        self._traces_total.set(recorded)

    def record_event(self, kind: str, **fields) -> dict:
        ev = {"kind": kind, "time": time.time(), "mono": self.clock(),
              **{k: _jsonable(v) for k, v in fields.items()}}
        with self._lock:
            self._events.append(ev)
        return ev

    # -- queries ------------------------------------------------------------

    def recent(self, k: int = 16) -> list:
        with self._lock:
            items = list(self._recent)
        return items[-k:][::-1]

    def slowest(self, k: int = 8) -> list:
        """Top-k traces by duration across recent + slow rings."""
        with self._lock:
            pool = {t.trace_id: t for t in self._recent}
            pool.update((t.trace_id, t) for t in self._slow)
        return sorted(pool.values(), key=lambda t: t.duration_s,
                      reverse=True)[:k]

    def events(self, k: int = 32) -> list:
        with self._lock:
            items = list(self._events)
        return items[-k:][::-1]

    def __len__(self) -> int:
        with self._lock:
            return len(self._recent)

    def clear(self) -> None:
        with self._lock:
            self._recent.clear()
            self._slow.clear()
            self._events.clear()
            self._pending = []
            self._recorded = 0


_DEFAULT: Optional[FlightRecorder] = None
_DEFAULT_LOCK = threading.Lock()


def default_recorder() -> FlightRecorder:
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = FlightRecorder()
    return _DEFAULT


def _replace_default(rec: Optional[FlightRecorder]) -> None:
    """Swap the process recorder (obs.reset / tests)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = rec


def _collect_default(_reg) -> None:
    """Scrape-time collector: digest whatever recorder is current."""
    rec = _DEFAULT
    if rec is not None:
        rec.digest()


default_registry().set_collector("obs.trace", _collect_default)
