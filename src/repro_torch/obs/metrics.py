"""Metrics registry: process-wide counters, gauges and histograms.

The observability pillar that answers "how much / how fast, in aggregate"
(docs/observability.md).  Dependency-free by design -- this module imports
nothing from ``repro_torch.engine`` or ``repro_torch.serving``, so every
layer of the stack can emit into it without import cycles.

Design points:

  * **named metrics with labels** -- a metric is registered once
    (``registry.counter("repro_requests_total", labelnames=("priority",))``)
    and then incremented per label combination.  The serving stack uses
    the labels ``client``, ``plan_sig``, ``bucket``, ``backend``,
    ``priority``, ``span``, ``reason``, ``kind``, ``trigger``.
  * **lock striping** -- child updates take one of ``stripes`` locks
    picked by the hash of (metric name, label values), so concurrent
    dispatch workers incrementing different series never contend on a
    single global lock; the registry-structure lock is only taken when a
    metric or child is first created (and by the exporters).
  * **bound children** -- ``metric.child(**labels)`` returns a handle
    whose ``inc``/``set``/``observe`` skips the label resolution; hot
    paths (the scheduler submit path, the dispatch loop, the trace
    recorder) cache these handles so steady-state cost is one stripe
    lock + one float add.
  * **fixed-bucket histograms** -- cumulative bucket counts plus sum and
    count, Prometheus-compatible; the default bucket ladder is tuned for
    microsecond-scale span durations.
  * **two exporters** -- ``to_prometheus()`` (text exposition format,
    served by ``obs.http`` and the wire ``metrics`` method) and
    ``to_json()`` (structured, for tests and dashboards).
  * **scrape-time collectors** -- a collector is a callback registered
    with ``set_collector(key, fn)`` that the exporters (and the
    ``value``/``total`` test reads) invoke BEFORE snapshotting.  Metrics
    that mirror telemetry the engine already maintains under its own
    locks (queue depths, dispatch counters, per-client totals, shed
    counts) are fed this way: the serving hot path pays nothing, the
    scrape pays one snapshot.  Only signals with no other home -- span
    duration histograms, trace counts, retune events -- are written
    directly.
  * **injectable clock** -- ``Histogram.time()`` measures with the
    registry clock, so tests drive timing deterministically.

All value reads (``value``/``total``/exporters) are consistent snapshots
per child, not across children -- this is a metrics registry, not a
transaction log.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Callable, Optional

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_BUCKETS_US", "default_registry",
]

# span/latency ladder in MICROSECONDS: sub-bucket-dispatch spans land in
# the 10us..1ms decades, device executes in 100us..100ms, so the ladder
# covers 10us..10s with ~3 buckets per decade
DEFAULT_BUCKETS_US = (
    10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1e3, 2.5e3, 5e3, 1e4, 2.5e4, 5e4,
    1e5, 2.5e5, 5e5, 1e6, 2.5e6, 5e6, 1e7,
)


def _label_values(labelnames: tuple, labels: dict) -> tuple:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared labelnames "
            f"{sorted(labelnames)}")
    return tuple(str(labels[k]) for k in labelnames)


class _Child:
    """One labeled series of a metric; updates take the stripe lock."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def get(self) -> float:
        with self._lock:
            return self.value


class _HistChild:
    """One labeled histogram series: per-bucket counts + sum + count."""

    __slots__ = ("_lock", "counts", "sum", "count", "_bounds")

    def __init__(self, lock: threading.Lock, bounds: tuple):
        self._lock = lock
        self._bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # +1 for the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"counts": list(self.counts), "sum": self.sum,
                    "count": self.count}


class _Metric:
    """Base: a named family of labeled children."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: tuple):
        self.registry = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: dict = {}

    def _make_child(self, lock):
        return _Child(lock)

    def child(self, **labels):
        """The bound series for one label combination (cache me on hot
        paths -- resolution is a dict lookup under the registry lock the
        first time, lock-free after)."""
        lv = _label_values(self.labelnames, labels)
        c = self._children.get(lv)
        if c is None:
            with self.registry._struct_lock:
                c = self._children.get(lv)
                if c is None:
                    c = self._make_child(self.registry._stripe(self.name, lv))
                    self._children[lv] = c
        return c

    def series(self) -> list:
        """[(label_values_tuple, child)] snapshot (exporters)."""
        with self.registry._struct_lock:
            return list(self._children.items())


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        self.child(**labels).inc(amount)

    def value(self, **labels) -> float:
        lv = _label_values(self.labelnames, labels)
        c = self._children.get(lv)
        return c.get() if c is not None else 0.0

    def total(self) -> float:
        """Sum over every label combination."""
        return sum(c.get() for _lv, c in self.series())


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self.child(**labels).set(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        self.child(**labels).inc(amount)

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.child(**labels).inc(-amount)

    def value(self, **labels) -> float:
        lv = _label_values(self.labelnames, labels)
        c = self._children.get(lv)
        return c.get() if c is not None else 0.0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, registry, name, help, labelnames,
                 buckets=DEFAULT_BUCKETS_US):
        super().__init__(registry, name, help, labelnames)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = b

    def _make_child(self, lock):
        return _HistChild(lock, self.buckets)

    def observe(self, value: float, **labels) -> None:
        self.child(**labels).observe(value)

    def time(self, **labels):
        """Context manager observing the elapsed registry-clock time (in
        the registry clock's units scaled by ``time_scale``, default us)."""
        return _HistTimer(self, labels)

    def snapshot(self, **labels) -> dict:
        lv = _label_values(self.labelnames, labels)
        c = self._children.get(lv)
        if c is None:
            return {"counts": [0] * (len(self.buckets) + 1), "sum": 0.0,
                    "count": 0}
        return c.snapshot()


class _HistTimer:
    __slots__ = ("_h", "_labels", "_t0")

    def __init__(self, h: Histogram, labels: dict):
        self._h = h
        self._labels = labels

    def __enter__(self):
        self._t0 = self._h.registry.clock()
        return self

    def __exit__(self, *exc):
        dt = self._h.registry.clock() - self._t0
        self._h.observe(dt * self._h.registry.time_scale, **self._labels)


class MetricsRegistry:
    """A process-wide (or test-local) collection of named metrics.

    ``clock`` is injectable for deterministic ``Histogram.time()`` tests;
    ``time_scale`` converts clock deltas to the histogram unit (1e6 =
    seconds clock -> microsecond buckets, matching DEFAULT_BUCKETS_US).
    """

    def __init__(self, *, clock: Callable[[], float] = time.perf_counter,
                 time_scale: float = 1e6, stripes: int = 16):
        if stripes < 1:
            raise ValueError(f"stripes={stripes} must be >= 1")
        self.clock = clock
        self.time_scale = float(time_scale)
        self._locks = tuple(threading.Lock() for _ in range(stripes))
        self._struct_lock = threading.Lock()
        self._metrics: dict = {}
        self._collectors: dict = {}

    def _stripe(self, name: str, label_values: tuple) -> threading.Lock:
        return self._locks[hash((name,) + label_values) % len(self._locks)]

    def _register(self, cls, name, help, labelnames, **kw):
        with self._struct_lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind} with labels {m.labelnames}")
                return m
            m = cls(self, name, help, tuple(labelnames), **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: tuple = ()) -> Counter:
        """Get-or-create (idempotent on identical declarations)."""
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames: tuple = (),
                  buckets=DEFAULT_BUCKETS_US) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._struct_lock:
            return self._metrics.get(name)

    # -- collectors ---------------------------------------------------------

    def set_collector(self, key: str, fn: Callable) -> None:
        """Register (or replace) a scrape-time collector.

        ``fn(registry)`` is invoked by the exporters and the ``value``/
        ``total`` reads before the snapshot; it refreshes the metric
        series it owns from live telemetry (``child(...).set(...)``).
        Keyed so an owner (one service instance) can replace and remove
        its own collector without touching others."""
        with self._struct_lock:
            self._collectors[key] = fn

    def remove_collector(self, key: str) -> None:
        with self._struct_lock:
            self._collectors.pop(key, None)

    def collect(self) -> None:
        """Run every registered collector (outside the structure lock --
        collectors create metrics and set children, which take it)."""
        with self._struct_lock:
            fns = list(self._collectors.values())
        for fn in fns:
            fn(self)

    # -- test / exporter conveniences ---------------------------------------

    def value(self, name: str, **labels) -> float:
        """Current value of one counter/gauge series (0.0 if absent)."""
        self.collect()
        m = self.get(name)
        if m is None:
            return 0.0
        return m.value(**labels)

    def total(self, name: str) -> float:
        """Sum of a counter over all its label combinations (0 if absent)."""
        self.collect()
        m = self.get(name)
        if m is None:
            return 0.0
        if isinstance(m, Counter):
            return m.total()
        return sum(c.get() for _lv, c in m.series())

    def reset(self) -> None:
        """Drop every metric (tests).  Collectors are kept -- they are
        structural wiring, and the series they own repopulate from live
        telemetry on the next scrape.  Cached children handles held by
        hot paths keep working but become unreachable from the registry,
        so callers caching children must re-resolve after a reset -- the
        serving integration does (see ``obs.reset``)."""
        with self._struct_lock:
            self._metrics.clear()

    # -- exporters ----------------------------------------------------------

    def to_json(self) -> dict:
        """{name: {type, help, labelnames, series: [{labels, value|hist}]}}"""
        self.collect()
        out = {}
        with self._struct_lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            series = []
            for lv, child in m.series():
                labels = dict(zip(m.labelnames, lv))
                if m.kind == "histogram":
                    snap = child.snapshot()
                    cum, buckets = 0, {}
                    for bound, c in zip(m.buckets, snap["counts"]):
                        cum += c
                        buckets[f"{bound:g}"] = cum
                    buckets["+Inf"] = snap["count"]
                    series.append({"labels": labels, "buckets": buckets,
                                   "sum": snap["sum"],
                                   "count": snap["count"]})
                else:
                    series.append({"labels": labels, "value": child.get()})
            out[m.name] = {"type": m.kind, "help": m.help,
                           "labelnames": list(m.labelnames),
                           "series": series}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        self.collect()
        lines = []
        with self._struct_lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {_esc_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for lv, child in m.series():
                labels = dict(zip(m.labelnames, lv))
                if m.kind == "histogram":
                    snap = child.snapshot()
                    cum = 0
                    for bound, c in zip(m.buckets, snap["counts"]):
                        cum += c
                        lines.append(
                            f"{m.name}_bucket"
                            f"{_fmt_labels({**labels, 'le': f'{bound:g}'})}"
                            f" {cum}")
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_fmt_labels({**labels, 'le': '+Inf'})}"
                        f" {snap['count']}")
                    lines.append(
                        f"{m.name}_sum{_fmt_labels(labels)} {snap['sum']:g}")
                    lines.append(
                        f"{m.name}_count{_fmt_labels(labels)} "
                        f"{snap['count']}")
                else:
                    lines.append(
                        f"{m.name}{_fmt_labels(labels)} {child.get():g}")
        return "\n".join(lines) + "\n"


def _esc_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace("\"", "\\\"")
            .replace("\n", "\\n"))


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc_label(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-default registry every repro_torch layer emits into."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = MetricsRegistry()
    return _DEFAULT
