"""repro_torch.obs -- unified observability: metrics, tracing, profiling.

Counterpart of ``repro.obs``: ``metrics``, ``trace`` and ``http`` are
copies of the reference's stdlib-only modules, and ``profile`` captures
with ``torch.profiler`` (imported lazily inside profile.py), so the
package is importable from every layer of the stack without cycles.
Three pillars:

  * :mod:`repro_torch.obs.metrics` -- process-wide named counters/gauges/
    histograms with labels, lock-striped, Prometheus + JSON exporters;
  * :mod:`repro_torch.obs.trace`   -- per-request span traces + a bounded
    flight recorder with a slow-request ring and structured events;
  * :mod:`repro_torch.obs.profile` -- torch.profiler capture sessions
    (a Chrome trace per session) and per-plan trace annotations.

The single hot-path contract: **everything is off-by-one-branch when
disabled.**  ``enabled()`` is a module-level bool read; ``trace_begin``
returns ``None`` when disabled and every integration point guards with
``if trace is not None``.

Disable via ``REPRO_OBS=0`` in the environment or ``obs.disable()`` at
runtime; the metric and span catalog is the reference's
(docs/observability.md).
"""

from __future__ import annotations

import os
import time
from typing import Optional

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_registry)
from .profile import annotate, is_active, profile_session
from .trace import FlightRecorder, Trace, default_recorder

__all__ = [
    "enabled", "enable", "disable", "set_enabled",
    "trace_begin", "event", "reset",
    "metrics_registry", "recorder",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "default_registry",
    "Trace", "FlightRecorder", "default_recorder",
    "annotate", "is_active", "profile_session",
]

_ENABLED: bool = os.environ.get("REPRO_OBS", "1").lower() not in (
    "0", "false", "off", "no")


def enabled() -> bool:
    """The one hot-path guard: a module-level bool read."""
    return _ENABLED


def set_enabled(value: bool) -> None:
    global _ENABLED
    _ENABLED = bool(value)


def enable() -> None:
    set_enabled(True)


def disable() -> None:
    set_enabled(False)


def metrics_registry() -> MetricsRegistry:
    return default_registry()


def recorder() -> FlightRecorder:
    return default_recorder()


def trace_begin(**meta) -> Optional[Trace]:
    """Start a per-request trace, or ``None`` when obs is disabled.

    Callers hold the returned Trace on the request object and guard all
    subsequent span work with ``if trace is not None``.
    """
    if not _ENABLED:
        return None
    return Trace(meta=meta)


def event(kind: str, **fields) -> Optional[dict]:
    """Record a structured one-shot event (retune decision, shed storm)
    into the flight recorder's event ring.  No-op when disabled."""
    if not _ENABLED:
        return None
    return default_recorder().record_event(kind, **fields)


def reset() -> None:
    """Fresh registry + recorder state (tests).

    The default registry object is kept (so modules holding a reference
    keep emitting into the live one) but emptied; the default recorder
    is replaced and its metric-child cache flushed.  Integration points
    that cache metric children re-resolve via ``_flush_metric_cache``
    hooks registered here.
    """
    default_registry().reset()
    rec = default_recorder()
    rec.clear()
    rec._flush_metric_cache()
    for hook in list(_reset_hooks):
        hook()


_reset_hooks = []


def on_reset(hook) -> None:
    """Register a callable invoked by :func:`reset` -- used by modules
    that cache bound metric children so they re-resolve after a reset."""
    _reset_hooks.append(hook)


# convenience so tests can do `with obs.fake_clock(...)` style injection
def make_test_registry(clock=None) -> MetricsRegistry:
    return MetricsRegistry(clock=clock if clock is not None
                           else time.perf_counter)
