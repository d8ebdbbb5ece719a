"""repro_torch.serving: the layered network-facing curvature serving stack.

Counterpart of ``repro.serving``.  Four layers, bottom of the import graph
first:

  admission  -- ``AdmissionController``: per-client token buckets,
                priority classes, high-water load shedding.  The service
                exception types (``ServiceClosed``, ``ServiceQueueFull``,
                ``ServiceOverloaded``) live here.  A copy of the
                reference's module.
  scheduler  -- ``Scheduler``: bounded per-plan queues, micro-bucket
                triggers, weighted-fair dequeue, cross-n ragged
                coalescing over ``RaggedFamily`` plans.
  dispatch   -- ``Dispatcher``: worker threads executing coalesced buckets
                on their plans' devices and resolving futures.
  frontend   -- ``CurvatureFrontend`` / ``CurvatureClient``: line-
                delimited JSON over TCP (``serving.protocol``, a copy of
                the reference's) bridging remote callers onto
                ``CurvatureService.submit``.

Most code should use the facade -- ``repro_torch.engine.CurvatureService``
/ ``plan.submit`` -- which wires admission + scheduler + dispatch together;
the frontend is what ``repro_torch.launch.serve`` speaks.

Exports resolve lazily (PEP 562): the admission layer imports nothing
from ``repro_torch.engine`` while scheduler/dispatch/frontend do, so eager
imports here would cycle with ``repro_torch.engine.service``.
"""

from __future__ import annotations

_EXPORTS = {
    # admission
    "ServiceClosed": "admission",
    "ServiceQueueFull": "admission",
    "ServiceOverloaded": "admission",
    "ClientPolicy": "admission",
    "TokenBucket": "admission",
    "AdmissionController": "admission",
    "PRIORITIES": "admission",
    "DEFAULT_PRIORITY": "admission",
    "priority_rank": "admission",
    # scheduler
    "Request": "scheduler",
    "PlanQueue": "scheduler",
    "RaggedGroup": "scheduler",
    "Scheduler": "scheduler",
    # dispatch
    "Dispatcher": "dispatch",
    # transport
    "CurvatureFrontend": "frontend",
    "CurvatureClient": "frontend",
    "connect": "frontend",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
