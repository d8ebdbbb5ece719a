"""Admission layer: who gets into the queues, and when to say no.

The serving stack (docs/serving.md) is transport -> **admission** ->
scheduler -> dispatch.  This module is the second layer: before a request
is enqueued, the ``AdmissionController`` decides whether the service can
afford it --

  * **per-client token buckets** -- each client identity refills
    ``rate`` requests/second up to a ``burst`` ceiling; a drained bucket
    rejects with ``ServiceOverloaded`` (and a ``retry_after_s`` hint)
    instead of letting one chatty client fill the bounded queues.
  * **priority classes** -- every request is ``"interactive"`` (latency
    sensitive, drained first by the scheduler) or ``"batch"`` (throughput
    traffic).  Admission gives interactive traffic *headroom*: under load
    shedding, batch requests are refused first.
  * **load shedding at a high-water mark** -- once the scheduler's queue
    depth crosses ``high_water``, batch submits are refused with
    ``ServiceOverloaded``; interactive submits keep landing until
    ``high_water * interactive_headroom``.  Past that everything sheds.
    This is distinct from the queue-full *backpressure* path
    (``ServiceQueueFull`` -- the caller asked to not block): shedding is a
    policy decision made before the queue is exhausted, so well-behaved
    clients see a typed, retryable rejection instead of a timeout.

This module deliberately imports nothing from ``repro_torch.engine`` -- it is
pure policy over a ``depth()`` callable -- so it sits at the bottom of the
serving import graph.  The service exception types live here (the engine
facade re-exports them for compatibility).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch import obs

__all__ = [
    "ServiceClosed", "ServiceQueueFull", "ServiceOverloaded",
    "PRIORITIES", "DEFAULT_PRIORITY", "priority_rank",
    "ClientPolicy", "TokenBucket", "AdmissionController",
]


class ServiceClosed(RuntimeError):
    """Submit after shutdown, or pending work cancelled by shutdown."""


class ServiceQueueFull(RuntimeError):
    """Bounded queue is full and the caller declined to wait."""


class ServiceOverloaded(RuntimeError):
    """Admission refused the request: rate limit or load shedding.

    Carries ``retry_after_s`` -- the earliest time the client's token
    bucket can pay for one request again (0.0 for depth-based shedding,
    where "later" depends on the service draining, not on the client)."""

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


# strict priority order: the scheduler drains lower ranks first
PRIORITIES = ("interactive", "batch")
DEFAULT_PRIORITY = "batch"
_RANK = {p: i for i, p in enumerate(PRIORITIES)}

# cached shed-counter children (rejections are off the happy path, but a
# shed storm should not pay label resolution per refusal either)
_SHED_CHILDREN: dict = {}


def _shed_child(reason: str):
    c = _SHED_CHILDREN.get(reason)
    if c is None:
        c = _SHED_CHILDREN[reason] = obs.default_registry().counter(
            "repro_admission_shed_total",
            "Requests refused by admission control.",
            labelnames=("reason",)).child(reason=reason)
    return c


obs.on_reset(_SHED_CHILDREN.clear)


def priority_rank(priority: str) -> int:
    """0 for interactive, 1 for batch; raises on unknown classes."""
    try:
        return _RANK[priority]
    except KeyError:
        raise ValueError(
            f"unknown priority {priority!r}; expected one of {PRIORITIES}"
        ) from None


@dataclass(frozen=True)
class ClientPolicy:
    """Per-client admission knobs.

    rate   : sustained requests/second refill (None = unlimited).
    burst  : token-bucket ceiling -- how many requests a client can fire
             back-to-back before the rate limit bites.
    weight : weighted-fair dequeue share in the scheduler (relative to
             the other clients competing for the same plan queue).
    """
    rate: Optional[float] = None
    burst: int = 32
    weight: float = 1.0


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` capacity.

    Not thread-safe on its own; the AdmissionController serializes."""

    def __init__(self, rate: float, burst: int):
        if rate <= 0:
            raise ValueError(f"rate={rate} must be > 0")
        if burst < 1:
            raise ValueError(f"burst={burst} must be >= 1")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.last_t: Optional[float] = None

    def try_take(self, now: float, cost: float = 1.0) -> bool:
        if self.last_t is not None:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.last_t) * self.rate)
        self.last_t = now
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False

    def retry_after(self, cost: float = 1.0) -> float:
        """Seconds until ``cost`` tokens will have refilled."""
        return max(0.0, (cost - self.tokens) / self.rate)


class AdmissionController:
    """Token-bucket rate limits + priority-aware load shedding.

    Parameters
    ----------
    default_policy : ClientPolicy applied to clients without an explicit
        entry in ``policies`` (including the anonymous ``None`` client).
    policies : {client_id: ClientPolicy} overrides.
    high_water : queue depth at which BATCH submits start shedding
        (None disables depth shedding).  ``depth()`` supplies the live
        queue depth -- the service wires its own pending counter in.
    interactive_headroom : multiplier on ``high_water`` up to which
        INTERACTIVE submits still land (default 1.5x).  At or past the
        hard mark everything sheds.
    clock : injectable monotonic clock for deterministic tests.
    """

    def __init__(self, *, default_policy: ClientPolicy = ClientPolicy(),
                 policies: Optional[dict] = None,
                 high_water: Optional[int] = None,
                 interactive_headroom: float = 1.5,
                 depth: Optional[Callable[[], int]] = None,
                 clock: Callable[[], float] = time.monotonic):
        if high_water is not None and high_water < 1:
            raise ValueError(f"high_water={high_water} must be >= 1")
        if interactive_headroom < 1.0:
            raise ValueError(
                f"interactive_headroom={interactive_headroom} must be >= 1")
        self.default_policy = default_policy
        self.policies = dict(policies or {})
        self.high_water = high_water
        self.interactive_headroom = float(interactive_headroom)
        self.depth = depth
        self._clock = clock
        self._buckets: dict = {}
        self._lock = threading.Lock()
        self.shed = {"rate": 0, "depth": 0}     # rejection counters

    def policy(self, client: Optional[str]) -> ClientPolicy:
        return self.policies.get(client, self.default_policy)

    def weight(self, client: Optional[str]) -> float:
        return self.policy(client).weight

    def admit(self, client: Optional[str], priority: str = DEFAULT_PRIORITY,
              cost: float = 1.0, now: Optional[float] = None) -> None:
        """Raise ``ServiceOverloaded`` if this request must be refused.

        Order matters: the depth check first (shedding protects the whole
        service; a shed request must not drain the client's bucket), then
        the per-client token bucket."""
        rank = priority_rank(priority)
        if self.high_water is not None and self.depth is not None:
            limit = self.high_water
            if rank == 0:       # interactive headroom
                limit = int(self.high_water * self.interactive_headroom)
            if self.depth() >= limit:
                with self._lock:
                    self.shed["depth"] += 1
                if obs.enabled():
                    _shed_child("depth").inc()
                raise ServiceOverloaded(
                    f"load shedding: {self.depth()} requests pending >= "
                    f"{limit} ({priority} high-water mark)")
        pol = self.policy(client)
        if pol.rate is None:
            return
        t = self._clock() if now is None else float(now)
        with self._lock:
            bucket = self._buckets.get(client)
            if bucket is None:
                bucket = self._buckets[client] = TokenBucket(
                    pol.rate, pol.burst)
            if not bucket.try_take(t, cost):
                self.shed["rate"] += 1
                if obs.enabled():
                    _shed_child("rate").inc()
                retry = bucket.retry_after(cost)
                raise ServiceOverloaded(
                    f"client {client!r} over rate limit "
                    f"({pol.rate:g} req/s, burst {pol.burst}); retry in "
                    f"{retry:.3f}s", retry_after_s=retry)

    def stats(self) -> dict:
        with self._lock:
            return {"shed_rate": self.shed["rate"],
                    "shed_depth": self.shed["depth"],
                    "clients_tracked": len(self._buckets)}
