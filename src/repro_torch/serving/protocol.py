"""Wire protocol for the curvature front-end: line-delimited JSON.

One request per line, one response per line, matched by ``id`` (responses
may arrive OUT OF ORDER -- the service resolves futures as buckets
complete, and the front-end writes each response the moment its future
resolves, which is what lets one connection's interactive requests overtake
its batch ones).

Request frame::

    {"id": 7, "method": "hvp", "plan": "rosenbrock", "n": 12,
     "a": [...n floats...], "v": [...n floats...],
     "client": "trainer-0", "priority": "interactive"}

Methods:

  hvp     : a, v required -> result is the n-vector H_f(a) @ v
  hessian : a required    -> result is the (n, n) dense Hessian (nested
            lists)
  ping    : liveness probe -> result "pong"
  plans   : -> result {name: {"family": bool}} of the served plan registry
  stats   : -> result the service's stats() snapshot
  metrics : -> result the obs metrics registry; ``"format": "json"``
            (default, the structured exporter) or ``"prometheus"`` (the
            text exposition format as one string)
  trace   : -> result {"traces": [...], "events": [...]} from the obs
            flight recorder; ``"k"`` bounds the count (default 16),
            ``"slow": true`` selects the slowest-k view instead of the
            most recent (docs/observability.md)

Response frame::

    {"id": 7, "ok": true, "result": [...]}
    {"id": 7, "ok": false, "error": {"code": "overloaded",
     "message": "...", "retry_after_s": 0.25}}

Error codes map 1:1 onto the service's typed exceptions so a remote client
can re-raise exactly what an in-process caller would have seen:

  overloaded  -> ServiceOverloaded (admission refused; retry_after_s hint)
  queue_full  -> ServiceQueueFull  (backpressure bound hit)
  closed      -> ServiceClosed     (service shut down)
  bad_request -> ValueError        (malformed frame / wrong shapes)
  internal    -> RuntimeError      (anything else; message included)

Payloads are plain JSON numbers (float32 precision is the service's
marshalling dtype anyway); this keeps the protocol dependency-free and
debuggable with ``nc``.  Framing is a single ``\\n`` -- frames must not
contain raw newlines, which ``json.dumps`` guarantees.
"""

from __future__ import annotations

import json
from typing import Optional

from .admission import ServiceClosed, ServiceOverloaded, ServiceQueueFull

__all__ = [
    "METHODS", "encode", "decode", "error_frame", "result_frame",
    "code_for", "exception_for",
]

METHODS = ("hvp", "hessian", "ping", "plans", "stats", "metrics", "trace")

_EXC_CODE = (
    (ServiceOverloaded, "overloaded"),
    (ServiceQueueFull, "queue_full"),
    (ServiceClosed, "closed"),
    (ValueError, "bad_request"),
)


def encode(frame: dict) -> bytes:
    """One frame -> one line of UTF-8 JSON (terminator included)."""
    return (json.dumps(frame, separators=(",", ":")) + "\n").encode("utf-8")


def decode(line: bytes) -> dict:
    """One line -> frame dict; raises ValueError on malformed input."""
    try:
        frame = json.loads(line)
    except json.JSONDecodeError as e:
        raise ValueError(f"malformed JSON frame: {e}") from None
    if not isinstance(frame, dict):
        raise ValueError(
            f"frame must be a JSON object, got {type(frame).__name__}")
    return frame


def result_frame(rid, result) -> dict:
    return {"id": rid, "ok": True, "result": result}


def error_frame(rid, exc: BaseException) -> dict:
    err = {"code": code_for(exc), "message": str(exc)}
    retry = getattr(exc, "retry_after_s", None)
    if retry:
        err["retry_after_s"] = float(retry)
    return {"id": rid, "ok": False, "error": err}


def code_for(exc: BaseException) -> str:
    for cls, code in _EXC_CODE:
        if isinstance(exc, cls):
            return code
    return "internal"


def exception_for(code: str, message: str,
                  retry_after_s: Optional[float] = None) -> Exception:
    """Rebuild the typed exception a remote error frame stands for."""
    if code == "overloaded":
        return ServiceOverloaded(message, retry_after_s=retry_after_s or 0.0)
    if code == "queue_full":
        return ServiceQueueFull(message)
    if code == "closed":
        return ServiceClosed(message)
    if code == "bad_request":
        return ValueError(message)
    return RuntimeError(message)
