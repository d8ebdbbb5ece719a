"""Transport layer: a TCP front-end over ``CurvatureService.submit``.

Counterpart of ``repro.serving.frontend``.  The serving stack is
**transport** -> admission ->
scheduler -> dispatch.  This module is the outermost layer: a threaded
socket server speaking the line-delimited JSON protocol of
``serving.protocol``, and the matching client.

Design points:

  * **one thread per connection, futures per request** -- the connection
    thread only parses frames and calls ``service.submit``; responses are
    written from future callbacks (dispatch threads) the moment each
    bucket completes.  Responses therefore go out OUT OF ORDER, matched
    by ``id`` -- requests from one connection coalesce with everyone
    else's, and an interactive request overtakes queued batch work
    exactly as it does in-process.
  * **named plans, not pickled functions** -- remote callers reference a
    server-side plan registry by name (+ the row width ``n``); the
    front-end builds and caches one CurvaturePlan per (name, n), so all
    connections share callables, queues and the cross-n RaggedGroups.
  * **typed rejections on the wire** -- admission/backpressure exceptions
    map to protocol error codes and back (``ServiceOverloaded`` keeps its
    ``retry_after_s`` hint through a round-trip).

Usage::

    plans = {"rosenbrock": lambda n: engine.plan(
        testfns.ragged_family("rosenbrock"), n, symmetric=False,
        device="cuda")}
    with CurvatureFrontend(plans, service=svc) as fe:
        with connect(*fe.address, client="c0") as cli:
            r = cli.hvp("rosenbrock", a, v)       # == plan.hvp(a, v)
"""

from __future__ import annotations

import socket
import threading
from concurrent.futures import Future
from typing import Callable, Optional

import numpy as np

from repro_torch import obs

from .admission import DEFAULT_PRIORITY, ServiceClosed
from . import protocol

__all__ = ["CurvatureFrontend", "CurvatureClient", "connect"]


class CurvatureFrontend:
    """Threaded TCP server bridging the wire protocol onto a service.

    ``plans`` maps public names to either a fixed ``CurvaturePlan`` or a
    factory ``n -> CurvaturePlan`` (families).  ``service=None`` makes the
    front-end construct -- and own -- a ``CurvatureService`` from the
    remaining keyword arguments, shut down with the front-end."""

    def __init__(self, plans: dict, *, service=None,
                 host: str = "127.0.0.1", port: int = 0, backlog: int = 64,
                 **service_kwargs):
        if not plans:
            raise ValueError("plans registry must not be empty")
        self.plans = dict(plans)
        if service is None:
            from repro_torch.engine.service import CurvatureService
            service = CurvatureService(**service_kwargs)
            self._owns_service = True
        elif service_kwargs:
            raise ValueError(
                f"service= was given, so the service knobs "
                f"{sorted(service_kwargs)} have nowhere to go")
        else:
            self._owns_service = False
        self.service = service
        self._host, self._port = host, int(port)
        self._backlog = int(backlog)
        self._plan_cache: dict = {}             # (name, n) -> CurvaturePlan
        self._plan_lock = threading.Lock()
        self._conns: set = set()
        self._conn_lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()

    # -- lifecycle ----------------------------------------------------------

    @property
    def address(self):
        """(host, port) actually bound (port 0 resolves at ``start``)."""
        if self._sock is None:
            raise RuntimeError("front-end not started")
        return self._sock.getsockname()[:2]

    def start(self) -> "CurvatureFrontend":
        if self._sock is not None:
            return self
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self._host, self._port))
        s.listen(self._backlog)
        self._sock = s
        self._accept_thread = threading.Thread(
            target=self._accept_loop, args=(s,),
            name="curvature-frontend-accept", daemon=True)
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        """Close the listener and every connection; drain an owned service.

        Idempotent.  In-flight requests still resolve (the service drains
        before an owned service shuts down), but their responses are only
        delivered if the client kept its connection open from its side --
        we close OUR sockets after the service quiesces."""
        if self._stopped.is_set():
            return
        self._stopped.set()
        s, self._sock = self._sock, None
        if s is not None:
            # shutdown() before close(): close alone does not wake a
            # thread parked in accept() on Linux
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        t, self._accept_thread = self._accept_thread, None
        if t is not None:
            t.join()
        if self._owns_service:
            self.service.shutdown(wait=True)
        with self._conn_lock:
            conns, self._conns = list(self._conns), set()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    close = stop

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- server internals ---------------------------------------------------

    def _accept_loop(self, sock: socket.socket) -> None:
        while not self._stopped.is_set():
            try:
                conn, _addr = sock.accept()
            except OSError:
                return              # listener closed by stop()
            with self._conn_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="curvature-frontend-conn",
                             daemon=True).start()

    def _plan_for(self, name: str, n):
        spec = self.plans.get(name)
        if spec is None:
            raise ValueError(
                f"unknown plan {name!r}; served plans: "
                f"{sorted(self.plans)}")
        if not callable(spec) or hasattr(spec, "executable"):
            return spec             # a fixed CurvaturePlan
        if n is None:
            raise ValueError(
                f"plan {name!r} is a family; the frame must carry \"n\"")
        key = (name, int(n))
        with self._plan_lock:
            p = self._plan_cache.get(key)
            if p is None:
                # cache the built plan: stable plan identity keeps the
                # scheduler's submit route and the executable cache hot,
                # and all connections share the same queues
                p = self._plan_cache[key] = spec(int(n))
        return p

    def _serve_conn(self, conn: socket.socket) -> None:
        wlock = threading.Lock()    # future callbacks interleave writes
        reader = conn.makefile("rb")

        def reply(frame: dict) -> None:
            data = protocol.encode(frame)
            try:
                with wlock:
                    conn.sendall(data)
            except OSError:
                pass                # client went away; nothing to tell it

        try:
            for line in reader:
                if self._stopped.is_set():
                    break
                rid = None
                try:
                    frame = protocol.decode(line)
                    rid = frame.get("id")
                    self._handle(frame, rid, reply)
                except Exception as e:      # typed -> wire code
                    reply(protocol.error_frame(rid, e))
        finally:
            try:
                reader.close()
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
            with self._conn_lock:
                self._conns.discard(conn)

    def _handle(self, frame: dict, rid, reply: Callable) -> None:
        method = frame.get("method")
        if method == "ping":
            reply(protocol.result_frame(rid, "pong"))
            return
        if method == "plans":
            listing = {
                name: {"family": callable(spec)
                       and not hasattr(spec, "executable")}
                for name, spec in self.plans.items()}
            reply(protocol.result_frame(rid, listing))
            return
        if method == "stats":
            stats = self.service.stats()
            stats["buckets"] = {str(k): v
                                for k, v in stats["buckets"].items()}
            reply(protocol.result_frame(rid, stats))
            return
        if method == "metrics":
            fmt = frame.get("format", "json")
            reg = obs.metrics_registry()
            if fmt == "prometheus":
                reply(protocol.result_frame(rid, reg.to_prometheus()))
            elif fmt == "json":
                reply(protocol.result_frame(rid, reg.to_json()))
            else:
                raise ValueError(
                    f"metrics format must be 'json' or 'prometheus', "
                    f"got {fmt!r}")
            return
        if method == "trace":
            rec = obs.recorder()
            k = int(frame.get("k", 16))
            traces = (rec.slowest(k) if frame.get("slow")
                      else rec.recent(k))
            reply(protocol.result_frame(rid, {
                "traces": [t.to_dict() for t in traces],
                "events": rec.events(k),
            }))
            return
        if method not in ("hvp", "hessian"):
            raise ValueError(
                f"unknown method {method!r}; expected one of "
                f"{protocol.METHODS}")
        # the trace starts HERE, at decode time, so queueing for admission
        # and everything downstream -- including the response write, which
        # runs inside the dispatch worker's done-callback -- lands on it
        trace = obs.trace_begin(
            rid=rid, method=method, client=frame.get("client"),
            priority=frame.get("priority", DEFAULT_PRIORITY),
            transport="tcp") if obs.enabled() else None
        try:
            if "a" not in frame:
                raise ValueError(f"{method} frame needs \"a\"")
            plan = self._plan_for(frame.get("plan"), frame.get("n"))
            a = np.asarray(frame["a"], np.float32)
            v = None
            if method == "hvp":
                if "v" not in frame:
                    raise ValueError("hvp frame needs \"v\"")
                v = np.asarray(frame["v"], np.float32)
            priority = frame.get("priority", DEFAULT_PRIORITY)
            fut = self.service.submit(
                plan, a, v, client=frame.get("client"), priority=priority,
                trace=trace)
        except Exception as e:
            # submit() seals the trace for its own rejections (finish is
            # idempotent); this covers decode/marshal failures before it
            if trace is not None:
                trace.finish(error=type(e).__name__)
            raise

        def _done(f: Future, _rid=rid) -> None:
            exc = f.exception()
            if exc is not None:
                reply(protocol.error_frame(_rid, exc))
            else:
                reply(protocol.result_frame(_rid, f.result().tolist()))

        fut.add_done_callback(_done)


class CurvatureClient:
    """Protocol client: one socket, a reader thread, futures per request.

    ``client=`` tags every request with this identity for the server's
    admission/fairness layers (overridable per call)."""

    def __init__(self, host: str, port: int, *,
                 client: Optional[str] = None,
                 connect_timeout: Optional[float] = 10.0):
        self.client = client
        self._sock = socket.create_connection((host, port), connect_timeout)
        self._sock.settimeout(None)
        self._reader = self._sock.makefile("rb")
        self._wlock = threading.Lock()
        self._lock = threading.Lock()
        self._futures: dict = {}
        self._next_id = 0
        self._closed = False
        self._thread = threading.Thread(
            target=self._read_loop, name="curvature-client-reader",
            daemon=True)
        self._thread.start()

    # -- plumbing -----------------------------------------------------------

    def _call(self, method: str, **fields) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise ServiceClosed("client connection closed")
            rid = self._next_id
            self._next_id += 1
            self._futures[rid] = fut
        frame = {"id": rid, "method": method}
        frame.update({k: v for k, v in fields.items() if v is not None})
        try:
            with self._wlock:
                self._sock.sendall(protocol.encode(frame))
        except OSError as e:
            with self._lock:
                self._futures.pop(rid, None)
            raise ServiceClosed(f"connection lost: {e}") from None
        return fut

    def _read_loop(self) -> None:
        try:
            for line in self._reader:
                frame = protocol.decode(line)
                with self._lock:
                    fut = self._futures.pop(frame.get("id"), None)
                if fut is None:
                    continue        # response to a forgotten request
                if frame.get("ok"):
                    fut.set_result(frame.get("result"))
                else:
                    err = frame.get("error") or {}
                    fut.set_exception(protocol.exception_for(
                        err.get("code", "internal"),
                        err.get("message", "unknown server error"),
                        err.get("retry_after_s")))
        except (OSError, ValueError):
            pass
        finally:
            with self._lock:
                self._closed = True
                pending, self._futures = self._futures, {}
            for fut in pending.values():
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(
                        ServiceClosed("connection closed by server"))

    # -- async API (futures) ------------------------------------------------

    def submit_hvp(self, plan: str, a, v, *, n: Optional[int] = None,
                   client: Optional[str] = None,
                   priority: Optional[str] = None) -> Future:
        a = np.asarray(a, np.float32)
        v = np.asarray(v, np.float32)
        return self._call(
            "hvp", plan=plan, n=int(n) if n is not None else len(a),
            a=a.tolist(), v=v.tolist(),
            client=client if client is not None else self.client,
            priority=priority)

    def submit_hessian(self, plan: str, a, *, n: Optional[int] = None,
                       client: Optional[str] = None,
                       priority: Optional[str] = None) -> Future:
        a = np.asarray(a, np.float32)
        return self._call(
            "hessian", plan=plan, n=int(n) if n is not None else len(a),
            a=a.tolist(),
            client=client if client is not None else self.client,
            priority=priority)

    # -- sync API -----------------------------------------------------------

    def hvp(self, plan: str, a, v, timeout: Optional[float] = 60.0,
            **kw) -> np.ndarray:
        return np.asarray(
            self.submit_hvp(plan, a, v, **kw).result(timeout), np.float32)

    def hessian(self, plan: str, a, timeout: Optional[float] = 60.0,
                **kw) -> np.ndarray:
        return np.asarray(
            self.submit_hessian(plan, a, **kw).result(timeout), np.float32)

    def ping(self, timeout: Optional[float] = 10.0) -> str:
        return self._call("ping").result(timeout)

    def plans(self, timeout: Optional[float] = 10.0) -> dict:
        return self._call("plans").result(timeout)

    def stats(self, timeout: Optional[float] = 10.0) -> dict:
        return self._call("stats").result(timeout)

    def metrics(self, format: str = "json",
                timeout: Optional[float] = 10.0):
        """The server's obs metrics registry: a dict (``format="json"``)
        or the Prometheus text exposition as one string."""
        return self._call("metrics", format=format).result(timeout)

    def trace(self, k: int = 16, slow: bool = False,
              timeout: Optional[float] = 10.0) -> dict:
        """Recent (or slowest-k) request traces + recorded events from
        the server's flight recorder."""
        return self._call("trace", k=int(k),
                          slow=True if slow else None).result(timeout)

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def connect(host: str, port: int, **kwargs) -> CurvatureClient:
    """Open a CurvatureClient (thin alias, reads well at call sites)."""
    return CurvatureClient(host, port, **kwargs)
