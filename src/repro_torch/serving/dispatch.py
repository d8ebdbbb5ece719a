"""Dispatch layer: execute coalesced batches on devices, resolve futures.

Counterpart of ``repro.serving.dispatch``.  The serving stack is transport
-> admission -> scheduler -> **dispatch**.  This module turns the
scheduler's ready batches into device work:

  * **worker threads** -- each worker parks on the scheduler's ``wake``
    event / deadline timer, pops ready batches and executes them.  A port
    plan carries its own device, so a bucket always runs on its plan's
    device: a worker enters ``torch.cuda.device(plan.device)`` around a
    CUDA bucket, so its kernels launch on that device's current stream.
    The default pool is one worker per visible CUDA device (one on a
    one-card host), or one on a host without CUDA.  All workers share the
    plan callable cache and every queue's hot-swapped ``exec_by_bucket``
    winners, so re-tune swaps never drop in-flight work.
  * **dense buckets** -- single-n batches stack to (k, n), pad to the
    power-of-two bucket (``pad_rows`` edge replication) and run the
    queue's ordinary ``batched_hvp`` / ``batched_hessian`` callable,
    honoring any re-tuned per-bucket winner.  Pytree buckets stack raveled
    trees without padding rows and keep them on the host (each row reaches
    the device as its own tree inside the callable); a ``batched_diag``
    bucket adds the seed rows and each row's probe budget.  On a CUDA plan of a function
    with a device form, ``batched_hvp`` is the hand-written ``chess_hvp``
    kernel (backend ``cuda``).
  * **ragged buckets** -- a batch holding MORE THAN ONE row width (the
    scheduler's cross-n fill) pads every row to ``n_pad = max(n)``
    (``pad_cols``), stacks the effective widths into an ``NE`` vector and
    runs the RaggedGroup's ``batched_hvp_ragged`` callable; each future
    resolves to its own first ``n`` entries.  Telemetry for these batches
    is recorded under the group plan's signature, and they are excluded
    from the per-queue re-tune epoch.
  * **telemetry** -- every executed bucket reports measured us/point to
    ``registry.record_execution``, with per-client row counts.  The timed
    window opens after both operands are on the device and closes after
    the result is read back to host numpy: it charges the kernel (or
    callable) and the readback, not the host-to-device copy.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.engine import registry
from repro_torch.engine.plan import bucket_size, pad_cols, pad_rows

from .scheduler import PlanQueue, Scheduler

__all__ = ["Dispatcher"]


def _record_batch_spans(live, t0: float, t1: float, meta: dict) -> None:
    """Attach the scheduling/execution spans to every traced request of a
    batch.  ``meta`` is ONE shared dict per batch (bucket id, pad stats,
    cross-n family) referenced by all member spans -- the flight recorder
    never mutates it.

    Selection, coalescing and device execution are batch-level instants
    (``take_ready_batch`` stamps one ``selected`` time on every member),
    so those three spans are built ONCE as a shared tuple-of-tuples and
    extended onto each member's span list; only the enqueue span differs
    per request (its own submit time)."""
    shared = None
    for r in live:
        tr = r.trace
        if tr is None:
            continue
        sel = tr.marks.get("selected", t0)
        if shared is None:
            shared = (("coalesce", sel, sel, meta),
                      ("dispatch_wait", sel, t0, None),
                      ("device_execute", t0, t1, meta))
        tr.add_span("enqueue", tr.marks.get("enqueued", tr.t_start), sel)
        tr.spans.extend(shared)


def _fail_traces(live, exc: Exception) -> None:
    for r in live:
        if r.trace is not None:
            r.trace.finish(error=type(exc).__name__)


def _on_device(device: torch.device):
    """The context a bucket runs in: the plan's CUDA device made current
    (its kernels launch on that device's current stream); nothing on the
    CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _to_device(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host-to-device copy of a stacked bucket operand."""
    return torch.as_tensor(np.ascontiguousarray(rows), device=device)


def _readback(out: torch.Tensor) -> np.ndarray:
    """The result on the host: waits for the device work that makes it."""
    return out.detach().cpu().numpy()


class Dispatcher:
    """Executes batches popped from a Scheduler and runs the worker pool."""

    def __init__(self, sched: Scheduler, *, workers: Optional[int] = None):
        """``workers=None`` sizes the pool to one worker per visible CUDA
        device, or one where there is none.  ``workers=0`` is the inline
        mode (``start=False`` services): no threads, batches execute on
        whoever calls ``run_once``."""
        self.sched = sched
        if workers is None:
            workers = max(torch.cuda.device_count(), 1)
        if workers < 0:
            raise ValueError(f"workers={workers} must be >= 0")
        self.n_workers = int(workers)
        self.threads: list = []

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        for i in range(self.n_workers):
            t = threading.Thread(target=self._worker_loop,
                                 name=f"curvature-dispatch-{i}", daemon=True)
            t.start()
            self.threads.append(t)

    def join(self) -> None:
        ts, self.threads = self.threads, []
        for t in ts:
            t.join()

    # -- draining -----------------------------------------------------------

    def run_once(self, now=None, force: bool = False) -> int:
        """Pop-and-execute until no queue is ready; returns requests run."""
        sched = self.sched
        if now is None and not force:
            now = sched.clock()
        dispatched = 0
        while True:
            batch = sched.take_ready_batch(now, force=force)
            if batch is None:
                return dispatched
            q, reqs = batch
            self.execute(q, reqs)
            dispatched += len(reqs)

    def _worker_loop(self) -> None:
        sched = self.sched
        while True:
            sched.wake.clear()
            if sched.closed:
                # drain: no submits can arrive anymore.  Every worker
                # drains (take_ready_batch pops atomically, so batches are
                # never executed twice) and re-raises the wake so sibling
                # workers parked in an unbounded wait also exit.
                self.run_once(force=True)
                sched.wake.set()
                return
            if self.run_once() > 0:
                continue
            with sched.lock:
                if sched.closed:
                    continue        # loop back to the drain branch
                delay = sched.next_deadline_delay()
            # wait for a submit nudge or the oldest request's deadline
            sched.wake.wait(delay)

    # -- execution ----------------------------------------------------------

    def execute(self, q: PlanQueue, reqs) -> None:
        """Run one coalesced bucket and resolve its futures."""
        live = [r for r in reqs if r.future.set_running_or_notify_cancel()]
        if len(live) != len(reqs):
            alive = set(map(id, live))
            for r in reqs:
                if id(r) not in alive and r.trace is not None:
                    r.trace.finish(error="cancelled")
        if not live:
            return
        if q.group is not None and len({r.n for r in live}) > 1:
            self._execute_ragged(q, live)
            return
        sched = self.sched
        k = len(live)
        bucket = bucket_size(k, sched.max_batch)
        # per-bucket hot-swap: the re-tune loop installs winner callables
        # keyed by bucket; requests queued before a swap still execute (on
        # the new winner) and their futures resolve -- nothing is dropped.
        with sched.lock:
            tuned = q.exec_by_bucket.get(bucket)
        xplan, xbackend, xkey = tuned if tuned is not None \
            else (q.plan, q.backend, q.key)
        # pytree rows are whole parameter trees, run one after the other
        # (core.curvature._rows): no padding rows (each would be a whole
        # model's work), and the raveled params stay on the host, each row
        # reaching the device as its own tree inside the callable (so the
        # card never holds the bucket's other rows beside one row's work)
        rows = k if q.spec is not None else bucket
        try:
            with _on_device(xplan.device):
                # the other operands reach the device before t0: telemetry
                # charges hvp and hessian buckets the same work (execution
                # + readback, not host-to-device marshalling)
                A = np.stack([r.a for r in live])
                A = (torch.from_numpy(A) if q.spec is not None else
                     _to_device(pad_rows(A, rows), xplan.device))
                xargs = (A,)
                if q.workload != "batched_hessian":
                    xargs += (_to_device(pad_rows(
                        np.stack([r.v for r in live]), rows),
                        xplan.device),)
                if q.workload == "batched_diag":
                    # per-row probe budgets
                    xargs += (_to_device(np.asarray(
                        [r.p for r in live], np.int64), xplan.device),)
                t0 = time.perf_counter()
                exe = xplan.executable(q.workload)
                if obs.is_active():
                    # name device work in the profiler timeline; the
                    # is_active pre-check keeps the annotation object off
                    # the hot path outside capture sessions
                    with obs.annotate(
                            f"repro:{q.workload}:{xbackend}:b{bucket}"):
                        out = _readback(exe(*xargs))
                else:
                    out = _readback(exe(*xargs))
                elapsed = time.perf_counter() - t0
        except Exception as e:
            # a kernel that fails to build or launch fails the bucket's
            # futures: the caller sees the error, nothing falls back
            for r in live:
                r.future.set_exception(e)
            _fail_traces(live, e)
            return
        # telemetry charges the callable that actually ran -- after a
        # hot-swap the winner's signature accumulates the fresh history the
        # drift detector compares against its tuned baseline
        registry.record_execution(xkey, xbackend, q.workload,
                                  bucket=bucket, n_points=k,
                                  elapsed_s=elapsed,
                                  clients=self._client_rows(live))
        with sched.lock:
            sched.stats["dispatched"] += k
            sched.stats["batches"] += 1
            sched.stats["padded_rows"] += bucket - k
            sched.stats["buckets"][bucket] += 1
            q.epoch_counts[bucket] += k
            q.epoch_points += k
        traced = obs.enabled()
        if traced:
            meta = {"bucket": bucket, "rows": k,
                    "padded_rows": bucket - k, "backend": xbackend,
                    "workload": q.workload, "ragged": False}
            _record_batch_spans(live, t0, t0 + elapsed, meta)
        for i, r in enumerate(live):
            tr = r.trace if traced else None
            r0 = tr.clock() if tr is not None else 0.0
            # copy: out[i] would be a view pinning the whole padded bucket
            # (max_batch rows) for as long as the client keeps its result
            row = out[i].copy()
            if q.spec is not None:
                try:
                    row = q.spec.unravel(row)
                except Exception as e:      # pragma: no cover - spec bug
                    r.future.set_exception(e)
                    if tr is not None:
                        tr.finish(error=type(e).__name__)
                    continue
            r.future.set_result(row)
            if tr is not None:
                # "respond" covers unravel + future resolution, which runs
                # the frontend's done-callback (socket write) synchronously
                tr.add_span("respond", r0, tr.clock())
                tr.finish()

    def _execute_ragged(self, q: PlanQueue, live) -> None:
        """Run one mixed-n bucket through the family's ragged callable."""
        sched = self.sched
        k = len(live)
        bucket = bucket_size(k, sched.max_batch)
        n_pad = max(r.n for r in live)
        device = q.plan.device
        with sched.lock:
            gplan, gbackend, gkey = q.group.plan_for(n_pad, device)
        try:
            with _on_device(device):
                A = _to_device(pad_rows(np.stack(
                    [pad_cols(np.asarray(r.a), n_pad) for r in live]),
                    bucket), device)
                V = _to_device(pad_rows(np.stack(
                    [pad_cols(np.asarray(r.v), n_pad) for r in live]),
                    bucket), device)
                NE = _to_device(pad_rows(
                    np.asarray([r.n for r in live], np.int32), bucket),
                    device)
                t0 = time.perf_counter()
                exe = gplan.executable("batched_hvp_ragged")
                if obs.is_active():
                    with obs.annotate(
                            f"repro:batched_hvp_ragged:{gbackend}"
                            f":b{bucket}:n{n_pad}"):
                        out = _readback(exe(A, V, NE))
                else:
                    out = _readback(exe(A, V, NE))
                elapsed = time.perf_counter() - t0
        except Exception as e:
            for r in live:
                r.future.set_exception(e)
            _fail_traces(live, e)
            return
        registry.record_execution(gkey, gbackend, "batched_hvp_ragged",
                                  bucket=bucket, n_points=k,
                                  elapsed_s=elapsed,
                                  clients=self._client_rows(live))
        with sched.lock:
            sched.stats["dispatched"] += k
            sched.stats["batches"] += 1
            sched.stats["padded_rows"] += bucket - k
            sched.stats["buckets"][bucket] += 1
            sched.stats["ragged_batches"] += 1
            sched.stats["ragged_points"] += k
            # NOT counted into q.epoch_counts: the re-tune loop reasons
            # about the queue's dense callables, and ragged batches run
            # the group plan instead
        traced = obs.enabled()
        if traced:
            ns = [r.n for r in live]
            meta = {"bucket": bucket, "rows": k,
                    "padded_rows": bucket - k, "backend": gbackend,
                    "workload": "batched_hvp_ragged", "ragged": True,
                    "family": q.group.family.name, "n_pad": n_pad,
                    "pad_waste": round(
                        1.0 - sum(ns) / float(len(ns) * n_pad), 4)}
            _record_batch_spans(live, t0, t0 + elapsed, meta)
        for i, r in enumerate(live):
            tr = r.trace if traced else None
            r0 = tr.clock() if tr is not None else 0.0
            r.future.set_result(out[i, :r.n].copy())
            if tr is not None:
                tr.add_span("respond", r0, tr.clock())
                tr.finish()

    @staticmethod
    def _client_rows(live) -> Optional[dict]:
        """{client: row count} for telemetry, or None if all anonymous."""
        counts: dict = {}
        for r in live:
            if r.client is not None:
                counts[r.client] = counts.get(r.client, 0) + 1
        return counts or None
