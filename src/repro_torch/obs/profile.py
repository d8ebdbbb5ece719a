"""Profiling hooks: torch.profiler capture sessions and trace annotations.

Third observability pillar; counterpart of ``repro.obs.profile``, which
captures with ``jax.profiler``.  Two pieces:

  * :func:`profile_session` -- ``with obs.profile_session(dir):``
    captures a ``torch.profiler`` trace of the enclosed block (host ops,
    and the card's kernels when CUDA is available) and writes it into
    ``dir`` as a Chrome trace (``chrome://tracing``, Perfetto).
  * :func:`annotate` -- named ``record_function`` ranges around plan
    executions, so the timeline shows *which* plan/bucket a kernel
    belongs to.  Dispatch guards with :func:`is_active` (a plain bool
    read) so the annotation object is never even constructed outside a
    capture session.

The session records every thread of the process where the installed
PyTorch offers it (``profile_all_threads``): the serving stack's
annotations run on its dispatch worker threads, not on the thread that
opened the session.  torch is imported lazily, and a profiler that fails
to start leaves the block running unprofiled rather than breaking
serving.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading

__all__ = ["profile_session", "annotate", "is_active", "TRACE_PREFIX"]

TRACE_PREFIX = "repro_torch_trace"

_active = False
_lock = threading.Lock()
_seq = itertools.count()


def is_active() -> bool:
    """True while a profile_session capture is running (plain bool read
    -- safe to check per-batch on the dispatch hot path)."""
    return _active


def _all_threads_config():
    """The profiler config that records every thread, or None where the
    installed PyTorch has no such option (then only the opening thread's
    host ops are recorded; the card's kernels are recorded either way)."""
    import torch
    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


@contextlib.contextmanager
def profile_session(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block and write it
    into ``log_dir`` as ``repro_torch_trace_<pid>_<k>.json``.

    Nested/concurrent sessions are rejected (one capture per process at a
    time, as in the reference).  Yields ``log_dir`` while capturing, or
    None if the profiler could not start (the block still runs)."""
    global _active
    import torch
    from torch.profiler import ProfilerActivity, profile

    with _lock:
        if _active:
            raise RuntimeError("a profile_session is already active")
        _active = True
    try:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities,
                       experimental_config=_all_threads_config())
        try:
            prof.start()
        except RuntimeError:
            prof = None
        try:
            yield str(log_dir) if prof is not None else None
        finally:
            if prof is not None:
                prof.stop()
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    str(log_dir),
                    f"{TRACE_PREFIX}_{os.getpid()}_{next(_seq)}.json"))
    finally:
        with _lock:
            _active = False


def annotate(name: str):
    """A ``torch.profiler.record_function`` range naming the enclosed work
    while a capture is active, a no-op context otherwise.  Callers on hot
    paths should gate construction on :func:`is_active` themselves; this
    fallback exists for call sites that don't."""
    if _active:
        import torch
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()
