"""The process-wide lock around ``torch.func`` transforms.

Forward-AD levels are process-wide in PyTorch: while one thread is inside a
``torch.func`` transform (a ``jvp``, or a ``grad`` under one), a transform
entered on another thread can invalidate its level, and one of the two
raises ``RuntimeError: Trying to access a forward AD level with an invalid
index``.  JAX's transforms share no such state, so the reference needs no
lock.  Every callable of the port that enters a transform holds
``FUNC_LOCK`` for the span of the transform: the ``reference`` backend and
the ragged ``batched_hvp_ragged`` path, ``core.ref``, ``core.curvature``
and its pytree backends, SophiaH's Hutchinson estimate, Newton-CG's
gradient and linearization, and the train step's ``grad_and_value``.  The
hDual schedules (``vmap_l*``) and the ``cuda`` kernel run no transform and
take no lock, so the service's kernel buckets stay concurrent.

User code that runs its own ``torch.func`` transforms while a
``CurvatureService`` runs takes the same lock::

    from repro_torch.core.funclock import FUNC_LOCK

    with FUNC_LOCK:
        hv = torch.func.jvp(torch.func.grad(f), (x,), (v,))[1]

The lock is re-entrant.  Never wait on a service future while holding it:
the dispatch worker needs it to finish a transform bucket.

``transform_levels(kind)`` counts the ``torch.func`` transforms of one kind
active around the caller; the models' remat (``models/transformer.py``)
reads it to decide whether its backward records a graph.
"""

from __future__ import annotations

import functools
import threading

__all__ = ["FUNC_LOCK", "func_locked", "transform_levels"]

FUNC_LOCK = threading.RLock()


def func_locked(fn):
    """``fn`` run under ``FUNC_LOCK``."""
    @functools.wraps(fn)
    def locked(*args, **kwargs):
        with FUNC_LOCK:
            return fn(*args, **kwargs)
    return locked


def transform_levels(kind: str) -> int:
    """The ``torch.func`` transforms of ``kind`` active around the caller:
    ``"grad"`` (``grad``, ``vjp``), ``"jvp"`` or ``"vmap"``.

    torch has no public query of its transform stack, so this reads the
    interpreter stack of ``torch._functorch`` (checked on torch 2.11 and
    2.13); it raises, rather than guessing, if a torch release moved it."""
    try:
        from torch._C._functorch import TransformType
        from torch._functorch.pyfunctorch import \
            retrieve_all_functorch_interpreters
    except ImportError as e:
        raise RuntimeError(
            "this torch release moved its functorch interpreter stack; "
            "transform_levels needs a new reading of it") from e
    want = {"grad": TransformType.Grad, "jvp": TransformType.Jvp,
            "vmap": TransformType.Vmap}[kind]
    return sum(i.key() == want for i in retrieve_all_functorch_interpreters())
