"""Truncated-Newton (Newton-CG) minimizer driven by CHESSFAD HVPs.

Counterpart of ``repro.optim.newton_cg``.  Each Newton step solves
H p = -g by conjugate gradients, where every CG iteration is ONE HVP --
either

  engine="chessfad" : the paper's chunked hDual HVP, planned by the engine
                      with ``backend="auto"`` (f written against hmath);
  engine="fwdrev"   : ONE ``torch.func.linearize`` of ``grad(f)`` per
                      Newton step; the CG loop applies only the linear map
                      (not a registry backend: per-x linear maps cannot
                      live in a per-f cache);

or any registered engine backend name (e.g. "pytree_fwdrev",
"reference").  Registry paths share the engine's callable cache across
all outer iterations and across newton_cg calls with the same f/n/csize
signature.

The plan's workload is the single-point ``hvp``.  The hand-written
``cuda`` backend serves only ``batched_hvp``, so on the card ``auto``
resolves Newton-CG's HVP to a ``vmap_l*`` backend, as the reference's
resolves to vmap on the TPU.

Armijo backtracking line search; CG truncated at the Steihaug negative-
curvature test, so the step is a descent direction even for nonconvex f.
The CG loop is a Python loop with the reference's masks; its stopping
tests read host scalars (a few per iteration, at the few iterations it
runs).
"""

from __future__ import annotations

import warnings
from typing import Callable

import torch
from torch.func import grad, linearize

from repro_torch import engine as curvature_engine
from repro_torch.core.funclock import func_locked

__all__ = ["newton_cg"]


def _vdot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _cg(hvp_fn, g, max_iters: int, tol: float):
    """Solve H p = -g; returns p (truncated on negative curvature)."""
    b = -g
    p, r, d = torch.zeros_like(g), b, b
    rs = _vdot(b, b)
    k, done = 0, False
    while k < max_iters and not done:
        Hd = hvp_fn(d)
        dHd = _vdot(d, Hd)
        neg = dHd <= 1e-12 * _vdot(d, d)
        alpha = torch.where(neg, 0.0, rs / torch.where(neg, 1.0, dHd))
        p = p + alpha * d
        r = r - alpha * Hd
        rs_new = _vdot(r, r)
        conv = torch.sqrt(rs_new) < tol
        beta = rs_new / rs
        d = r + beta * d
        rs = rs_new
        k += 1
        done = bool(neg | conv)
    # fall back to steepest descent if CG made no progress (first direction
    # had negative curvature)
    return p if bool(_vdot(p, p) > 0) else b


@func_locked
def _linear_map(f, x):
    """The tangent map of grad(f) at x (one trace of the jvp).  The map is
    the traced graph of plain aten ops and enters no transform, so calling
    it takes no lock."""
    with warnings.catch_warnings():
        # make_fx's constant folding warns about its own get_attr nodes
        warnings.simplefilter("ignore", UserWarning)
        return linearize(grad(f), x)[1]


def newton_cg(f: Callable, x0, *, engine: str = "chessfad", csize: int = 4,
              max_outer: int = 50, cg_iters: int = 20, cg_tol: float = 1e-5,
              armijo_c: float = 1e-4, backtracks: int = 20,
              grad_tol: float = 1e-6, device="cuda"):
    """Minimize scalar f over a flat vector x on ``device`` (the card unless
    the caller asks for the CPU). Returns (x, info dict)."""
    x0 = torch.as_tensor(x0, device=device)

    grad_f = func_locked(grad(f))

    if engine == "fwdrev":
        def cg_solve(x, g, tol):
            return _cg(_linear_map(f, x), g, cg_iters, tol)
    else:
        # registry path: one engine plan per run; its callable cache
        # persists across outer iterations AND across newton_cg calls with
        # the same static signature
        backend = "auto" if engine == "chessfad" else engine
        if backend != "auto":
            try:
                curvature_engine.get_backend(backend)  # fail fast on typos
            except KeyError as e:
                raise ValueError(str(e)) from None
        if backend == "pytree_fwdrev":
            hvp_plan = curvature_engine.plan(f, None, backend=backend,
                                             device=x0.device)
        else:
            hvp_plan = curvature_engine.plan(f, x0.shape[-1], csize=csize,
                                             symmetric=True,
                                             backend=backend,
                                             device=x0.device)

        def cg_solve(x, g, tol):
            return _cg(lambda v: hvp_plan.hvp(x, v), g, cg_iters, tol)

    x = x0
    traj = []
    n_hvp = 0
    for it in range(max_outer):
        g = grad_f(x)
        gnorm = float(torch.linalg.norm(g))
        fx = float(f(x))
        traj.append({"iter": it, "f": fx, "gnorm": gnorm})
        if gnorm < grad_tol:
            break
        p = cg_solve(x, g, cg_tol * max(gnorm, 1.0))
        n_hvp += cg_iters  # upper bound (CG may truncate earlier)
        # Armijo backtracking
        t = 1.0
        slope = float(_vdot(g, p))
        if slope >= 0:          # safeguard: not a descent dir -> use -g
            p = -g
            slope = -float(_vdot(g, g))
        accepted = False
        for _ in range(backtracks):
            x_try = x + t * p
            if float(f(x_try)) <= fx + armijo_c * t * slope:
                accepted = True
                break
            t *= 0.5
        if not accepted:
            break
        x = x + t * p
    return x, {"trajectory": traj, "iterations": len(traj),
               "hvp_calls_upper_bound": n_hvp}
