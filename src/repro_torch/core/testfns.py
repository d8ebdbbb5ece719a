"""The paper's evaluation functions (§7): Rosenbrock, Ackley, Fletcher-Powell.

Each is written once against ``repro_torch.core.hmath`` and therefore runs on
plain tensors *and* on HDuals.  Counterpart of ``repro.core.testfns``.

Every function broadcasts over trailing batch axes of its input's value
shape (variables first), and carries the attributes the kernel backend
reads (``kernels.ops.kernel_form``):

  kernel_fn     : the plain kernel form ``kf(y, *consts)`` (the reference's
                  ``pallas_fn``); absent means ``f`` itself
  kernel_consts : constant coefficient tensors passed to ``kernel_fn``
                  (the reference's ``pallas_consts``)
  device_fn     : the name of the function's CUDA device form in
                  ``kernels/csrc/chess_hvp.cu``; absent means the CUDA
                  kernel cannot evaluate ``f``
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import hmath as hm
from .hdual import HDual, _val

__all__ = ["rosenbrock", "ackley", "fletcher_powell", "make_fletcher_powell",
           "FUNCTIONS", "sample_point", "rosenbrock_masked", "ackley_masked",
           "ragged_family"]


def rosenbrock(x):
    """sum_{k<n-1} 100 (x_{k+1} - x_k^2)^2 + (1 - x_k)^2."""
    xk = x[:-1]
    xk1 = x[1:]
    t1 = xk1 - xk * xk
    t2 = 1.0 - xk
    return (t1 * t1 * 100.0 + t2 * t2).sum(0)


def ackley(x):
    """-20 exp(-0.2 sqrt(mean x^2)) - exp(mean cos(2 pi x)) + 20 + e."""
    n = x.shape[0]
    s1 = (x * x).sum(0) * (1.0 / n)
    s2 = hm.cos(x * (2.0 * math.pi)).sum(0) * (1.0 / n)
    return (hm.exp(hm.sqrt(s1) * -0.2) * -20.0) - hm.exp(s2) + (20.0 + math.e)


rosenbrock.device_fn = "rosenbrock"
ackley.device_fn = "ackley"


# -- masked family forms (cross-n ragged serving) ----------------------------
#
# ``<f>_masked(x_pad, n_eff)`` equals ``<f>(x_pad[:n_eff])`` for any
# ``n_eff <= len(x_pad)``, a tensor under ``torch.func.vmap``: every term
# past the effective prefix is multiplied by an exact 0/1 mask, so the
# gradient and Hessian entries outside the prefix are exactly zero and a
# padded HVP row sliced back to ``n_eff`` entries is the exact per-n answer.
# Written on plain tensors (not hmath), as the reference writes them with
# jnp: the ``batched_hvp_ragged`` callable differentiates them with
# torch.func's jvp-of-grad, not the HDual sweeps.

def rosenbrock_masked(x, n_eff):
    """Rosenbrock on the first ``n_eff`` coordinates of a padded vector:
    term k contributes iff k < n_eff - 1 (the per-n sum runs over pairs
    (x_k, x_{k+1}) inside the prefix)."""
    keep = (torch.arange(x.shape[0] - 1, device=x.device)
            < n_eff - 1).to(x.dtype)
    xk = x[:-1]
    xk1 = x[1:]
    t1 = xk1 - xk * xk
    t2 = 1.0 - xk
    return (keep * (t1 * t1 * 100.0 + t2 * t2)).sum(0)


def ackley_masked(x, n_eff):
    """Ackley on the first ``n_eff`` coordinates: both means are masked
    sums divided by the EFFECTIVE length (not the padded one)."""
    keep = (torch.arange(x.shape[0], device=x.device) < n_eff).to(x.dtype)
    ne = torch.as_tensor(n_eff, device=x.device).to(x.dtype)
    s1 = (keep * x * x).sum(0) / ne
    s2 = (keep * torch.cos(x * (2.0 * math.pi))).sum(0) / ne
    return (torch.exp(torch.sqrt(s1) * -0.2) * -20.0) - torch.exp(s2) \
        + (20.0 + math.e)


_RAGGED_FAMILIES: dict = {}


def ragged_family(name: str):
    """The shape-polymorphic ``RaggedFamily`` for a paper test function.

    Plans built on the returned family (``engine.plan(ragged_family(
    "rosenbrock"), n, ...)``) opt into the serving scheduler's cross-n
    ragged coalescing.  Cached per name so independent clients get the
    SAME family object.  Fletcher-Powell has per-n coefficient matrices
    (not one function at every n), so it has no family."""
    if name not in _RAGGED_FAMILIES:
        from repro_torch.engine.plan import RaggedFamily
        if name == "rosenbrock":
            fam = RaggedFamily("rosenbrock", rosenbrock, rosenbrock_masked)
        elif name == "ackley":
            fam = RaggedFamily("ackley", ackley, ackley_masked)
        else:
            raise ValueError(
                f"no ragged family for {name!r}: only the shape-polymorphic "
                f"test functions (rosenbrock, ackley) serve every n with "
                f"one function")
        _RAGGED_FAMILIES[name] = fam
    return _RAGGED_FAMILIES[name]

_FP_CACHE: dict = {}


def _fp_coeffs(n: int, seed: int = 1963):
    """Fletcher & Powell (1963) trigonometric test function coefficients:
    integer a,b in [-100,100], alpha in [-pi,pi]. Deterministic per n, and
    bit-identical to ``repro.core.testfns._fp_coeffs`` (same recipe)."""
    key = (n, seed)
    if key not in _FP_CACHE:
        rng = np.random.RandomState(seed + n)
        A = rng.randint(-100, 101, size=(n, n)).astype(np.float32)
        B = rng.randint(-100, 101, size=(n, n)).astype(np.float32)
        alpha = rng.uniform(-np.pi, np.pi, size=(n,)).astype(np.float32)
        E = (A @ np.sin(alpha) + B @ np.cos(alpha)).astype(np.float32)
        _FP_CACHE[key] = (A, B, E)
    return _FP_CACHE[key]


def _fp_kernel(y, A, B, E):
    s = hm.matvec_const(A, hm.sin(y))
    c = hm.matvec_const(B, hm.cos(y))
    # E broadcasts over any trailing batch axes of the value shape
    Eb = E.reshape(E.shape + (1,) * (_val(s).dim() - 1))
    r = (s + c) - Eb
    return (r * r).sum(0)


def build_fletcher_powell(A, B, E, device="cpu"):
    """The Fletcher-Powell function for the coefficients (A, B, E), given as
    numpy arrays: plain form, kernel form and device form.  The coefficient
    tensors live on ``device``; a call on another device copies them for
    that call.  (No copy is cached: a tensor made inside a torch.func
    transform must not outlive it.)"""
    device = torch.device(device)
    consts = tuple(torch.as_tensor(np.asarray(x, np.float32), device=device)
                   for x in (A, B, E))

    def fletcher_powell(x):
        dev = _val(x).device
        if dev == device:
            return _fp_kernel(x, *consts)
        return _fp_kernel(x, *(c.to(dev) for c in consts))

    fletcher_powell.kernel_fn = _fp_kernel
    fletcher_powell.kernel_consts = consts
    fletcher_powell.device_fn = "fletcher_powell"
    return fletcher_powell


_FP_FN_CACHE: dict = {}


def make_fletcher_powell(n: int, seed: int = 1963, device="cpu"):
    """Fletcher-Powell at n, its constants on ``device``."""
    # cache the closure: stable function identity keeps the engine's
    # executable cache hot across repeated make_fletcher_powell(n) calls
    key = (n, seed, torch.device(device))
    if key not in _FP_FN_CACHE:
        _FP_FN_CACHE[key] = build_fletcher_powell(*_fp_coeffs(n, seed),
                                                  device=device)
    return _FP_FN_CACHE[key]


def fletcher_powell(x):
    """Convenience entry using the shape of x to pick coefficients."""
    n = x.shape[0] if not isinstance(x, HDual) else x.val.shape[0]
    return make_fletcher_powell(int(n))(x)


FUNCTIONS = {
    "rosenbrock": lambda n: rosenbrock,
    "ackley": lambda n: ackley,
    "fletcher_powell": make_fletcher_powell,
}


def sample_point(n: int, seed: int = 0, dtype=torch.float32, device="cpu"):
    rng = np.random.RandomState(seed)
    return torch.as_tensor(rng.uniform(-2.0, 2.0, size=(n,)), dtype=dtype,
                           device=device)
