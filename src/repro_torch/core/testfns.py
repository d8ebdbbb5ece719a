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
           "FUNCTIONS", "sample_point"]


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


def make_fletcher_powell(n: int, seed: int = 1963):
    # cache the closure: stable function identity keeps the engine's
    # executable cache hot across repeated make_fletcher_powell(n) calls
    key = (n, seed)
    if key not in _FP_FN_CACHE:
        _FP_FN_CACHE[key] = build_fletcher_powell(*_fp_coeffs(n, seed))
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
