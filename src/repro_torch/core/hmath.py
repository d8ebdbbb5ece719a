"""Math functions overloaded for HDual (the paper's sin/cos/exp/abs operators).

Every function accepts either an ``HDual`` or a plain tensor and dispatches
accordingly, so user functions written against ``hmath`` run unchanged on
values and on hDuals -- the analogue of the paper's templated
``f<hDual<csize>>`` instantiation.  Counterpart of ``repro.core.hmath``.

The constant linear maps (``matvec_const``, ``dot_const``) contract the
leading (variable) axis and broadcast over any trailing batch axes of the
value shape, which is how the batched schedules of ``core.api`` and the
plain kernel version evaluate many cells at once.
"""

from __future__ import annotations

import math as _m

import torch

from .hdual import HDual, _chunk, _val

__all__ = [
    "sin", "cos", "tan", "exp", "log", "sqrt", "tanh", "sigmoid", "abs",
    "where", "maximum", "minimum", "sum", "dot_const", "matvec_const",
    "square", "pow", "asin", "acos", "atan", "sinh", "cosh", "erf",
    "log1p", "expm1",
]


def _dispatch(u, g, dg, d2g):
    if isinstance(u, HDual):
        v = u.val
        return u.unary(g(v), dg(v), d2g(v))
    return g(u)


def sin(u):
    return _dispatch(u, torch.sin, torch.cos, lambda v: -torch.sin(v))


def cos(u):
    return _dispatch(u, torch.cos, lambda v: -torch.sin(v),
                     lambda v: -torch.cos(v))


def tan(u):
    def d(v):
        s = 1.0 / torch.cos(v)
        return s * s

    return _dispatch(u, torch.tan, d, lambda v: 2.0 * torch.tan(v) * d(v))


def exp(u):
    return _dispatch(u, torch.exp, torch.exp, torch.exp)


def log(u):
    return _dispatch(u, torch.log, lambda v: 1.0 / v, lambda v: -1.0 / (v * v))


def sqrt(u):
    def g(v):
        return torch.sqrt(v)

    return _dispatch(u, g, lambda v: 0.5 / g(v), lambda v: -0.25 / (v * g(v)))


def tanh(u):
    def dg(v):
        t = torch.tanh(v)
        return 1.0 - t * t

    return _dispatch(u, torch.tanh, dg,
                     lambda v: -2.0 * torch.tanh(v) * dg(v))


def sigmoid(u):
    def g(v):
        return 1.0 / (1.0 + torch.exp(-v))

    def dg(v):
        s = g(v)
        return s * (1.0 - s)

    def d2g(v):
        s = g(v)
        return s * (1.0 - s) * (1.0 - 2.0 * s)

    return _dispatch(u, g, dg, d2g)


def abs(u):  # noqa: A001 - mirrors the paper's abs overload
    if isinstance(u, HDual):
        s = torch.sign(u.val)
        # |u|' = sign(u) u' ; |u|'' = sign(u) u'' (a.e., matching the C++ lib)
        return HDual(torch.abs(u.val), s * u.di, _chunk(s) * u.dj,
                     _chunk(s) * u.dij)
    return torch.abs(u)


def asin(u):
    def dg(v):
        return 1.0 / torch.sqrt(1.0 - v * v)

    return _dispatch(u, torch.asin, dg, lambda v: v * dg(v) ** 3)


def acos(u):
    def dg(v):
        return -1.0 / torch.sqrt(1.0 - v * v)

    return _dispatch(u, torch.acos, dg,
                     lambda v: v * dg(v) / (1.0 - v * v))


def atan(u):
    def dg(v):
        return 1.0 / (1.0 + v * v)

    return _dispatch(u, torch.atan, dg, lambda v: -2.0 * v * dg(v) ** 2)


def sinh(u):
    return _dispatch(u, torch.sinh, torch.cosh, torch.sinh)


def cosh(u):
    return _dispatch(u, torch.cosh, torch.sinh, torch.cosh)


def erf(u):
    def dg(v):
        return (2.0 / _m.sqrt(_m.pi)) * torch.exp(-v * v)

    return _dispatch(u, torch.special.erf, dg, lambda v: -2.0 * v * dg(v))


def log1p(u):
    return _dispatch(u, torch.log1p, lambda v: 1.0 / (1.0 + v),
                     lambda v: -1.0 / ((1.0 + v) * (1.0 + v)))


def expm1(u):
    return _dispatch(u, torch.expm1, torch.exp, torch.exp)


def square(u):
    return u * u if isinstance(u, HDual) else torch.square(u)


def pow(u, p):  # noqa: A001
    return u ** p


def _as_like(x, ref):
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def where(c, a, b):
    """Branch select on the primal condition (paper's comparison overloads)."""
    if not (isinstance(a, HDual) or isinstance(b, HDual)):
        return torch.where(c, a, b)
    cs = a.csize if isinstance(a, HDual) else b.csize
    ref = _val(a) if isinstance(a, HDual) else _val(b)
    if not isinstance(a, HDual):
        a = HDual.constant(_as_like(a, ref).expand(_val(b).shape), cs)
    if not isinstance(b, HDual):
        b = HDual.constant(_as_like(b, ref).expand(_val(a).shape), cs)
    c = torch.as_tensor(c, device=ref.device)
    cc = _chunk(c) if c.dim() else c
    return HDual(torch.where(c, a.val, b.val), torch.where(c, a.di, b.di),
                 torch.where(cc, a.dj, b.dj), torch.where(cc, a.dij, b.dij))


def maximum(a, b):
    c = _val(a) >= _val(b)
    return where(c, a, b)


def minimum(a, b):
    c = _val(a) <= _val(b)
    return where(c, a, b)


def sum(u, axis=None):  # noqa: A001
    if isinstance(u, HDual):
        return u.sum(axis)
    return u.sum() if axis is None else u.sum(axis)


def _contract(A, x):
    """A (r, n) against the leading axis of x (n, ...) -> (r, ...), in
    x's dtype (a float32 constant meets float64 or bfloat16 sweeps)."""
    return torch.tensordot(A.to(x.dtype), x, dims=([1], [0]))


def matvec_const(A, u):
    """y = A @ u for a *constant* matrix A (r, n) and HDual vector u (n, ...).

    Linear maps act componentwise on all 2c+2 hDual slots -- the identity
    exploited by the fused hdual_linear kernel of the reference."""
    if not isinstance(u, HDual):
        return _contract(A, u)
    return HDual(_contract(A, u.val), _contract(A, u.di),
                 _contract(A, u.dj), _contract(A, u.dij))


def dot_const(u, w):
    """<u, w> for HDual vector u (n, ...) and constant vector w (n,)."""
    if not isinstance(u, HDual):
        return _contract(w[None], u)[0]
    wb = w.reshape(w.shape + (1,) * (u.val.dim() - 1))
    return (u * wb).sum(0)
