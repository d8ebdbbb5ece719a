"""hDual: the CHESSFAD second-order forward-mode dual number, over tensors.

An ``HDual`` carries, for every program value ``u``:

  val : u                                  -- the primal value
  di  : du/dx_i                            -- tangent w.r.t. the Hessian *row*
  dj  : du/dx_{j..j+c-1}    (chunk axis)   -- first-order chunk tangents
  dij : d2u/dx_i dx_{j..j+c-1}             -- second-order chunk

Shapes: ``val`` and ``di`` share a shape ``S``; ``dj`` and ``dij`` have shape
``S + (csize,)``. Binary ops broadcast ``S`` like torch (the chunk axis is
always trailing and must agree).

Counterpart of ``repro.core.hdual``.  One convention differs: a seeded
point keeps the *variables first* -- ``seed_point`` returns value shape
``(n, *batch)`` -- so batched schedules write their batch axes out as
trailing axes of the value shape instead of relying on ``vmap``.  For a
single point (value shape ``(n,)``) the two packages agree exactly.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["HDual", "lift", "seed_point", "is_hdual"]


def _chunk(x):
    """Broadcast an ``S``-shaped tensor against the trailing chunk axis."""
    return x[..., None]


class HDual:
    """CHESSFAD hDual<csize> (paper §4) with tensor components."""

    __slots__ = ("val", "di", "dj", "dij")
    # numpy defers to our reflected operators (ndarray + HDual -> __radd__)
    __array_ufunc__ = None

    def __init__(self, val, di, dj, dij):
        self.val = val
        self.di = di
        self.dj = dj
        self.dij = dij

    # -- metadata ----------------------------------------------------------
    @property
    def csize(self) -> int:
        return self.dj.shape[-1]

    @property
    def shape(self):
        return tuple(self.val.shape)

    @property
    def dtype(self):
        return self.val.dtype

    def __repr__(self):
        return (f"HDual(val={self.val!r}, di={self.di!r}, dj={self.dj!r}, "
                f"dij={self.dij!r})")

    # -- constructors --------------------------------------------------------
    @classmethod
    def constant(cls, x, csize, dtype=None):
        x = torch.as_tensor(x, dtype=dtype)
        z = torch.zeros_like(x)
        zc = x.new_zeros(x.shape + (csize,))
        return cls(x, z, zc, zc)

    # -- arithmetic ----------------------------------------------------------
    def _coerce(self, other):
        """Return ``other`` as HDual, as a constant tensor, or NotImplemented."""
        if isinstance(other, HDual):
            return other
        if isinstance(other, (int, float)):
            return other
        if isinstance(other, (torch.Tensor, np.ndarray, np.number)):
            return torch.as_tensor(other, dtype=self.val.dtype,
                                   device=self.val.device)
        return NotImplemented

    def __add__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        if not isinstance(o, HDual):  # constant: only the value moves
            return HDual(self.val + o, self.di, self.dj, self.dij)
        return HDual(self.val + o.val, self.di + o.di, self.dj + o.dj,
                     self.dij + o.dij)

    __radd__ = __add__

    def __neg__(self):
        return HDual(-self.val, -self.di, -self.dj, -self.dij)

    def __sub__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        if not isinstance(o, HDual):
            return HDual(self.val - o, self.di, self.dj, self.dij)
        return HDual(self.val - o.val, self.di - o.di, self.dj - o.dj,
                     self.dij - o.dij)

    def __rsub__(self, other):
        return (-self).__add__(other)

    def __mul__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        if not isinstance(o, HDual):  # constant scale: all 2c+2 components
            oc = _chunk(o) if isinstance(o, torch.Tensor) else o
            return HDual(self.val * o, self.di * o, self.dj * oc,
                         self.dij * oc)
        u, v = self, o
        # Leibniz to second order (paper §3.1):
        #   (uv)_ij = u v_ij + u_i v_j + v_i u_j + v u_ij
        val = u.val * v.val
        di = u.val * v.di + v.val * u.di
        dj = _chunk(u.val) * v.dj + _chunk(v.val) * u.dj
        dij = (_chunk(u.val) * v.dij + _chunk(u.di) * v.dj
               + _chunk(v.di) * u.dj + _chunk(v.val) * u.dij)
        return HDual(val, di, dj, dij)

    __rmul__ = __mul__

    def _reciprocal(self):
        # g(v)=1/v, g'=-1/v^2, g''=2/v^3
        inv = 1.0 / self.val
        return self.unary(inv, -inv * inv, 2.0 * inv * inv * inv)

    def __truediv__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        if not isinstance(o, HDual):
            return self * (1.0 / o)
        return self * o._reciprocal()

    def __rtruediv__(self, other):
        return self._reciprocal() * other

    def __pow__(self, p):
        if isinstance(p, HDual):
            raise NotImplementedError(
                "HDual**HDual: use hmath.exp(p*hmath.log(u))")
        if isinstance(p, int) and p >= 0:
            # Exact integer powers via repeated squaring keep the polynomial
            # test functions bitwise-stable (same recipe as the reference).
            if p == 0:
                return HDual.constant(torch.ones_like(self.val), self.csize)
            result = None
            base = self
            e = p
            while e:
                if e & 1:
                    result = base if result is None else result * base
                e >>= 1
                if e:
                    base = base * base
            return result
        v = self.val
        g = v ** p
        dg = p * v ** (p - 1)
        d2g = p * (p - 1) * v ** (p - 2)
        return self.unary(g, dg, d2g)

    def unary(self, g, dg, d2g):
        """Chain rule for g(u) (paper §3.1 sin-rule generalized):

          g_i  = g'(u) u_i
          g_ij = g'(u) u_ij + g''(u) u_i u_j
        """
        return HDual(
            g,
            dg * self.di,
            _chunk(dg) * self.dj,
            _chunk(dg) * self.dij + _chunk(d2g * self.di) * self.dj,
        )

    # -- comparisons (on the primal value, like the paper's overloads) -------
    def __lt__(self, other):
        return self.val < _val(other)

    def __le__(self, other):
        return self.val <= _val(other)

    def __gt__(self, other):
        return self.val > _val(other)

    def __ge__(self, other):
        return self.val >= _val(other)

    # -- structural ops ------------------------------------------------------
    def __getitem__(self, idx):
        # Index applies to the value shape S; the chunk axis is trailing and
        # untouched. Only basic (int/slice/tuple-of-those) indexing.
        return HDual(self.val[idx], self.di[idx], self.dj[idx], self.dij[idx])

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return HDual(self.val.reshape(shape), self.di.reshape(shape),
                     self.dj.reshape(shape + (self.csize,)),
                     self.dij.reshape(shape + (self.csize,)))

    def sum(self, axis=None):
        ax = _norm_axis(axis, self.val.dim())
        if not ax:
            return self
        return HDual(self.val.sum(ax), self.di.sum(ax), self.dj.sum(ax),
                     self.dij.sum(ax))

    def astype(self, dtype):
        return HDual(self.val.to(dtype), self.di.to(dtype),
                     self.dj.to(dtype), self.dij.to(dtype))


def _val(x):
    return x.val if isinstance(x, HDual) else x


def _norm_axis(axis, ndim):
    """Normalize value-shape axes so they never touch the trailing chunk axis."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, int):
        axis = (axis,)
    return tuple(a % ndim for a in axis)


def is_hdual(x) -> bool:
    return isinstance(x, HDual)


def lift(x, csize, dtype=None) -> HDual:
    """Lift a constant tensor into an HDual with zero derivatives."""
    return HDual.constant(x, csize, dtype)


def seed_point(a, i, cstart, csize) -> HDual:
    """CHUNK-INIT (paper Alg. 4): seed the n input variables.

    a      : (n, *S) evaluation point(s), variables first
    i      : Hessian row index: an int, or an integer tensor broadcastable
             against ``S`` (one row per batch element)
    cstart : chunk start column, int or integer tensor like ``i``

    Returns the HDual vector y of value shape (n, *B), ``B`` the broadcast of
    ``S`` with the shapes of ``i`` and ``cstart``, with
      y.di[k, b]    = [k == i[b]]
      y.dj[k, b, l] = [k == cstart[b] + l]
    """
    a = torch.as_tensor(a)
    n = a.shape[0]
    dt, dev = a.dtype, a.device
    i = torch.as_tensor(i, device=dev)
    cstart = torch.as_tensor(cstart, device=dev)
    bshape = torch.broadcast_shapes(a.shape[1:], i.shape, cstart.shape)
    k = torch.arange(n, device=dev).reshape((n,) + (1,) * len(bshape))
    di = (k == i).to(dt)
    cols = cstart[..., None] + torch.arange(csize, device=dev)
    dj = (k[..., None] == cols).to(dt)
    shape = (n,) + tuple(bshape)
    # right-align S against B, as broadcasting does
    val = a.reshape((n,) + (1,) * (len(bshape) - (a.dim() - 1))
                    + tuple(a.shape[1:]))
    return HDual(val.expand(shape), di.expand(shape),
                 dj.expand(shape + (csize,)),
                 a.new_zeros(shape + (csize,)))
