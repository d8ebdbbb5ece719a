"""torch.func oracles for validating the CHESSFAD engine.

Counterpart of ``repro.core.ref``; the paper's comparison baselines (§1.1/§7)
mapped to torch.func transforms:

  autodiff (forward-mode)   -> jacfwd(jacfwd(f))           hessian_fwdfwd
  HAD (reverse-mode)        -> jacrev(jacrev(f))           hessian_rev
  mixed-mode oracle         -> hessian = jacfwd(jacrev(f)) hessian_fwdrev
  HVP idiom                 -> jvp(grad(f)) (fwd-over-rev) hvp_fwdrev
  pure-forward HVP          -> jvp of jacfwd               hvp_fwdfwd

``f`` maps a flat (n,) tensor to a scalar tensor.
"""

from __future__ import annotations

from torch import func

from .funclock import func_locked

__all__ = ["hessian_rev", "hessian_fwdfwd", "hvp_fwdrev", "hvp_fwdfwd",
           "hessian_fwdrev"]


@func_locked
def hessian_rev(f, a):
    """Reverse-over-reverse (the HAD analogue)."""
    return func.jacrev(func.jacrev(f))(a)


@func_locked
def hessian_fwdfwd(f, a):
    """Forward-over-forward (the autodiff analogue; n^2 tangent work)."""
    return func.jacfwd(func.jacfwd(f))(a)


@func_locked
def hessian_fwdrev(f, a):
    """torch.func.hessian = jacfwd(jacrev): the standard mixed-mode oracle."""
    return func.hessian(f)(a)


@func_locked
def hvp_fwdrev(f, a, v):
    """Forward-over-reverse HVP: one grad, one jvp -- O(1) evaluations."""
    return func.jvp(func.grad(f), (a,), (v,))[1]


@func_locked
def hvp_fwdfwd(f, a, v):
    """Pure-forward HVP: jvp of a jacfwd (no reverse sweep)."""
    return func.jvp(func.jacfwd(f), (a,), (v,))[1]
