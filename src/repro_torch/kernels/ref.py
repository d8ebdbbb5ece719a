"""Oracles for the kernels (tests hold the kernels and their plain versions
against them).  Counterpart of ``repro.kernels.ref``.

``chess_hvp_ref`` always takes the KERNEL FORM ``kf(y, *consts)`` with its
constants, the way the kernel itself receives f.  It runs the L1 schedule
of ``core.api`` (rows batched, chunks swept one at a time, full chunk grid),
a different code path from the L2 scatter that ``chess_hvp_plain`` shares
with the ``vmap_l2`` backend.

``hdual_linear_ref`` is one einsum over all hDual components in x's type,
as the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.core.api import batched_hvp_impl

__all__ = ["chess_hvp_ref", "hdual_linear_ref"]


def chess_hvp_ref(kf, A, V, csize: int, consts=()):
    fn = (lambda y: kf(y, *consts)) if consts else kf
    return batched_hvp_impl(fn, A, V, csize, level="L1", symmetric=False)


def hdual_linear_ref(x, w):
    """x (K2, T, din), w (din, dout) -> (K2, T, dout)."""
    return torch.einsum("ktd,df->ktf", x, w.to(x.dtype)).to(x.dtype)
