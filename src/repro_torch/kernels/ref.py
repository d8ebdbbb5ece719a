"""Oracle for the chess_hvp kernel (tests hold the kernel and its plain
version against it).  Counterpart of ``repro.kernels.ref``.

``chess_hvp_ref`` always takes the KERNEL FORM ``kf(y, *consts)`` with its
constants, the way the kernel itself receives f.  It runs the L1 schedule
of ``core.api`` (rows batched, chunks swept one at a time, full chunk grid),
a different code path from the L2 scatter that ``chess_hvp_plain`` shares
with the ``vmap_l2`` backend.
"""

from __future__ import annotations

from repro_torch.core.api import batched_hvp_impl

__all__ = ["chess_hvp_ref"]


def chess_hvp_ref(kf, A, V, csize: int, consts=()):
    fn = (lambda y: kf(y, *consts)) if consts else kf
    return batched_hvp_impl(fn, A, V, csize, level="L1", symmetric=False)
