"""Carry state from the JAX package's world into the port.

This system has no model weights: its state is the test functions'
constant coefficients and the evaluation data, both plain numpy arrays on
the JAX side (``repro.core.testfns._fp_coeffs`` returns numpy; evaluation
points are numpy before ``jnp.asarray``).  This module takes those arrays,
never the JAX package itself.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hdual import HDual
from repro_torch.core.testfns import build_fletcher_powell

__all__ = ["fletcher_powell_from_numpy", "hdual_from_numpy", "to_torch"]


def fletcher_powell_from_numpy(A, B, E, device="cpu"):
    """The port's Fletcher-Powell (plain, kernel and device forms) for the
    coefficient arrays A (n, n), B (n, n), E (n,), with its constants on
    ``device``."""
    A, B, E = (np.asarray(x, np.float32) for x in (A, B, E))
    n = E.shape[0]
    if A.shape != (n, n) or B.shape != (n, n) or E.shape != (n,):
        raise ValueError(f"Fletcher-Powell coefficients must be (n, n), "
                         f"(n, n), (n,); got {A.shape}, {B.shape}, {E.shape}")
    return build_fletcher_powell(A, B, E, device=device)


def to_torch(x, device="cpu"):
    """An A or V batch (numpy, or anything ``np.asarray`` takes) as a
    contiguous tensor of the same dtype on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


def hdual_from_numpy(val, di, dj, dij, device="cpu"):
    """The port's ``HDual`` for the components of a JAX-package HDual as
    numpy: val and di of one shape S, dj and dij of shape S + (csize,)."""
    val, di, dj, dij = (np.asarray(x) for x in (val, di, dj, dij))
    if (di.shape != val.shape or dj.shape[:-1] != val.shape
            or dij.shape != dj.shape or dj.ndim != val.ndim + 1):
        raise ValueError(f"HDual components must be S, S, S+(c,), S+(c,); "
                         f"got {val.shape}, {di.shape}, {dj.shape}, "
                         f"{dij.shape}")
    return HDual(*(to_torch(x, device) for x in (val, di, dj, dij)))
