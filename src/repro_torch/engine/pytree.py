"""Pytree <-> flat-vector marshalling for the serving layer.

Counterpart of ``repro.engine.pytree``, over ``torch.utils._pytree``.  The
CurvatureService coalesces requests by stacking them into one (k, n) host
array per bucket; parameter pytrees don't stack.  ``PytreeSpec`` is the
bridge: a HASHABLE summary of a tree's static structure (treedef + leaf
shapes + leaf dtypes) plus the ravel/unravel maps between that tree and a
flat ``(size,)`` vector.

Hashability is the point -- the spec rides in ``plan.options``, so a
pytree request lands in the ordinary callable cache and telemetry
machinery keyed on the plan signature: two requests with the same treedef
share one batched callable and one service queue; a different treedef is
a different signature and therefore a different queue.

The host side (``ravel``/``unravel``) is numpy: the scheduler ravels each
request to one host row.  The device side (``ravel_tensor``/
``unravel_tensor``, the counterpart of the reference's traced
``ravel_traced``/``unravel``) is what the pytree backends' ``batched_*``
callables run on a bucket's stacked rows: a row unravels to a tree of
fresh tensors on the plan's device, and a result tree ravels into one row
of the output.

Leaves may be numpy arrays, tensors or Python scalars; dtypes are kept as
names (a tensor's ``torch.float32`` is recorded as ``float32``).  The host
side stays numpy through ``repro_torch.hostarray``: a row is raveled in the
host dtype of the torch-promoted leaf dtype (float32 for bfloat16), and a
bfloat16 leaf unravels to a CPU bfloat16 tensor.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.hostarray import (dtype_name, from_host, host_dtype,
                                   to_host, torch_dtype)

__all__ = ["PytreeSpec", "spec_of"]


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return dtype_name(leaf.dtype)
    return dtype_name(np.asarray(leaf).dtype)


@dataclass(frozen=True)
class PytreeSpec:
    """Static structure of one parameter pytree: the coalescing key.

    treedef : torch.utils._pytree TreeSpec (hashable)
    shapes  : tuple of leaf shapes, in treedef leaf order
    dtypes  : tuple of leaf dtype names, same order
    """

    treedef: Any
    shapes: tuple
    dtypes: tuple

    @property
    def size(self) -> int:
        """Total flat length (the plan-level ``n`` of the raveled problem)."""
        return sum(int(np.prod(s)) if s else 1 for s in self.shapes)

    @property
    def ravel_dtype(self) -> np.dtype:
        """Host (numpy) dtype of the raveled vector: the one that holds
        ``torch_ravel_dtype`` exactly."""
        return host_dtype(self.torch_ravel_dtype)

    def _offsets(self):
        off = 0
        for shape, dtype in zip(self.shapes, self.dtypes):
            n = int(np.prod(shape)) if shape else 1
            yield off, n, shape, dtype
            off += n

    def check(self, tree) -> list:
        """Leaves of ``tree`` in treedef order, or ValueError on mismatch."""
        leaves, treedef = pytree.tree_flatten(tree)
        if treedef != self.treedef:
            raise ValueError(
                f"pytree structure mismatch: expected {self.treedef}, "
                f"got {treedef}")
        for leaf, shape in zip(leaves, self.shapes):
            if tuple(np.shape(leaf)) != tuple(shape):
                raise ValueError(
                    f"pytree leaf shape mismatch: expected {shape}, got "
                    f"{tuple(np.shape(leaf))}")
        return leaves

    # -- host side (service marshalling) ------------------------------------
    def ravel(self, tree) -> np.ndarray:
        """tree -> (size,) host numpy vector (the service ships ONE stacked
        array per bucket)."""
        leaves = self.check(tree)
        if not leaves:
            return np.zeros((0,), self.ravel_dtype)
        return np.concatenate(
            [to_host(l)[0].ravel().astype(self.ravel_dtype, copy=False)
             for l in leaves])

    def unravel(self, vec: np.ndarray):
        """(size,) host vector -> tree of leaves (static offsets): numpy
        arrays, or CPU tensors for dtypes numpy cannot hold (bfloat16)."""
        leaves = [from_host(vec[o:o + n].reshape(shape), dtype)
                  for o, n, shape, dtype in self._offsets()]
        return pytree.tree_unflatten(leaves, self.treedef)

    # -- device side (inside the batched callables) -------------------------
    @property
    def torch_ravel_dtype(self) -> torch.dtype:
        """Common dtype of the raveled vector (torch promotion rules)."""
        if not self.dtypes:
            return torch.float32
        return functools.reduce(torch.promote_types,
                                map(torch_dtype, self.dtypes))

    def ravel_tensor(self, tree, out=None) -> torch.Tensor:
        """tree of tensors -> (size,) tensor on their device (into ``out``,
        a (size,) tensor, when given)."""
        leaves = self.check(tree)
        dt = self.torch_ravel_dtype
        flat = [l.reshape(-1).to(dt) for l in leaves]
        if out is not None:
            return torch.cat(flat, out=out)
        return torch.cat(flat)

    def unravel_tensor(self, vec: torch.Tensor, device=None):
        """(size,) tensor -> tree of FRESH tensors on ``device`` (default:
        vec's), one copy per leaf (static offsets).  Not views of ``vec``:
        forward-mode AD gives a view primal a tangent as large as its whole
        base, so the leaves of a raveled row, as views, would each cost a
        row-sized tangent under ``torch.func.jvp``."""
        device = vec.device if device is None else torch.device(device)
        leaves = [vec[o:o + n].reshape(shape).to(
                      device=device, dtype=getattr(torch, dtype), copy=True)
                  for o, n, shape, dtype in self._offsets()]
        return pytree.tree_unflatten(leaves, self.treedef)


def spec_of(tree) -> PytreeSpec:
    """The PytreeSpec of a concrete parameter tree."""
    leaves, treedef = pytree.tree_flatten(tree)
    return PytreeSpec(
        treedef=treedef,
        shapes=tuple(tuple(np.shape(l)) for l in leaves),
        dtypes=tuple(_dtype_name(l) for l in leaves))
