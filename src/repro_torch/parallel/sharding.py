"""Logical-axis sharding rules (MaxText-style) for the production mesh.

Counterpart of ``repro.parallel.sharding``.  Every parameter/activation
declares *logical* axes (("embed","ffn"), ...); a rule table maps each
logical axis to an ordered list of candidate mesh axes. ``spec_for``
greedily assigns, per tensor, the first candidate mesh axis that (a) exists
in the mesh, (b) divides the dimension, and (c) is not already used by
another dimension of the same tensor. Indivisible dims fall back to
replication instead of erroring -- e.g. granite-3b's 40 experts on a
16-wide ``model`` axis.

Two rule tables are exposed:

  PARAM_RULES      -- 2D-sharded weights: TP dims over ``model``, the
                      complementary dim over ``data`` (FSDP/ZeRO-ish).
  ACTIVATION_RULES -- batch over (pod, data); heads/ffn/vocab over model.

A mesh is a named ``torch.distributed`` DeviceMesh, or a plain ordered
``{axis name: size}`` dict: the rules can be asked about the production
16x16 and 2x16x16 layouts without a world of 256 ranks.  A spec is a tuple
with one entry per tensor dim: None (replicated), an axis name, or a tuple
of axis names (sharded over their product, the first axis major), the
counterpart of a ``PartitionSpec``.  ``logical_to_sharding`` pairs it with
a DeviceMesh in a ``NamedSharding``, which converts to DTensor placements
and cuts a rank's block out of a global tensor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

__all__ = [
    "PARAM_RULES", "ACTIVATION_RULES", "spec_for", "logical_to_sharding",
    "mesh_axis_size", "data_axes", "batch_spec", "constrain",
    "NamedSharding", "block_slices", "gather", "shard_like",
]

# Ordered candidates per logical axis. Tuples inside the candidate list mean
# "shard over the product of these axes" (e.g. batch over pod x data).
PARAM_RULES: dict[str, list] = {
    # tensor-parallel (Megatron) dims
    "vocab":     ["model"],
    "heads":     ["model"],
    "kv_heads":  ["model"],
    "ffn":       ["model"],
    "experts":   ["model"],
    "ssm_heads": ["model"],
    # FSDP dim: the "other" dim of each matrix spreads over the DP axes
    "embed":     ["data"],
    "embed_tp":  ["model"],   # when embed is the TP output dim (attn out, mlp down)
    "expert_ffn": ["model"],
    # never sharded
    "layers": [], "head_dim": [], "conv": [], "ssm_state": [], "frame": [],
    "pos": [], "window": [], "qk": [],
}

ACTIVATION_RULES: dict[str, list] = {
    "batch":     [("pod", "data"), "data"],
    "seq":      [],
    "kv_seq":   ["model"],   # decode cache seq sharding (flash-decoding)
    "embed":    [],
    "heads":    ["model"],
    "kv_heads": ["model"],
    "ffn":      ["model"],
    "vocab":    ["model"],
    "experts":  ["model"],
    "ssm_heads": ["model"],
    "capacity": ["data"],
    "head_dim": [], "ssm_state": [], "layers": [], "pos": [],
}


def _sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or of a plain dict, in mesh
    order."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axis_size(mesh, axis) -> int:
    sizes = _sizes(mesh)
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _axis_in_mesh(mesh, axis) -> bool:
    names = _sizes(mesh)
    if isinstance(axis, tuple):
        return all(a in names for a in axis)
    return axis in names


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]],
             mesh, rules: dict[str, list]) -> tuple:
    """Greedy logical->physical assignment with divisibility fallback."""
    assert len(shape) == len(logical), (shape, logical)
    used: set[str] = set()
    out = []
    for dim, name in zip(shape, logical):
        assigned = None
        if name is not None:
            for cand in rules.get(name, []):
                cand_axes = cand if isinstance(cand, tuple) else (cand,)
                if not _axis_in_mesh(mesh, cand):
                    continue
                if any(a in used for a in cand_axes):
                    continue
                if dim % mesh_axis_size(mesh, cand) != 0:
                    continue
                assigned = cand
                used.update(cand_axes)
                break
        out.append(assigned)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec (module docstring) on a DeviceMesh.  A spec shorter than the
    tensor replicates the trailing dims."""
    mesh: Any
    spec: tuple = ()

    def _axes_of(self, entry) -> tuple:
        return () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))

    def placements(self) -> tuple:
        """One DTensor placement per mesh dim: ``Shard(d)`` for the dim of
        the tensor it splits, else ``Replicate()``.  A tensor dim split over
        several axes must name them in mesh order: DTensor splits a dim
        over its mesh dims major to minor in mesh order, which is the
        spec's order only then."""
        from torch.distributed.tensor import Replicate, Shard
        names = tuple(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            axes = self._axes_of(entry)
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {entry!r}: axes out of the "
                                 f"mesh's order {names}")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)

    def local_slices(self, shape) -> tuple:
        """This rank's block of a global tensor of ``shape``: one slice per
        dim."""
        return block_slices(shape, self.mesh, self.placements())

    def shard(self, x: torch.Tensor):
        """A DTensor holding this rank's block of the global tensor ``x``
        (which every rank holds whole); no communication."""
        return _place(x, self.mesh, self.placements())

    def wrap(self, block: torch.Tensor, shape):
        """The DTensor of global ``shape`` whose block on this rank is
        ``block`` (cut by ``local_slices(shape)``); no communication."""
        return _wrap(block, self.mesh, self.placements(), shape)


def block_slices(shape, mesh, placements) -> tuple:
    """This rank's block of a global tensor of ``shape`` under DTensor
    ``placements`` on ``mesh``: one slice per dim.  A dim split over
    several mesh dims is split major to minor in mesh order, as DTensor
    splits it.  Every split must be even (``spec_for`` assigns only axes
    that divide the dim)."""
    out = []
    for d, size in enumerate(shape):
        idx, parts = 0, 1
        for i, pl in enumerate(placements):
            if pl.is_shard(d):
                k = mesh.shape[i]
                idx = idx * k + mesh.get_local_rank(i)
                parts *= k
        if size % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"evenly over {parts} ranks")
        block = size // parts
        out.append(slice(idx * block, (idx + 1) * block))
    return tuple(out)


def gather(tree):
    """``tree`` with every DTensor leaf replaced by its whole tensor (an
    all-gather on the leaf's mesh; every rank calls it in the same
    order)."""
    from torch.distributed.tensor import DTensor
    return pytree.tree_map(
        lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


def shard_like(x: torch.Tensor, ref):
    """The global tensor ``x`` (held whole by every rank) placed as the
    DTensor ``ref`` is, cut locally with no communication; ``x`` itself
    when ``ref`` is not a DTensor."""
    from torch.distributed.tensor import DTensor
    if not isinstance(ref, DTensor):
        return x
    return _place(x, ref.device_mesh, ref.placements)


def _place(x: torch.Tensor, mesh, placements):
    return _wrap(x[block_slices(x.shape, mesh, placements)], mesh,
                 placements, x.shape)


def _wrap(block: torch.Tensor, mesh, placements, shape):
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    return DTensor.from_local(block.contiguous(), mesh, placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def logical_to_sharding(shape, logical, mesh,
                        rules=None) -> NamedSharding:
    rules = PARAM_RULES if rules is None else rules
    return NamedSharding(mesh, spec_for(shape, logical, mesh, rules))


def data_axes(mesh) -> tuple:
    """All pure data-parallel axes present in the mesh (pod is outer DP)."""
    names = _sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def batch_spec(mesh) -> tuple:
    """Rows over every data axis; one axis is named alone and none
    replicates, as a ``PartitionSpec`` normalizes its entries."""
    axes = data_axes(mesh)
    return (axes[0] if len(axes) == 1 else (axes or None),)


def constrain(x, mesh, *logical):
    """The reference's ``with_sharding_constraint`` by logical activation
    axes, which here returns ``x`` unchanged.  Activations are per-rank
    local tensors: a mesh step hands each rank its own rows of the batch
    (split over the data axes already) and gathers the params whole, so
    there is no layout left for the constraint to set."""
    return x
