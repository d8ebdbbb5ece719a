"""Mesh-distributed CHESSFAD schedules on ``torch.distributed``.

Counterpart of ``repro.core.distributed``.  The paper's GPU grid maps onto
a named ``torch.distributed.device_mesh.DeviceMesh`` as:

  L0 (instances)  -> the ("pod", "data") mesh dims (embarrassingly parallel)
  L1 (rows)       -> the "model" mesh dim          (rows independent)
  L2 (chunks)     -> the cell batch of one hDual evaluation per shard

The reference writes each schedule as one SPMD program (``shard_map``).
Here every rank of the mesh runs the same Python (multi-controller torch),
and the program maps onto it as:

  - each rank receives the *global* replicated inputs and returns the
    *global* result on every rank (``shard_map``'s global view);
  - ``axis_index(model_axis)`` is the rank's coordinate on that mesh dim
    (its rank in the dim's process group);
  - ``psum`` is ``all_reduce(SUM)`` on that dim's group;
  - ``out_specs=P(model_axis)`` is an all-gather of the row blocks on it;
  - a ``P(model_axis)`` operand (the cyclic ``cells`` / ``valid`` lists) is
    its row ``[coord]``.

Every rank must make the same calls in the same order, as every collective
requires.  Data axes that name two mesh dims (``("pod", "data")``) share one
process group over both, created collectively once per (mesh, axes) and
cached.

``distributed_batched_hvp`` shards the instance batch over the data axes.
``distributed_hvp_rows`` / ``distributed_hessian_rows`` are the L1
row-sharded schedules behind the engine's ``sharded_rows`` backend: a
*single* large-n HVP or dense Hessian with its row blocks split over the
model axis.  Both serve ragged n (tail rows and chunks are clamped and
masked in-shard) and the Alg. 8 symmetric schedule.

Symmetric scheduling.  The kept (at-or-right-of-diagonal) cells are
enumerated on the host (``cyclic_layout``) and dealt to shards; every shard
sweeps only its own compacted cell list.  Row *blocks* (csize rows, so every
row in a block shares one diagonal chunk) are dealt in a reflected
round-robin ("snake") order: pairing block ``s`` with block ``2*size-1-s``
inside each window of ``2*size`` blocks gives every shard the same trip
total per full window, so per-shard kept-cell counts differ by at most one
block's cells (asserted in ``cyclic_layout``; observable through the
injectable ``cell_counter``).

Collectives: the symmetric HVP all-reduces full-length per-shard partials
(the mirror H[i,j]*v[i] -> r[j] crosses shards); the symmetric Hessian
all-gathers each shard's (slots, n) block of kept upper rows in shard-major
order, restores row order with an inverse-permutation gather and applies
the strictly-right-of-diagonal-block mirror locally.  The full schedules
need only their assembling all-gather.  ``row_layout="block"`` keeps the
contiguous evaluated-and-masked layout (a parity baseline); ``"cyclic"`` is
the default.

Every shard executes the reference's cells, clamped and masked tail cells
included, so the ``cell_counter`` reports and the roofline's cell counts
equal the reference's.  A cell is one batch element of one
``api.eval_chunk`` call.
"""

from __future__ import annotations

import functools
import math
import threading
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .api import batched_hvp_impl, eval_chunk

__all__ = ["distributed_batched_hvp", "distributed_hvp_rows",
           "distributed_hessian_rows", "rows_per_shard",
           "cyclic_layout", "CyclicLayout", "snake_shard_of_block"]

ROW_LAYOUTS = ("cyclic", "block")


# ---------------------------------------------------------------------------
# mesh dims as process groups
# ---------------------------------------------------------------------------

_GROUPS: dict = {}
_GROUPS_LOCK = threading.Lock()


def _axis_size(mesh, axis: str) -> int:
    return mesh.shape[tuple(mesh.mesh_dim_names).index(axis)]


def _group(mesh, axes: tuple):
    """The process group over the mesh dims ``axes``: the dim's own group
    for one axis; for several, one group per coordinate of the other dims,
    created by every rank in the same order (``new_group`` is collective)
    on first use and cached per (world, mesh, axes): a world that was
    destroyed and started anew gets groups of its own."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    world = dist.group.WORLD
    key = (world, mesh, axes)
    with _GROUPS_LOCK:
        group = _GROUPS.get(key)
        if group is None:
            for old in [k for k in _GROUPS if k[0] is not world]:
                del _GROUPS[old]          # the groups of a destroyed world
            names = tuple(mesh.mesh_dim_names)
            dims = [names.index(a) for a in axes]
            rest = [d for d in range(mesh.ndim) if d not in dims]
            width = math.prod(mesh.shape[d] for d in dims)
            me = dist.get_rank()
            for ranks in (mesh.mesh.permute(rest + dims)
                          .reshape(-1, width).tolist()):
                g = dist.new_group(ranks)
                if me in ranks:
                    group = g
            _GROUPS[key] = group
    return group


def _all_gather(x, group, size: int):
    """Concatenate every group member's ``x`` along dim 0, in group-rank
    order (the order ``dist.get_rank(group)`` gives the shards)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def _all_reduce(x, group):
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _model_shard(mesh, model_axis: str):
    """(group, size, coord) of the rank on the model axis."""
    group = _group(mesh, (model_axis,))
    return group, _axis_size(mesh, model_axis), dist.get_rank(group)


# ---------------------------------------------------------------------------
# L0: instances over the data axes
# ---------------------------------------------------------------------------

def distributed_batched_hvp(mesh, f, A, V, csize: int = 8,
                            level: str = "L2", symmetric: bool = False,
                            data_axes=("data",)):
    """L0 sharding: instances split across the data mesh axes.

    A, V: (m, n), the same on every rank, with m divisible by the product of
    the data-axis sizes (ValueError otherwise: a plan that carries a mesh
    asked for sharding, so no unsharded fallback).  Each rank runs the raw
    ``batched_hvp_impl`` schedule on its block and the blocks are
    all-gathered, so every rank returns the (m, n) result."""
    names = tuple(mesh.mesh_dim_names or ())
    axes = tuple(a for a in data_axes if a in names)
    A = torch.as_tensor(A)
    V = torch.as_tensor(V)
    m = A.shape[0]
    shards = math.prod(_axis_size(mesh, a) for a in axes)
    if m % shards:
        raise ValueError(
            f"distributed_batched_hvp: m={m} instances do not divide over "
            f"the {shards} shards of data axes {axes}")
    if not axes:
        return batched_hvp_impl(f, A, V, csize=csize, level=level,
                                symmetric=symmetric)
    group = _group(mesh, axes)
    blk = m // shards
    lo = dist.get_rank(group) * blk
    R = batched_hvp_impl(f, A[lo:lo + blk], V[lo:lo + blk], csize=csize,
                         level=level, symmetric=symmetric)
    return _all_gather(R, group, shards)


def rows_per_shard(n: int, size: int) -> int:
    """Row-block height per model shard: ceil(n / size); the last shard's
    tail rows beyond n are dead (masked in-shard)."""
    return -(-int(n) // int(size))


# ---------------------------------------------------------------------------
# cyclic (snake) row-block layout for the symmetric triangle
# ---------------------------------------------------------------------------

def snake_shard_of_block(nblocks: int, size: int) -> np.ndarray:
    """Shard owning each chunk-block under the reflected round-robin deal.

    Blocks 0..nblocks-1 have descending symmetric trip counts nchunk-b;
    dealing each window of 2*size blocks as 0,1,..,size-1,size-1,..,1,0
    pairs block ``w*2s + s`` with ``w*2s + (2s-1-s)`` whose trips sum to a
    window constant, so full windows load every shard identically."""
    b = np.arange(int(nblocks))
    r = b % (2 * size)
    return np.where(r < size, r, 2 * size - 1 - r).astype(np.int64)


@dataclass(frozen=True)
class CyclicLayout:
    """Host-side compacted symmetric cell schedule for one (n, csize, size).

    cells[s, t] = (row, cstart, local_slot) of shard s's t-th kept cell
    (dead padding cells are clamped to (0, 0, 0) with valid False); every
    shard executes exactly ``executed`` cells, of which ``kept[s]`` are
    real.  ``row_of_slot`` / ``slot_of_row`` are the shard-major row
    permutation and its inverse (the post-all-gather restoring gather).
    """

    n: int
    csize: int
    size: int
    blocks: tuple              # per-shard owned chunk-block ids
    cells: np.ndarray          # (size, executed, 3) int32
    valid: np.ndarray          # (size, executed) bool
    kept: tuple                # per-shard real cell counts
    executed: int              # static per-shard trip count (= max kept)
    slots: int                 # local row slots per shard (all-gather width)
    row_of_slot: np.ndarray    # (size * slots,) global row, -1 dead
    slot_of_row: np.ndarray    # (n,) gathered index of each global row

    @property
    def block_cells_bound(self) -> int:
        """One block's worth of cells: the kept-count balance bound."""
        nchunk = -(-self.n // self.csize)
        return self.csize * nchunk


@functools.lru_cache(maxsize=256)
def cyclic_layout(n: int, csize: int, size: int) -> CyclicLayout:
    """Build (and memoize) the compacted snake-cyclic symmetric schedule.

    Enumerates ONLY the at-or-right-of-diagonal cells (sum over shards ==
    ``num_chunk_evals(n, csize, True)`` -- no masked ghosts), deals row
    blocks snake-cyclically, and pads every shard's list to one common
    static length.  Asserts the balance invariant: per-shard kept-cell
    counts differ by at most one block's cells."""
    n, csize, size = int(n), int(csize), int(size)
    nchunk = -(-n // csize)
    shard_of = snake_shard_of_block(nchunk, size)
    blocks = tuple(tuple(int(b) for b in np.nonzero(shard_of == s)[0])
                   for s in range(size))
    max_blocks = max(len(bs) for bs in blocks) if size else 0
    slots = max_blocks * csize

    per_shard = []
    for s in range(size):
        cs = []
        for pos, b in enumerate(blocks[s]):
            for r in range(b * csize, min((b + 1) * csize, n)):
                slot = pos * csize + (r - b * csize)
                for cc in range(b, nchunk):
                    cs.append((r, cc * csize, slot))
        per_shard.append(cs)
    kept = tuple(len(cs) for cs in per_shard)
    executed = max(kept)
    # balance invariant of the snake deal: at most one block apart
    bound = csize * nchunk
    assert max(kept) - min(kept) <= bound, (n, csize, size, kept)

    cells = np.zeros((size, executed, 3), np.int32)
    valid = np.zeros((size, executed), bool)
    for s, cs in enumerate(per_shard):
        if cs:
            cells[s, :len(cs)] = np.asarray(cs, np.int32)
            valid[s, :len(cs)] = True

    row_of_slot = np.full((size * slots,), -1, np.int64)
    slot_of_row = np.zeros((n,), np.int64)
    for s in range(size):
        for pos, b in enumerate(blocks[s]):
            for r in range(b * csize, min((b + 1) * csize, n)):
                g = s * slots + pos * csize + (r - b * csize)
                row_of_slot[g] = r
                slot_of_row[r] = g
    return CyclicLayout(n=n, csize=csize, size=size, blocks=blocks,
                        cells=cells, valid=valid, kept=kept,
                        executed=executed, slots=slots,
                        row_of_slot=row_of_slot, slot_of_row=slot_of_row)


def _count(cell_counter, layout: str, executed_per_shard, kept_per_shard):
    """Report the schedule's static cell accounting to an injected counter
    (tests / the roofline report); called once per schedule call."""
    if cell_counter is not None:
        cell_counter({"layout": layout,
                      "executed_per_shard": list(executed_per_shard),
                      "kept_per_shard": list(kept_per_shard)})


def _cell_grid(n: int, csize: int, rows_per: int, row0: int,
               device=None):
    """Static (rows_per * nchunk) cell enumeration for one shard's row
    block, offset by the shard's first row.

    Returns (ks, rows_c, starts, cols, cols_c, valid) where ``ks`` is the
    block-local row of each cell and ``rows_c`` / ``cols_c`` are clamped
    into range so dead tail cells evaluate somewhere legal while ``valid``
    masks their contributions to zero.  (Full schedules and the
    ``row_layout="block"`` symmetric parity path.)
    """
    nchunk = -(-n // csize)
    ks = torch.arange(rows_per, device=device).repeat_interleave(nchunk)
    starts = (torch.arange(nchunk, device=device) * csize).repeat(rows_per)
    gis = row0 + ks
    rows_c = gis.clamp(max=n - 1)
    cols = starts[:, None] + torch.arange(csize, device=device)[None, :]
    valid = (cols < n) & (gis < n)[:, None]
    cols_c = cols.clamp(max=n - 1)
    return ks, rows_c, starts, cols, cols_c, valid


def _chunks(f, a, rows, starts, csize: int):
    """dij of every cell: one ``eval_chunk`` over the (P,) cell batch ->
    (P, csize)."""
    return eval_chunk(f, a, rows, starts, csize).dij


def _check_layout(row_layout: str) -> None:
    if row_layout not in ROW_LAYOUTS:
        raise ValueError(f"unknown row_layout {row_layout!r}; "
                         "expected 'cyclic' or 'block'")


def _cyclic_cells(lay: CyclicLayout, coord: int, n: int, csize: int,
                  device):
    """This shard's compacted kept cells: (rows, starts, slot, cols,
    cols_c, valid)."""
    cells = torch.as_tensor(lay.cells[coord], device=device).long()
    rows, starts, slot = cells[:, 0], cells[:, 1], cells[:, 2]
    cols = starts[:, None] + torch.arange(csize, device=device)[None, :]
    valid = (torch.as_tensor(lay.valid[coord], device=device)[:, None]
             & (cols < n))
    return rows, starts, slot, cols, cols.clamp(max=n - 1), valid


# ---------------------------------------------------------------------------
# L1: rows of a single HVP / Hessian over the model axis
# ---------------------------------------------------------------------------

def distributed_hvp_rows(mesh, f, a, v, csize: int = 8,
                         model_axis: str = "model",
                         symmetric: bool = False,
                         row_layout: str = "cyclic",
                         cell_counter=None):
    """L1 sharding of a *single* HVP: Hessian rows split over the model axis.

    Each shard sweeps the chunks of its row block (rows are independent --
    no collective is needed for a row's own r[i]); ragged row/chunk tails
    are masked in-shard, so any (n, csize, axis size) combination is
    served.  With ``symmetric=True`` the Alg. 8 schedule runs on the
    compacted snake-cyclic cell lists (``row_layout="cyclic"``, default):
    below-diagonal cells are DROPPED from the per-shard enumeration, not
    masked.  The mirror H[i,j]*v[i] -> r[j] crosses row shards, so the
    symmetric path all-reduces full-length per-shard partials; the full
    schedule all-gathers its row blocks.  ``row_layout="block"`` keeps the
    evaluated-and-masked contiguous layout as a parity baseline; any other
    layout raises ValueError.  ``cell_counter`` (injectable, tests)
    receives the per-shard executed/kept cell counts.
    """
    _check_layout(row_layout)
    a = torch.as_tensor(a)
    v = torch.as_tensor(v)
    n, dev = a.shape[-1], a.device
    group, size, coord = _model_shard(mesh, model_axis)
    rows_per = rows_per_shard(n, size)
    nchunk = -(-n // csize)

    if not symmetric or row_layout == "block":
        _count(cell_counter, "block", [rows_per * nchunk] * size,
               [rows_per * nchunk] * size)
        ks, rows_c, starts, cols, cols_c, valid = _cell_grid(
            n, csize, rows_per, coord * rows_per, dev)
        chunks = _chunks(f, a, rows_c, starts, csize)
        if not symmetric:
            contrib = torch.where(valid, chunks * v[cols_c], 0.0)
            r_blk = a.new_zeros((rows_per,)).index_add_(0, ks,
                                                        contrib.sum(-1))
            return _all_gather(r_blk, group, size)[:n]
        # evaluated-and-masked: the block's below-diagonal cells are swept
        # and dropped
        block = (rows_c // csize)[:, None]
        direct = torch.where(valid & ((cols // csize) >= block),
                             chunks * v[cols_c], 0.0)
        r = a.new_zeros((n,)).index_add_(0, rows_c, direct.sum(-1))
        upper = ((cols // csize) > block) & valid
        mirror = torch.where(upper, chunks * v[rows_c][:, None], 0.0)
        r.index_add_(0, cols_c.reshape(-1), mirror.reshape(-1))
        return _all_reduce(r, group)

    lay = cyclic_layout(n, csize, size)
    _count(cell_counter, "cyclic", [lay.executed] * size, lay.kept)
    rows, starts, _slot, _cols, cols_c, valid = _cyclic_cells(
        lay, coord, n, csize, dev)
    chunks = _chunks(f, a, rows, starts, csize)
    direct = torch.where(valid, chunks * v[cols_c], 0.0)
    r = a.new_zeros((n,)).index_add_(0, rows, direct.sum(-1))
    # cells strictly right of their row's diagonal block mirror wholesale
    # (chunk-granular, vmap_l2 semantics)
    mirrors = starts > (rows // csize) * csize
    mirror = torch.where(valid & mirrors[:, None],
                         chunks * v[rows][:, None], 0.0)
    r.index_add_(0, cols_c.reshape(-1), mirror.reshape(-1))
    return _all_reduce(r, group)


def distributed_hessian_rows(mesh, f, a, csize: int = 8,
                             model_axis: str = "model",
                             symmetric: bool = False,
                             row_layout: str = "cyclic",
                             cell_counter=None):
    """L1 sharding of a *single* dense Hessian: each model shard fills its
    row block of H.

    The full schedule stacks the per-shard (rows_per, n) blocks with an
    all-gather.  The symmetric schedule (``row_layout="cyclic"``, default)
    evaluates ONLY the kept at-or-right-of-diagonal cells of its
    snake-dealt row blocks, all-gathers the (slots, n) upper blocks in
    shard-major (permuted) row order, restores row order with an
    inverse-permutation gather, and applies the strictly-right-of-
    diagonal-block mirror locally on the replicated result -- no all-reduce.
    ``row_layout="block"`` all-reduces full (n, n) partials as a parity
    baseline; any other layout raises ValueError.
    """
    _check_layout(row_layout)
    a = torch.as_tensor(a)
    n, dev = a.shape[-1], a.device
    group, size, coord = _model_shard(mesh, model_axis)
    rows_per = rows_per_shard(n, size)
    nchunk = -(-n // csize)

    if not symmetric or row_layout == "block":
        _count(cell_counter, "block", [rows_per * nchunk] * size,
               [rows_per * nchunk] * size)
        ks, rows_c, starts, cols, cols_c, valid = _cell_grid(
            n, csize, rows_per, coord * rows_per, dev)
        chunks = _chunks(f, a, rows_c, starts, csize)
        if not symmetric:
            blk = a.new_zeros((rows_per, n))
            blk.index_put_((ks[:, None].expand(cols_c.shape), cols_c),
                           torch.where(valid, chunks, 0.0), accumulate=True)
            return _all_gather(blk, group, size)[:n]
        block = (rows_c // csize)[:, None]
        rr = rows_c[:, None].expand(cols_c.shape)
        H = a.new_zeros((n, n))
        H.index_put_((rr, cols_c),
                     torch.where(valid & ((cols // csize) >= block),
                                 chunks, 0.0), accumulate=True)
        upper = ((cols // csize) > block) & valid
        H.index_put_((cols_c, rr), torch.where(upper, chunks, 0.0),
                     accumulate=True)
        return _all_reduce(H, group)

    lay = cyclic_layout(n, csize, size)
    _count(cell_counter, "cyclic", [lay.executed] * size, lay.kept)
    rows, starts, slot, _cols, cols_c, valid = _cyclic_cells(
        lay, coord, n, csize, dev)
    chunks = _chunks(f, a, rows, starts, csize)
    blk = a.new_zeros((lay.slots, n))
    blk.index_put_((slot[:, None].expand(cols_c.shape), cols_c),
                   torch.where(valid, chunks, 0.0), accumulate=True)
    # shard-major permuted kept-row blocks -> restore row order with the
    # inverse-permutation gather, then mirror locally (replicated)
    U = _all_gather(blk, group, size)[
        torch.as_tensor(lay.slot_of_row, device=dev)]
    bi = torch.arange(n, device=dev) // csize
    strictly_right = bi[None, :] > bi[:, None]
    return U + torch.where(strictly_right, U, 0.0).T
