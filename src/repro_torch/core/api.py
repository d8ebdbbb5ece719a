"""CHESSFAD public API: chunked Hessian / Hessian-vector products.

Counterpart of ``repro.core.api``.  Paper algorithm -> this module:

  Alg. 4  CHUNK-INIT        -> hdual.seed_point
  Alg. 5  CHUNK-HESS        -> hessian(..., symmetric=False)
  Alg. 6  SCHUNK-HESS       -> hessian(..., symmetric=True)
  Alg. 7  CHESS-VEC         -> hvp(..., symmetric=False)
  Alg. 8  SC-HESS-VEC       -> hvp(..., symmetric=True)
  Alg. 9  L0-HESS-VEC       -> batched_hvp(..., level="L0")
  Alg. 10 L1-HESS-VEC       -> batched_hvp(..., level="L1")
  Fig. 2  L2 CUDA kernel    -> batched_hvp(..., level="L2") and
                               kernels/chess_hvp (CUDA C++)

The reference's ``vmap`` axes are written out here as trailing batch axes of
the seeded value shape: a seeded point has value shape ``(n, cells,
instances)`` (variables first), so one evaluation of ``f`` covers every
(cell, instance) pair, and the reference's ``scan`` loops become Python
loops.  ``f`` must therefore broadcast over trailing axes of its input --
the paper's test functions (``core.testfns``) do.

The public functions at the bottom are thin facades over
``repro_torch.engine``; the raw schedules (``*_impl``) are what the engine's
backends call.
"""

from __future__ import annotations

import numpy as np
import torch

from .hdual import HDual, seed_point

__all__ = [
    "eval_chunk", "hessian", "hvp", "gradient", "batched_hvp", "batched_hessian",
    "chunk_pairs", "num_chunk_evals", "optimal_csize",
    "hessian_impl", "hvp_impl", "batched_hvp_impl",
]


# ---------------------------------------------------------------------------
# chunk enumeration (static)
# ---------------------------------------------------------------------------

def _nchunk(n: int, csize: int) -> int:
    return -(-n // csize)  # ceil; the paper assumes csize | n, we allow padding


def chunk_pairs(n: int, csize: int, symmetric: bool) -> np.ndarray:
    """All (row i, chunk start) pairs to evaluate, as a (P, 2) int array.

    symmetric=True enumerates only chunks at-or-right-of the diagonal chunk
    (paper Alg. 6 line 4: startchunk = i / csize), giving
    P = n*(n/csize + 1)/2 instead of n^2/csize.
    """
    nc = _nchunk(n, csize)
    if symmetric:
        pairs = [(i, c * csize) for i in range(n) for c in range(i // csize, nc)]
    else:
        pairs = [(i, c * csize) for i in range(n) for c in range(nc)]
    return np.asarray(pairs, dtype=np.int32)


def num_chunk_evals(n: int, csize: int, symmetric: bool) -> int:
    return len(chunk_pairs(n, csize, symmetric))


def optimal_csize(n: int) -> int:
    """Paper §5: scalar multiplications of SCHUNK-HESS are minimized at
    csize = sqrt(n/2); returns the §5 model argmin (the engine's op model)."""
    from repro_torch.engine.opmodel import model_csize
    return model_csize(n, symmetric=True)


# ---------------------------------------------------------------------------
# chunk evaluation
# ---------------------------------------------------------------------------

def eval_chunk(f, a, i, cstart, csize: int):
    """Evaluate one hDual pass: returns the output HDual whose ``dij`` is the
    csize-wide chunk ``H[i, cstart:cstart+csize]`` (paper Alg. 5 lines 5-10).

    ``a`` is (n, *S); ``i`` and ``cstart`` are ints or integer tensors
    broadcastable against ``S`` -- every batch element is one pass."""
    y = seed_point(a, i, cstart, csize)
    out = f(y)
    if not isinstance(out, HDual):
        raise TypeError("CHESSFAD target function must return an HDual scalar; "
                        "write it against repro_torch.core.hmath ops")
    return out


def _cells(n, csize, symmetric, device):
    pairs = torch.from_numpy(chunk_pairs(n, csize, symmetric)).to(device)
    return pairs[:, 0].long(), pairs[:, 1].long()


def _cell_chunks(f, A, rows, starts, csize, compute_dtype):
    """dij of every (cell, instance) pair: A (m, n) -> (P, m, csize), in
    A.dtype.  One evaluation of f at value shape (n, P, m)."""
    Ac = A.to(compute_dtype) if compute_dtype is not None else A
    out = eval_chunk(f, Ac.T[:, None, :], rows[:, None], starts[:, None],
                     csize)
    return out.dij.to(A.dtype)


def _chunk_cols(starts, csize, n):
    cols = starts[:, None] + torch.arange(csize, device=starts.device)
    valid = cols < n                                   # ragged tail guard
    return cols.clamp(max=n - 1), valid


# ---------------------------------------------------------------------------
# full Hessian (Alg. 5 / Alg. 6)
# ---------------------------------------------------------------------------

def _batched_hessian_impl(f, A, csize, symmetric, compute_dtype):
    m, n = A.shape
    rows, starts = _cells(n, csize, symmetric, A.device)
    chunks = _cell_chunks(f, A, rows, starts, csize, compute_dtype)
    cols, valid = _chunk_cols(starts, csize, n)                 # (P, c)
    zero = chunks.new_zeros(())
    H = A.new_zeros((m, n * n))
    direct = torch.where(valid[:, None, :], chunks, zero)       # (P, m, c)
    H.index_add_(1, (rows[:, None] * n + cols).reshape(-1),
                 direct.permute(1, 0, 2).reshape(m, -1))
    if symmetric:
        # mirror the strictly-upper chunk region (paper Alg. 6 lines 14-18)
        upper = (cols // csize > (rows // csize)[:, None]) & valid
        mirror = torch.where(upper[:, None, :], chunks, zero)
        H.index_add_(1, (cols * n + rows[:, None]).reshape(-1),
                     mirror.permute(1, 0, 2).reshape(m, -1))
    return H.reshape(m, n, n)


def hessian_impl(f, a, csize: int = 1, symmetric: bool = True,
                 compute_dtype=None):
    """Raw dense-Hessian schedule: every (row, chunk) cell is one batch
    element of a single hDual evaluation.  ``compute_dtype`` casts the
    tangent sweeps; the scatter accumulation stays in ``a.dtype``."""
    a = torch.as_tensor(a)
    return _batched_hessian_impl(f, a[None], csize, symmetric,
                                 compute_dtype)[0]


# ---------------------------------------------------------------------------
# gradient (free byproduct: dj slots hold first derivatives)
# ---------------------------------------------------------------------------

def gradient(f, a, csize: int = 8):
    """Forward-mode gradient reusing the hDual machinery: one row (i=0),
    n/csize chunk sweeps; reads the ``dj`` slots."""
    a = torch.as_tensor(a)
    n = a.shape[-1]
    starts = torch.arange(_nchunk(n, csize), device=a.device) * csize
    djs = eval_chunk(f, a, 0, starts, csize).dj                 # (nc, c)
    return djs.reshape(-1)[:n]


# ---------------------------------------------------------------------------
# Hessian-vector product (Alg. 7 / Alg. 8) and the L2 schedule (Fig. 2)
# ---------------------------------------------------------------------------

def _l2_impl(f, A, V, csize, symmetric, compute_dtype):
    """Every (cell, instance) pair in one evaluation, then a segment sum:
    R[m, i] = sum over cells of row i of H[i, chunk] . V[m, chunk]."""
    m, n = A.shape
    rows, starts = _cells(n, csize, symmetric, A.device)
    chunks = _cell_chunks(f, A, rows, starts, csize, compute_dtype)
    cols, valid = _chunk_cols(starts, csize, n)
    zero = chunks.new_zeros(())
    vc = V[:, cols].permute(1, 0, 2)                            # (P, m, c)
    contrib = torch.where(valid[:, None, :], chunks * vc, zero).sum(-1)
    R = A.new_zeros((m, n))
    R.index_add_(1, rows, contrib.T)                            # H[i,j] v[j]
    if symmetric:
        # strictly-above chunk elements also give H[i,j] v[i] to R[j]
        # (Alg. 8 lines 12-15; chunk-granular like the reference)
        upper = (cols // csize > (rows // csize)[:, None]) & valid
        vi = V[:, rows].T[:, :, None]                           # (P, m, 1)
        mirror = torch.where(upper[:, None, :], chunks * vi, zero)
        R.index_add_(1, cols.reshape(-1),
                     mirror.permute(1, 0, 2).reshape(m, -1))
    return R


def hvp_impl(f, a, v, csize: int = 1, symmetric: bool = True,
             compute_dtype=None):
    """Raw HVP schedule: r = H(a) @ v without materializing H.

    Chunks are computed, dotted against v, and discarded (paper §3.3). With
    symmetric=True the below-diagonal chunks are never evaluated.
    ``compute_dtype`` runs the hDual tangent sweeps in that dtype while the
    dot-and-scatter accumulation stays in ``a.dtype``."""
    a = torch.as_tensor(a)
    v = torch.as_tensor(v)
    return _l2_impl(f, a[None], v[None], csize, symmetric, compute_dtype)[0]


def batched_hvp_impl(f, A, V, csize: int = 1, level: str = "L2",
                     symmetric: bool = False, compute_dtype=None):
    """Raw batched-HVP schedules for m instances: A, V are (m, n).

    level="L0": rows and chunks sequential (loops) per instance batch --
                Alg. 9's thread-per-instance.
    level="L1": rows batched, chunks sequential -- Alg. 10.
    level="L2": rows x chunks fully batched + segment reduction -- Fig. 2.

    As in the reference, L0 and L1 always sweep the full chunk grid;
    ``symmetric`` applies to L2."""
    if level not in ("L0", "L1", "L2"):
        raise ValueError(f"unknown level {level!r}")
    A = torch.as_tensor(A)
    V = torch.as_tensor(V)
    if level == "L2":
        return _l2_impl(f, A, V, csize, symmetric, compute_dtype)

    m, n = A.shape
    acc_dt = A.dtype
    Ac = A.to(compute_dtype) if compute_dtype is not None else A
    at = Ac.T                                                   # (n, m)
    lanes = torch.arange(csize, device=A.device)
    starts = range(0, _nchunk(n, csize) * csize, csize)

    def row_sweep(i):
        """Sequential chunk sweep (Alg. 9 inner loop) for row(s) ``i``."""
        a = at if isinstance(i, int) else at[:, None, :]
        res = None
        for cstart in starts:
            dij = eval_chunk(f, a, i, cstart, csize).dij.to(acc_dt)
            cols = cstart + lanes
            vc = V[:, cols.clamp(max=n - 1)]                    # (m, c)
            term = torch.where(cols < n, dij * vc, 0.0).sum(-1)
            res = term if res is None else res + term
        return res

    if level == "L1":
        rows = torch.arange(n, device=A.device)[:, None]        # (n, 1)
        return row_sweep(rows).T                                # (m, n)
    return torch.stack([row_sweep(i) for i in range(n)], dim=1)


# ---------------------------------------------------------------------------
# public facades: plan/execute through the engine
# ---------------------------------------------------------------------------

def _plan(f, x, csize, symmetric, backend="auto", m=None):
    # the plan runs where the data lives; non-tensor input takes the plan's
    # default device (the card)
    from repro_torch.engine import plan as engine_plan
    kw = {"device": x.device} if isinstance(x, torch.Tensor) else {}
    return engine_plan(f, x.shape[-1], m=m, csize=csize, symmetric=symmetric,
                       backend=backend, **kw)


def hessian(f, a, csize=1, symmetric: bool = True):
    """Dense Hessian of scalar ``f`` at ``a`` (shape (n,)) via the engine's
    chunked forward-mode schedule.  csize may be an int or "auto"."""
    return _plan(f, a, csize, symmetric).hessian(a)


def hvp(f, a, v, csize=1, symmetric: bool = True):
    """r = H(a) @ v without materializing H (engine-planned and cached)."""
    return _plan(f, a, csize, symmetric).hvp(a, v)


def batched_hvp(f, A, V, csize=1, level: str = "L2",
                symmetric: bool = False):
    """HVPs for m instances under the paper's L0/L1/L2 schedule; the level
    maps onto the matching engine backend (vmap_l0/l1/l2).  A.shape[0] is
    forwarded only as the plan's ``m`` hint."""
    if level not in ("L0", "L1", "L2"):
        raise ValueError(f"unknown level {level!r}")
    return _plan(f, A, csize, symmetric, backend=f"vmap_{level.lower()}",
                 m=A.shape[0]).batched_hvp(A, V)


def batched_hessian(f, A, csize=1, symmetric: bool = True):
    """Dense Hessians for m instances (m, n) -> (m, n, n)."""
    return _plan(f, A, csize, symmetric, m=A.shape[0]).batched_hessian(A)
