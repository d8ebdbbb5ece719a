"""Paper §5 scalar-operation-count model -- the engine's csize selector.

Counterpart of ``repro.engine.opmodel`` (its static part), integer-identical
to it:

  hDual<c> multiply = 6c+3 scalar mults + 4c adds; add = 2c+2 adds.
  CHUNK-HESS  : (6 + 3/c) n^2 M mults          (monotone decreasing in c)
  SCHUNK-HESS : (3/2) n (2n + 2c + n/c + 1) M  (convex, minimized at
                c* = sqrt(n/2))

``model_csize`` minimizes the exact schedule cost: the number of chunk
sweeps the schedules execute (``core.api.num_chunk_evals``: ceil-div chunk
grids, and for ``symmetric=True`` only the kept at-or-right-of-diagonal
cells) times the per-sweep hDual<c> multiply cost 6c+3.  A pure static
decision, no tracing or timing.
"""

from __future__ import annotations

from repro_torch.core.api import num_chunk_evals

__all__ = [
    "mults_chunk_hess", "mults_schunk_hess", "exact_mults",
    "csize_candidates", "pruned_csize_candidates", "model_csize",
    "MAX_CSIZE_CANDIDATE",
]

# The reference caps candidates at its TPU lane width (128).  The cap stays
# at 128 here so that csize="auto" picks the same chunk as the reference for
# every n; the CUDA kernel's own limit (csize <= 64) is a backend veto, not
# a planning rule.
MAX_CSIZE_CANDIDATE = 128


def mults_chunk_hess(n, c, M):
    """Scalar multiplies of CHUNK-HESS (paper §5, non-symmetric)."""
    return (6 + 3 / c) * n * n * M


def mults_schunk_hess(n, c, M):
    """Scalar multiplies of SCHUNK-HESS (paper §5, symmetric)."""
    return 1.5 * n * (2 * n + 2 * c + n / c + 1) * M


def exact_mults(n, c, symmetric, M: int = 1):
    """Executed chunk sweeps (``num_chunk_evals``) times the hDual<c>
    multiply cost 6c+3.  Reduces to ``mults_chunk_hess`` /
    ``mults_schunk_hess`` when c | n."""
    return num_chunk_evals(n, c, bool(symmetric)) * (6 * c + 3) * M


def csize_candidates(n: int) -> list[int]:
    """Feasible csizes: powers of two up to the first one covering n, capped
    at ``MAX_CSIZE_CANDIDATE``; always includes 1."""
    cands = []
    c = 1
    while True:
        cands.append(c)
        if c >= min(n, MAX_CSIZE_CANDIDATE):
            break
        c *= 2
    return cands


def pruned_csize_candidates(n: int, symmetric: bool = False,
                            factor: float = 2.0) -> list[int]:
    """Candidate csizes worth measuring: drop candidates whose modeled work
    exceeds ``factor``x the model minimum; the model argmin is always kept."""
    cands = csize_candidates(n)
    best = min(exact_mults(n, c, symmetric) for c in cands)
    keep = [c for c in cands if exact_mults(n, c, symmetric) <= factor * best]
    argmin = model_csize(n, symmetric)
    if argmin not in keep:
        keep.append(argmin)
    return sorted(keep)


def model_csize(n: int, symmetric: bool = True) -> int:
    """Exact schedule-cost argmin over the candidate set (``exact_mults``).

    symmetric=True  -> kept-triangle sweep count: exact argmin.
    symmetric=False -> full-grid count, monotone but nearly flat past small
                       c while the hDual state (2c+2 floats per value) keeps
                       growing: the SMALLEST candidate within 10% of the
                       model minimum.
    """
    cands = csize_candidates(n)
    best = min(exact_mults(n, c, symmetric) for c in cands)
    if symmetric:
        return min(cands, key=lambda c: (exact_mults(n, c, symmetric), c))
    return min(c for c in cands
               if exact_mults(n, c, symmetric) <= 1.10 * best)
