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

The probe-chunk model (``probe_chunk_cost``, ``probe_csize_candidates``,
``model_csize_probes``) picks the csize of the Hutchinson ``diag``
workload on pytree plans and seeds the tuner's grid for it; it is pure
arithmetic, equal to the reference's.

The serving models are numpy-free integer/float arithmetic, identical to
the reference's: ``ragged_padding_waste`` (the cross-n coalescing gate) and
``suggest_dispatch_knobs`` (the per-queue dispatcher knobs the online
re-tune fits from telemetry).

``count_jaxpr_ops`` keeps the reference's name; it counts the aten ops of
a ``make_fx`` trace (imported when called).
"""

from __future__ import annotations

import math

from repro_torch.core.api import num_chunk_evals

__all__ = [
    "mults_chunk_hess", "mults_schunk_hess", "exact_mults",
    "csize_candidates", "pruned_csize_candidates", "model_csize",
    "MAX_CSIZE_CANDIDATE", "suggest_dispatch_knobs", "ragged_padding_waste",
    "PROBE_TRACE_COST", "probe_chunk_cost", "probe_csize_candidates",
    "model_csize_probes", "count_jaxpr_ops",
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


# ---------------------------------------------------------------------------
# probe-chunk model (the csize selector of the Hutchinson diag workload)
# ---------------------------------------------------------------------------
#
# A chunk of c Hutchinson probes shares one linearization of f (amortized
# over its probes) while the per-probe tangent state grows linearly in c.
# csize must DIVIDE n_probes exactly (the chunk loop has no ragged tail).

# relative cost of one f-linearization trace vs one probe-sweep work unit
PROBE_TRACE_COST = 8.0


def probe_chunk_cost(n_probes: int, c: int,
                     trace_cost: float = PROBE_TRACE_COST) -> float:
    """Modeled cost of evaluating ``n_probes`` probes in chunks of ``c``:
    ceil(P/c) shared linearizations + P per-probe sweeps (constant in c)
    + the linear fast-memory penalty of carrying c tangents at once."""
    return math.ceil(n_probes / c) * trace_cost + 6.0 * n_probes + c


def probe_csize_candidates(n_probes: int) -> list[int]:
    """Feasible probe-chunk sizes: divisors of n_probes (exact chunking),
    capped at ``MAX_CSIZE_CANDIDATE`` (the reference's lane width); always
    includes 1."""
    n_probes = int(n_probes)
    if n_probes < 1:
        raise ValueError(f"n_probes={n_probes} must be >= 1")
    return [c for c in range(1, n_probes + 1)
            if n_probes % c == 0 and (c <= MAX_CSIZE_CANDIDATE or c == 1)]


def model_csize_probes(n_probes: int) -> int:
    """Probe-chunk argmin of ``probe_chunk_cost`` over the divisor set: 4
    at the default n_probes=4, 16 at 64."""
    cands = probe_csize_candidates(n_probes)
    return min(cands, key=lambda c: (probe_chunk_cost(n_probes, c), c))


# ---------------------------------------------------------------------------
# dispatcher-knob model (the latency/throughput dial, driven from telemetry)
# ---------------------------------------------------------------------------

def suggest_dispatch_knobs(rate_rps: float, us_per_point_by_bucket: dict,
                           *, wait_cap_us: float = 5000.0,
                           max_batch_cap: int = 256):
    """Pick (max_batch, max_wait_us) for one plan queue from its measured
    per-bucket us/point and its observed arrival rate.

    The target bucket ``b*`` is the cheapest measured bucket whose FILL
    TIME at the observed Poisson rate -- (b-1)/rate, the wait the oldest
    request pays before a full dispatch -- stays inside ``wait_cap_us``.
    ``max_batch`` becomes ``b*`` and ``max_wait_us`` 1.5x the expected fill
    time (capped at ``wait_cap_us``).

    Returns ``(max_batch, max_wait_us)``, or None when there is nothing to
    learn from (no measured buckets, or no measured arrival rate -- the
    caller keeps its current knobs)."""
    cands = sorted(int(b) for b, us in us_per_point_by_bucket.items()
                   if us is not None and us > 0 and 1 <= b <= max_batch_cap)
    if not cands or rate_rps is None or rate_rps <= 0:
        return None
    fill_us = {b: (b - 1) / rate_rps * 1e6 for b in cands}
    feasible = [b for b in cands if fill_us[b] <= wait_cap_us]
    if not feasible:
        feasible = [min(cands)]     # overload-safe: smallest measured bucket
    best = min(feasible, key=lambda b: (us_per_point_by_bucket[b], b))
    max_wait_us = min(wait_cap_us, 1.5 * fill_us[best])
    return best, max_wait_us


def ragged_padding_waste(ns, n_pad=None):
    """Fraction of a cross-``n`` ragged bucket's row work wasted on padding.

    The scheduler may coalesce rows of effective dimension ``n_i`` from
    several plan queues into one bucket padded to ``n_pad`` columns.  The
    ``batched_hvp_ragged`` callable does dense work proportional to the
    PADDED width per row, so the wasted fraction under a linear-in-``n``
    row-work model is::

        1 - sum(n_i) / (len(ns) * n_pad)

    ``n_pad`` defaults to ``max(ns)`` (what the scheduler pads to).  The
    scheduler gates each candidate merge on this value staying under its
    ``coalesce_waste_max`` threshold: merging n=12 into an n=16 bucket
    wastes 12.5%; merging n=4 into n=128 wastes ~48% (rejected at the
    default 0.4 threshold)."""
    ns = [int(n) for n in ns]
    if not ns:
        raise ValueError("ragged_padding_waste: empty bucket")
    if any(n < 1 for n in ns):
        raise ValueError(f"ragged_padding_waste: row dims must be >= 1, "
                         f"got {ns}")
    if n_pad is None:
        n_pad = max(ns)
    elif n_pad < max(ns):
        raise ValueError(
            f"ragged_padding_waste: n_pad={n_pad} < max row dim {max(ns)}")
    return 1.0 - sum(ns) / (len(ns) * float(n_pad))


def count_jaxpr_ops(n, csize, n_mults):
    """Trace f(x)=x0*x1*...*x_{k} on hDuals; count mul/add ops.

    The port's counterpart of ``repro.engine.opmodel.count_jaxpr_ops``,
    under the reference's name: it traces ``eval_chunk(f, a, 0, 0,
    csize).dij`` with ``make_fx`` and counts ATEN ops (the ``mul`` and
    ``add`` overload families, in place or not), not jaxpr primitives, each
    weighted by its output's numel (a vector op over the chunk axis counts
    csize scalar ops).  Empirical check that one hDual multiply costs
    ~6c+3 scalar mults."""
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.core.api import eval_chunk

    def f(y):
        out = y[0]
        for i in range(1, n_mults + 1):
            out = out * y[i % n]
        return out

    a = torch.arange(1, n + 1, dtype=torch.float32)
    graph = make_fx(lambda a: eval_chunk(f, a, 0, 0, csize).dij)(a).graph
    counts = {"mul": 0, "add": 0}
    for node in graph.nodes:
        packet = getattr(node.target, "overloadpacket", None)
        name = getattr(packet, "__name__", "").rstrip("_")
        if node.op == "call_function" and name in counts:
            counts[name] += max(node.meta["val"].numel(), 1)
    return counts
