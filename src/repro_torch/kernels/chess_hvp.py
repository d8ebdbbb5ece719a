"""chess_hvp: the paper's L2 kernel (Fig. 2), hand-written in CUDA C++ for
Hopper, with its plain PyTorch version.

Counterpart of ``repro.kernels.chess_hvp`` (``chess_hvp_pallas``).  The
kernel (``csrc/chess_hvp.cu``, header ``csrc/hdual.cuh``) computes
``out[m] = H_f(A[m]) @ V[m]`` over the flattened cell list of
``core.api.chunk_pairs(n, csize, symmetric)``: one CTA owns a few instances,
a cell carries hDuals only for its active coordinates (row i and its
columns), the constants enter as primal sums hoisted per instance, and the
direct and mirrored terms meet in a shared-memory output row (see the note at
the top of the source).

* ``chess_hvp_cuda`` is the wrapper.  On a CUDA tensor it launches the
  kernel (building it at first use, ``kernels/build.py``) and counts the
  launch in ``chess_hvp_cuda.launches``; on a CPU tensor it returns the plain
  version; anything else raises.  There is no fallback from the kernel.
* ``chess_hvp_plain`` is the same function in plain PyTorch, batched over
  cells and instances as in the Pallas body.
* ``shared_bytes`` is a launch's shared memory; ``supports``/``max_n`` say
  which n one CTA can take, and the engine's ``cuda`` backend vetoes the rest.
* ``work`` is the first kernel's dense operation count (every lane of every
  coordinate's hDual); ``needed_work`` counts the hDual work of the active
  coordinates only, the bound the kernel is held to.

The kernel evaluates f through a device form written in CUDA (``device_fn``,
one of ``DEVICE_FNS``), so only the test functions that carry one run on it
-- narrower than the Pallas kernel, which traces any hmath-written f.  Like
the Pallas kernel it takes A and V in float32, bfloat16 or float16, computes
in float32 and returns ``A.dtype``, and serves any ``csize >= 1``: a chunk
wider than the widest lane instantiation runs as several sub-cells
(``sub_cells``).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from repro_torch.core.api import _l2_impl, chunk_pairs, num_chunk_evals

from . import build

__all__ = ["chess_hvp_cuda", "chess_hvp_plain", "kernel_grid", "DEVICE_FNS",
           "LANES", "lanes_for", "sub_cells", "cell_operations", "work",
           "launch_config", "shared_bytes", "supports", "max_n",
           "needed_cell_operations", "needed_work"]

THREADS = 256                      # threads per CTA (kThreads in the source)
WARPS = 8                          # Fletcher-Powell warps per CTA, at most
LANES = (1, 2, 4, 8, 16, 32, 64)   # the hDual<C> instantiations
DEVICE_FNS = {"rosenbrock": 0, "ackley": 1, "fletcher_powell": 2}
SMEM_MAX = 232448                  # opt-in shared memory per CTA on sm_90
# per device form: rows of n|1 floats per instance slot (a, v, out and its
# primal tables) and scalars after them
_ROWS = {"rosenbrock": 3, "ackley": 5, "fletcher_powell": 6}
_SCALARS = {"rosenbrock": 0, "ackley": 2, "fletcher_powell": 0}


def lanes_for(csize: int) -> int:
    """The lane instantiation for ``csize`` columns: the smallest that holds
    them, or the widest, whose sub-cells then split the chunk."""
    return next((c for c in LANES if c >= csize), LANES[-1])


def sub_cells(n: int, csize: int, symmetric: bool):
    """The kernel's work list, (rows, starts) int32 numpy: the cells of
    ``chunk_pairs(n, csize, symmetric)``, each chunk wider than ``LANES[-1]``
    split into sub-cells of at most that many columns starting at
    cstart, cstart + 64, ...; sub-cells that start at or past n (all
    columns masked) are left out.  For csize <= 64 it is the cell list."""
    pairs = chunk_pairs(n, csize, symmetric)
    step = LANES[-1]
    offs = np.arange(0, csize, step, dtype=np.int32)
    starts = pairs[:, 1:2] + offs
    keep = starts < n
    rows = np.broadcast_to(pairs[:, :1], starts.shape)
    return rows[keep], starts[keep]


def _round4(x: int) -> int:
    return (x + 3) & ~3


def _slot_floats(device_fn: str, n: int) -> int:
    """Shared floats of one instance: the form's rows at the odd stride
    n | 1, then its scalars; an odd count, so that the same coordinate of
    consecutive instances falls in distinct banks (``slot_floats``)."""
    return (_ROWS[device_fn] * (n | 1) + _SCALARS[device_fn]) | 1


def _group_lanes(lanes: int) -> int:
    """Lanes per Fletcher-Powell cell (``group_lanes``): a thread up to 4
    lanes, a half warp at 8, a warp above."""
    return 1 if lanes <= 4 else 16 if lanes <= 8 else 32


def _table_floats(lanes: int) -> int:
    """Shared floats of one Fletcher-Powell warp's tangent tables: for
    each group of lanes, 2(C+1) hDuals of 2C+2 floats, each padded to 16
    bytes; none when a thread holds its tangents in registers."""
    G = _group_lanes(lanes)
    return 0 if G == 1 else 32 // G * 2 * (lanes + 1) * _round4(2 * lanes + 2)


def launch_config(device_fn: str, n: int, lanes: int):
    """(warps, staged) of a launch.  Fletcher-Powell runs as many warps (at
    most ``WARPS``) as leave room for their tangent tables beside one
    instance, and stages its A^T and B^T in shared memory when they fit
    beside those.  The other forms run ``THREADS`` threads and stage no
    matrix."""
    if device_fn != "fletcher_powell":
        return THREADS // 32, False
    room = SMEM_MAX // 4 - _round4(_slot_floats(device_fn, n))
    table = _table_floats(lanes)
    warps = min(WARPS, room // table) if table else WARPS
    staged = _round4(2 * n * (n | 1)) + warps * table <= room
    return warps, staged


def shared_bytes(device_fn: str, n: int, ipb: int, lanes: int) -> int:
    """Dynamic shared memory of one CTA of ``ipb`` instances at ``lanes``
    lanes: the staged matrices, the instance slots and the warps' tangent
    tables (the source's ``shared_bytes``, which refuses a launch whose
    count differs)."""
    warps, staged = launch_config(device_fn, n, lanes)
    floats = _round4(ipb * _slot_floats(device_fn, n))
    if device_fn == "fletcher_powell":
        floats += warps * _table_floats(lanes)
        floats += _round4(2 * n * (n | 1)) if staged else 0
    return 4 * floats


def supports(device_fn: str, n: int, csize: int) -> bool:
    """Whether one CTA can take an instance of n variables at csize."""
    lanes = lanes_for(csize)
    return (launch_config(device_fn, n, lanes)[0] >= 1
            and shared_bytes(device_fn, n, 1, lanes) <= SMEM_MAX)


def max_n(device_fn: str, csize: int) -> int:
    """The largest n the kernel takes at csize (``supports`` is monotone
    in n)."""
    lo, hi = 1, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if supports(device_fn, mid, csize) else (lo,
                                                                    mid - 1)
    return lo


def _workers(device_fn: str, lanes: int, n: int) -> int:
    """What strides over a CTA's (instance, cell) items: its threads, or
    Fletcher-Powell's groups of lanes."""
    if device_fn == "fletcher_powell":
        warps = launch_config(device_fn, n, lanes)[0]
        return warps * 32 // _group_lanes(lanes)
    return THREADS


def _max_ipb(device_fn: str, lanes: int) -> int:
    """The most instances a CTA takes: 32, one per lane of a warp, where a
    thread runs a cell; 4 for Fletcher-Powell's lane groups, which stage
    the matrices for a few instances at a time."""
    if device_fn == "fletcher_powell" and _group_lanes(lanes) > 1:
        return 4
    return 32


def _instances_per_block(P: int, n: int, device_fn: str, lanes: int) -> int:
    """Instances per CTA: at least four strides of work for every worker,
    as little idle tail as possible, then as many as the form takes
    (``_max_ipb``), inside the shared-memory budget."""
    fit = [q for q in range(1, _max_ipb(device_fn, lanes) + 1)
           if shared_bytes(device_fn, n, q, lanes) <= SMEM_MAX]
    if not fit or not supports(device_fn, n, lanes):
        raise ValueError(f"n={n} needs more shared memory per instance than "
                         f"a CTA has ({SMEM_MAX} bytes) for {device_fn} at "
                         f"{lanes} lanes; the largest n is "
                         f"{max_n(device_fn, lanes)}")
    workers = _workers(device_fn, lanes, n)
    lo = min(fit[-1], max(1, -(-4 * workers // P)))

    def idle(q):
        items = q * P
        return (-(-items // workers) * workers - items) / items

    return min(range(lo, fit[-1] + 1), key=lambda q: (idle(q), -q))


def kernel_grid(m: int, n: int, csize: int, symmetric: bool,
                device_fn: str):
    """Launch shape (CTAs, cells per instance).  The cell count is exactly
    the number of tangent sweeps per instance, ``num_chunk_evals``: the
    symmetric schedule enumerates only at-or-right-of-diagonal cells.  The
    CTA count follows from the sub-cell work list (``sub_cells``), which is
    the cell list for csize <= 64."""
    P = num_chunk_evals(n, csize, symmetric)
    ipb = _instances_per_block(len(sub_cells(n, csize, symmetric)[0]), n,
                               device_fn, lanes_for(csize))
    return (-(-m // ipb), P)


def cell_operations(device_fn: str, n: int, lanes: int) -> int:
    """fp32 operations (FMA = 2) that one cell of the device form needs at
    ``lanes`` lanes, counted from the hdual.cuh operators: add 2C+2, constant
    scale 2C+2, product 10C+4, unary map 4C+2; 3C for the cell's scatter.
    Transcendentals of the per-instance tables are not counted.

    Fletcher-Powell is charged n sin and n cos maps per cell, once per
    coordinate.  This is the first kernel's dense count: every lane of every
    coordinate's hDual, most of them structural zeros of the one-hot seeds.
    The kernel is held to ``needed_cell_operations``."""
    C = lanes
    if device_fn == "rosenbrock":
        cell = (n - 1) * (38 * C + 21)
    elif device_fn == "ackley":
        cell = n * (20 * C + 12) + 24 * C + 20
    elif device_fn == "fletcher_powell":
        cell = (n * 2 * (4 * C + 2) + n * n * 2 * (4 * C + 4)
                + n * (14 * C + 9))
    else:
        raise ValueError(f"no device form {device_fn!r}")
    return cell + 3 * C


def work(device_fn: str, m: int, n: int, csize: int, symmetric: bool,
         itemsize: int = 4):
    """(operations, bytes) of one launch: every cell's arithmetic at the
    csize lanes the schedule needs (no padding lanes, no sub-cell's repeated
    val/di), and A, V (``itemsize`` bytes each), the float32 constants and
    the int32 work list read once, the output written once."""
    P = num_chunk_evals(n, csize, symmetric)
    ops = m * P * cell_operations(device_fn, n, csize)
    consts = 2 * n * n + n if device_fn == "fletcher_powell" else 0
    items = len(sub_cells(n, csize, symmetric)[0])
    nbytes = itemsize * 3 * m * n + 4 * (consts + 2 * items)
    return ops, nbytes


def needed_cell_operations(device_fn: str, n: int, lanes: int, i: int,
                           cstart: int) -> int:
    """fp32 operations (FMA = 2) of one cell (row i, columns cstart..
    cstart+lanes-1 below n) when hDuals are carried only by its active
    coordinates S = {i} and those columns, s = |S|, the rest entering as
    primal constants; the operator costs of ``cell_operations``.

    fletcher_powell  s 2(4C+2) + n (s 2(4C+4) + (10C+4) + (2C+2)) + 3C
    ackley           s (20C+12) + 24C+20 + 3C
    rosenbrock       |{k < n-1 : k in S or k+1 in S}| (38C+21) + 3C

    The per-instance primal sums are counted by ``needed_work``."""
    C = lanes
    S = set(range(cstart, min(cstart + lanes, n))) | {i}
    s = len(S)
    if device_fn == "fletcher_powell":
        cell = (s * 2 * (4 * C + 2)
                + n * (s * 2 * (4 * C + 4) + (10 * C + 4) + (2 * C + 2)))
    elif device_fn == "ackley":
        cell = s * (20 * C + 12) + 24 * C + 20
    elif device_fn == "rosenbrock":
        terms = sum(1 for k in range(n - 1) if k in S or k + 1 in S)
        cell = terms * (38 * C + 21)
    else:
        raise ValueError(f"no device form {device_fn!r}")
    return cell + 3 * C


def needed_work(device_fn: str, m: int, n: int, csize: int, symmetric: bool,
                itemsize: int = 4):
    """(operations, bytes) of one launch counted as the active coordinates
    need them: ``needed_cell_operations`` over the cells of ``chunk_pairs``,
    plus once per instance the primal sums (Fletcher-Powell 4n^2 + n for
    its residuals, Ackley 4n for its two sums).  The bytes are ``work``'s.

    A cell is counted at csize lanes.  A chunk wider than ``LANES[-1]`` is
    counted as the kernel runs it, sub-cell by sub-cell (``sub_cells``):
    each at the width of its own columns, with S = {i} and those columns,
    so that the count never exceeds the kernel's work."""
    step = LANES[-1]
    cells = sum(needed_cell_operations(device_fn, n, min(step, csize - off),
                                       int(i), int(c) + off)
                for i, c in chunk_pairs(n, csize, symmetric)
                for off in range(0, csize, step) if c + off < n)
    per_instance = {"fletcher_powell": 4 * n * n + n, "ackley": 4 * n,
                    "rosenbrock": 0}[device_fn]
    return (m * (cells + per_instance),
            work(device_fn, m, n, csize, symmetric, itemsize)[1])


def chess_hvp_plain(kf, A, V, csize: int, consts=(), symmetric: bool = False):
    """The kernel's function in plain PyTorch: every (cell, instance) pair is
    one batch element of a single evaluation of the kernel form
    ``kf(y, *consts)``, then the direct and (symmetric) mirrored terms are
    scattered into the output rows.  16-bit A and V are computed in float32
    and the result returned in ``A.dtype``, as the Pallas body does."""
    fn = (lambda y: kf(y, *consts)) if consts else kf
    dtype = A.dtype
    if dtype in (torch.bfloat16, torch.float16):
        A, V = A.float(), V.float()
    return _l2_impl(fn, A, V, csize, symmetric, None).to(dtype)


_CELLS: dict = {}


def _cell_list(n, csize, symmetric, device):
    key = (n, csize, bool(symmetric), device)
    if key not in _CELLS:
        _CELLS[key] = tuple(torch.from_numpy(a).to(device)
                            for a in sub_cells(n, csize, symmetric))
    return _CELLS[key]


_LIB = None


def _launcher():
    global _LIB
    if _LIB is None:
        # first launch: one thread builds and loads, the rest wait on the
        # lock; the argtypes are set before the library is published
        with build.LOCK:
            if _LIB is None:
                lib = build.load("chess_hvp")
                p, i = ctypes.c_void_p, ctypes.c_int
                lib.chess_hvp_launch.argtypes = [
                    p, p, p, i, p, p, i, i, i, i, i, i, i, i, i, i,
                    ctypes.c_longlong, p, p, p, p]
                lib.chess_hvp_launch.restype = ctypes.c_int
                _LIB = lib
    return _LIB.chess_hvp_launch


def _check(A, V, csize):
    if not (isinstance(A, torch.Tensor) and isinstance(V, torch.Tensor)):
        raise TypeError("chess_hvp: A and V must be tensors")
    if A.dim() != 2 or A.shape != V.shape or A.shape[0] < 1:
        raise ValueError(f"chess_hvp: A and V must both be (m, n) with m >= 1;"
                         f" got {tuple(A.shape)} and {tuple(V.shape)}")
    if A.dtype not in build.DTYPE_CODES or V.dtype != A.dtype:
        raise TypeError(f"chess_hvp: A and V must share one of "
                        f"{sorted(map(str, build.DTYPE_CODES))}; got "
                        f"{A.dtype}, {V.dtype}")
    if A.device != V.device:
        raise ValueError(f"chess_hvp: A on {A.device}, V on {V.device}")
    if csize < 1:
        raise ValueError(f"csize={csize} must be >= 1")


def _launch(A, V, out, rows, starts, csize, symmetric, device_fn, cptr):
    """Launch the kernel on the (rows, starts) work list at the wrapper's
    configuration, on the current stream; returns the C entry's CUDA error
    code (0 on success).  Checks nothing: ``chess_hvp_cuda`` does."""
    n = A.shape[1]
    lanes = lanes_for(csize)
    P = rows.shape[0]                  # sub-cells per instance
    ipb = _instances_per_block(P, n, device_fn, lanes)
    warps, staged = launch_config(device_fn, n, lanes)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        return _launcher()(
            A.data_ptr(), V.data_ptr(), out.data_ptr(),
            build.DTYPE_CODES[A.dtype], rows.data_ptr(), starts.data_ptr(),
            P, A.shape[0], n, csize, lanes, int(bool(symmetric)),
            DEVICE_FNS[device_fn], ipb, warps, int(staged),
            shared_bytes(device_fn, n, ipb, lanes), *cptr, stream)


def chess_hvp_cuda(kf, A, V, csize: int, *, consts=(), device_fn=None,
                   symmetric: bool = False):
    """Batched HVP out[m] = H_f(A[m]) @ V[m] on the L2 cell schedule.

    kf, consts : the kernel form of f and its constant tensors (used by the
                 plain version on CPU tensors)
    device_fn  : the name of f's CUDA device form (``DEVICE_FNS``)

    A, V: (m, n), both float32, bfloat16 or float16; the result is in
    A.dtype, computed in float32.  Any m >= 1, any csize >= 1 (ragged tails
    masked on col < n; chunks wider than 64 columns run as sub-cells).
    CUDA tensors launch the kernel on the current stream; CPU tensors take
    the plain version."""
    _check(A, V, csize)
    if A.device.type == "cpu":
        return chess_hvp_plain(kf, A, V, csize, consts, symmetric)
    if A.device.type != "cuda":
        raise ValueError(f"chess_hvp: unsupported device {A.device}")
    if device_fn not in DEVICE_FNS:
        raise ValueError(f"chess_hvp: no CUDA device form {device_fn!r}; "
                         f"known: {sorted(DEVICE_FNS)}")
    if not (A.is_contiguous() and V.is_contiguous()):
        raise ValueError("chess_hvp: A and V must be contiguous")
    m, n = A.shape
    if not supports(device_fn, n, csize):
        raise ValueError(f"chess_hvp: n={n} is past the kernel's "
                         f"{max_n(device_fn, csize)} for {device_fn} at "
                         f"csize={csize} (shared memory)")
    if device_fn == "fletcher_powell":
        cA, cB, cE = consts
        for c, shape in ((cA, (n, n)), (cB, (n, n)), (cE, (n,))):
            if (c.device != A.device or c.dtype != torch.float32
                    or tuple(c.shape) != shape or not c.is_contiguous()):
                raise ValueError(
                    "chess_hvp: Fletcher-Powell constants must be contiguous "
                    f"float32 (n, n), (n, n), (n,) on {A.device}")
        # the kernel reads columns of A and B: pass them transposed
        mats = (cA.t().contiguous(), cB.t().contiguous(), cE)
        cptr = [c.data_ptr() for c in mats]
    else:
        cptr = [None, None, None]
    rows, starts = _cell_list(n, csize, symmetric, A.device)
    out = torch.empty_like(A)
    err = _launch(A, V, out, rows, starts, csize, symmetric, device_fn,
                  cptr)
    if err != 0:
        raise RuntimeError(f"chess_hvp: kernel launch failed with CUDA error "
                           f"{err} (m={m}, n={n}, csize={csize})")
    with _LAUNCHES_LOCK:        # dispatch workers launch concurrently
        chess_hvp_cuda.launches += 1
    return out


chess_hvp_cuda.launches = 0
_LAUNCHES_LOCK = threading.Lock()
