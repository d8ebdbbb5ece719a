"""chess_hvp: the paper's L2 kernel (Fig. 2), hand-written in CUDA C++ for
Hopper, with its plain PyTorch version.

Counterpart of ``repro.kernels.chess_hvp`` (``chess_hvp_pallas``).  The
kernel (``csrc/chess_hvp.cu``, header ``csrc/hdual.cuh``) computes
``out[m] = H_f(A[m]) @ V[m]`` over the flattened cell list of
``core.api.chunk_pairs(n, csize, symmetric)``: one CTA owns a few instances,
its threads stride over (instance, cell) pairs, each thread evaluates f on
one cell with the hDual in registers, and the direct and mirrored terms meet
in a shared-memory output row (see the note at the top of the source).

* ``chess_hvp_cuda`` is the wrapper.  On a CUDA tensor it launches the
  kernel (building it at first use, ``kernels/build.py``) and counts the
  launch in ``chess_hvp_cuda.launches``; on a CPU tensor it returns the plain
  version; anything else raises.  There is no fallback from the kernel.
* ``chess_hvp_plain`` is the same function in plain PyTorch, batched over
  cells and instances as in the Pallas body.

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

import numpy as np
import torch

from repro_torch.core.api import _l2_impl, chunk_pairs, num_chunk_evals

from . import build

__all__ = ["chess_hvp_cuda", "chess_hvp_plain", "kernel_grid", "DEVICE_FNS",
           "LANES", "lanes_for", "sub_cells", "cell_operations", "work"]

THREADS = 256                      # threads per CTA (kThreads in the source)
LANES = (1, 2, 4, 8, 16, 32, 64)   # the hDual<C> instantiations
DEVICE_FNS = {"rosenbrock": 0, "ackley": 1, "fletcher_powell": 2}
_SMEM_LIMIT = 48 * 1024            # default dynamic shared memory per CTA
_SLOT_BYTES = 5 * 4                # a, v, out and a 2-entry table per variable
_MAX_IPB = 32


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


def _instances_per_block(P: int, n: int) -> int:
    """Instances per CTA: at least four strides of work for every thread,
    as little idle tail as possible, inside the shared-memory budget."""
    cap = min(_MAX_IPB, _SMEM_LIMIT // (_SLOT_BYTES * n))
    if cap < 1:
        raise ValueError(f"n={n} needs more shared memory per instance than "
                         f"a CTA has ({_SMEM_LIMIT} bytes)")
    lo = min(cap, max(1, -(-4 * THREADS // P)))

    def idle(q):
        items = q * P
        return (-(-items // THREADS) * THREADS - items) / items

    return min(range(lo, cap + 1), key=lambda q: (idle(q), q))


def kernel_grid(m: int, n: int, csize: int, symmetric: bool):
    """Launch shape (CTAs, cells per instance).  The cell count is exactly
    the number of tangent sweeps per instance, ``num_chunk_evals``: the
    symmetric schedule enumerates only at-or-right-of-diagonal cells.  The
    CTA count follows from the sub-cell work list (``sub_cells``), which is
    the cell list for csize <= 64."""
    P = num_chunk_evals(n, csize, symmetric)
    ipb = _instances_per_block(len(sub_cells(n, csize, symmetric)[0]), n)
    return (-(-m // ipb), P)


def cell_operations(device_fn: str, n: int, lanes: int) -> int:
    """fp32 operations (FMA = 2) that one cell of the device form needs at
    ``lanes`` lanes, counted from the hdual.cuh operators: add 2C+2, constant
    scale 2C+2, product 10C+4, unary map 4C+2; 3C for the cell's scatter.
    Transcendentals of the per-instance tables are not counted.

    Fletcher-Powell is charged n sin and n cos maps per cell, once per
    coordinate.  The kernel evaluates them once per output row, n^2 of each,
    which is extra work of its design and not part of this count."""
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
        lib = build.load("chess_hvp")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.chess_hvp_launch.argtypes = [p, p, p, i, p, p, i, i, i, i, i, i,
                                         i, i, p, p, p, p]
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
    lanes = lanes_for(csize)
    if device_fn == "fletcher_powell":
        cA, cB, cE = consts
        for c, shape in ((cA, (n, n)), (cB, (n, n)), (cE, (n,))):
            if (c.device != A.device or c.dtype != torch.float32
                    or tuple(c.shape) != shape or not c.is_contiguous()):
                raise ValueError(
                    "chess_hvp: Fletcher-Powell constants must be contiguous "
                    f"float32 (n, n), (n, n), (n,) on {A.device}")
        cptr = [c.data_ptr() for c in (cA, cB, cE)]
    else:
        cptr = [None, None, None]
    rows, starts = _cell_list(n, csize, symmetric, A.device)
    P = rows.shape[0]                  # sub-cells per instance
    ipb = _instances_per_block(P, n)
    out = torch.empty_like(A)
    launch = _launcher()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = launch(A.data_ptr(), V.data_ptr(), out.data_ptr(),
                     build.DTYPE_CODES[A.dtype], rows.data_ptr(),
                     starts.data_ptr(), P, m, n, csize, lanes,
                     int(bool(symmetric)), DEVICE_FNS[device_fn], ipb, *cptr,
                     stream)
    if err != 0:
        raise RuntimeError(f"chess_hvp: kernel launch failed with CUDA error "
                           f"{err} (m={m}, n={n}, csize={csize})")
    chess_hvp_cuda.launches += 1
    return out


chess_hvp_cuda.launches = 0
