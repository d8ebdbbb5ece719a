"""chess_hvp: the paper's L2 kernel (Fig. 2), hand-written in CUDA C++ for
Hopper, with its plain PyTorch version.

Counterpart of ``repro.kernels.chess_hvp`` (``chess_hvp_pallas``).  The
kernel (template ``csrc/chess_hvp.cuh``, header ``csrc/hdual.cuh``)
computes ``out[m] = H_f(A[m]) @ V[m]`` over the flattened cell list of
``core.api.chunk_pairs(n, csize, symmetric)``: one CTA owns a few
instances, a per-instance pass fills each instance's shared slot, each cell
evaluates f's device form on its seeds, and the direct and mirrored terms
meet in a shared-memory output row (see the note at the top of the
template).

* ``chess_hvp_cuda`` is the wrapper.  On a CUDA tensor it launches the
  kernel (building it at first use, ``kernels/build.py``) and counts the
  launch in ``chess_hvp_cuda.launches``; on a CPU tensor it returns the plain
  version; anything else raises.  There is no fallback from the kernel.
* ``chess_hvp_plain`` is the same function in plain PyTorch, batched over
  cells and instances as in the Pallas body.
* ``shared_bytes`` is a launch's shared memory; ``supports``/``max_n`` say
  which n one CTA can take, and the engine's ``cuda`` backend vetoes the rest.
* ``instance_blocks`` lists the instances per CTA a caller may pick
  (``ipb``): the engine's tuner sweeps them as the ``cuda`` backend's
  ``blk_m``.  Left out, the wrapper picks them from the cell count
  (``_instances_per_block``).
* ``work`` is the first kernel's dense operation count (every lane of every
  coordinate's hDual; a generated form's, what its code runs);
  ``needed_work`` counts the hDual work of the active coordinates only, the
  bound the kernel is held to (a generated form's, what the seeds'
  structural zeros leave).

The kernel evaluates f through a device form.  Its route, the ``cuda``
backend's for every f, is the form generated from a trace of f
(``device_fn=None``), as the Pallas kernel evaluates f itself in its body
(``kernels/trace.py``, ``kernels/codegen.py``; built at first launch per
(f, n) under ``build/repro_torch_kernels/``).  The generated form is the
structural evaluation of the traced graph: an instance pass stores the
values no seed reaches in the instance's shared slot (its ``rows`` and
``scalars``, which ``shared_bytes``, ``max_n`` and the instances per CTA
read), and each cell loops over its seeds' support only; its launches
count also in ``chess_hvp_cuda.traced_launches``.  The three test
functions also have forms written by hand in CUDA (``device_fn``, one of
``DEVICE_FNS``), which only an explicit ``device_fn=`` reaches.  Every
function above takes a ``TracedForm`` where it takes a device form's name;
a traced form serves its own n only and holds its cell's arrays in local
memory (at most ``LOCAL_MAX`` bytes a thread).  Like the
Pallas kernel, the kernel takes A and V in float32, bfloat16 or float16,
computes in float32 and returns ``A.dtype``, and serves any ``csize >= 1``:
a chunk wider than the widest lane instantiation runs as several sub-cells
(``sub_cells``).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from repro_torch.core.api import _l2_impl, chunk_pairs, num_chunk_evals

from . import build, codegen, trace

__all__ = ["chess_hvp_cuda", "chess_hvp_plain", "kernel_grid", "DEVICE_FNS",
           "LANES", "lanes_for", "sub_cells", "cell_operations", "work",
           "launch_config", "shared_bytes", "supports", "max_n",
           "needed_cell_operations", "needed_work", "instance_blocks",
           "is_instance_block", "LOCAL_MAX"]

THREADS = 256                      # threads per CTA (kThreads in the source)
WARPS = 8                          # Fletcher-Powell warps per CTA, at most
LANES = codegen.LANES              # the hDual<C> instantiations
lanes_for = codegen.lanes_for
DEVICE_FNS = {"rosenbrock": 0, "ackley": 1, "fletcher_powell": 2}
SMEM_MAX = 232448                  # opt-in shared memory per CTA on sm_90
SMEM_SM = 233472                   # shared memory per SM on sm_90 (228 KB)
LOCAL_MAX = codegen.LOCAL_MAX      # local bytes a thread of a traced form


class HandForm:
    """A device form written by hand in ``csrc/chess_hvp.cu``, with the
    interface the functions below read of every form (``trace.TracedForm``
    for a generated one): ``code``, the C entry's ``fn``; the ``rows`` of
    n|1 floats (a, v, out and its primal tables) and the ``scalars`` of an
    instance slot; ``grouped``, Fletcher-Powell's warps of lane groups and
    staged matrices; ``n`` None: it serves every n shared memory takes."""

    n = None
    traced = False

    def __init__(self, name: str, rows: int, scalars: int):
        self.name, self.rows, self.scalars = name, rows, scalars
        self.code = DEVICE_FNS[name]
        self.grouped = name == "fletcher_powell"

    def __repr__(self):
        return self.name

    def local_bytes(self, lanes: int) -> int:
        return 0

    def refusal(self, n: int, lanes: int):
        return None               # its only limit is shared memory's

    def cell_operations(self, n: int, C: int) -> int:
        if self.name == "rosenbrock":
            cell = (n - 1) * (38 * C + 21)
        elif self.name == "ackley":
            cell = n * (20 * C + 12) + 24 * C + 20
        else:
            cell = (n * 2 * (4 * C + 2) + n * n * 2 * (4 * C + 4)
                    + n * (14 * C + 9))
        return cell + 3 * C

    def operations(self, m: int, n: int, csize: int, symmetric: bool) -> int:
        return (m * num_chunk_evals(n, csize, symmetric)
                * self.cell_operations(n, csize))

    def needed_cell_operations(self, n: int, C: int, i: int,
                               cstart: int) -> int:
        S = set(range(cstart, min(cstart + C, n))) | {i}
        s = len(S)
        if self.grouped:
            cell = (s * 2 * (4 * C + 2)
                    + n * (s * 2 * (4 * C + 4) + (10 * C + 4) + (2 * C + 2)))
        elif self.name == "ackley":
            cell = s * (20 * C + 12) + 24 * C + 20
        else:
            terms = sum(1 for k in range(n - 1) if k in S or k + 1 in S)
            cell = terms * (38 * C + 21)
        return cell + 3 * C

    def needed_operations(self, m: int, n: int, csize: int,
                          symmetric: bool) -> int:
        step = LANES[-1]
        cells = sum(self.needed_cell_operations(n, min(step, csize - off),
                                                int(i), int(c) + off)
                    for i, c in chunk_pairs(n, csize, symmetric)
                    for off in range(0, csize, step) if c + off < n)
        per_instance = {"fletcher_powell": 4 * n * n + n, "ackley": 4 * n,
                        "rosenbrock": 0}[self.name]
        return m * (cells + per_instance)

    def const_floats(self, n: int) -> int:
        return 2 * n * n + n if self.grouped else 0

    def arguments(self, consts, device, n: int) -> list:
        """The launch's constant tensors: Fletcher-Powell's A and B
        transposed (the kernel reads their columns) and E; none else."""
        if not self.grouped:
            return [None, None, None]
        cA, cB, cE = consts
        for c, shape in ((cA, (n, n)), (cB, (n, n)), (cE, (n,))):
            if (c.device != device or c.dtype != torch.float32
                    or tuple(c.shape) != shape or not c.is_contiguous()):
                raise ValueError(
                    "chess_hvp: Fletcher-Powell constants must be contiguous "
                    f"float32 (n, n), (n, n), (n,) on {device}")
        return [cA.t().contiguous(), cB.t().contiguous(), cE]

    def launcher(self):
        return _launcher()


_HAND = {name: HandForm(name, rows, scalars) for name, rows, scalars in (
    ("rosenbrock", 3, 0), ("ackley", 5, 2), ("fletcher_powell", 6, 0))}


def _form(device_fn):
    """The form object of a hand-written form's name, or the form given."""
    if isinstance(device_fn, str):
        try:
            return _HAND[device_fn]
        except KeyError:
            raise ValueError(f"chess_hvp: no CUDA device form {device_fn!r}; "
                             f"known: {sorted(DEVICE_FNS)}") from None
    return device_fn


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


def _slot_floats(device_fn, n: int) -> int:
    """Shared floats of one instance: the form's rows at the odd stride
    n | 1, then its scalars; an odd count, so that the same coordinate of
    consecutive instances falls in distinct banks (``slot_floats``)."""
    form = _form(device_fn)
    return (form.rows * (n | 1) + form.scalars) | 1


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
    if not _form(device_fn).grouped:
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
    if _form(device_fn).grouped:
        floats += warps * _table_floats(lanes)
        floats += _round4(2 * n * (n | 1)) if staged else 0
    return 4 * floats


def supports(device_fn, n: int, csize: int) -> bool:
    """Whether one CTA can take an instance of n variables at csize; a
    traced form, only at its own n and within ``LOCAL_MAX`` bytes of local
    memory a thread at csize's lanes."""
    lanes = lanes_for(csize)
    if _form(device_fn).refusal(n, lanes) is not None:
        return False
    return (launch_config(device_fn, n, lanes)[0] >= 1
            and shared_bytes(device_fn, n, 1, lanes) <= SMEM_MAX)


def max_n(device_fn, csize: int) -> int:
    """The largest n the kernel takes at csize (``supports`` is monotone
    in n); a traced form's own n where it fits, else 0."""
    own = _form(device_fn).n
    if own is not None:
        return own if supports(device_fn, own, csize) else 0
    lo, hi = 1, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if supports(device_fn, mid, csize) else (lo,
                                                                    mid - 1)
    return lo


def _workers(device_fn: str, lanes: int, n: int) -> int:
    """What strides over a CTA's (instance, cell) items: its threads, or
    Fletcher-Powell's groups of lanes."""
    if _form(device_fn).grouped:
        warps = launch_config(device_fn, n, lanes)[0]
        return warps * 32 // _group_lanes(lanes)
    return THREADS


def _max_ipb(device_fn: str, lanes: int) -> int:
    """The most instances a CTA takes: 32, one per lane of a warp, where a
    thread runs a cell; 4 for Fletcher-Powell's lane groups, which stage
    the matrices for a few instances at a time."""
    if _form(device_fn).grouped and _group_lanes(lanes) > 1:
        return 4
    return 32


def _budget(device_fn, ipb: int) -> int:
    """Shared bytes a CTA of ``ipb`` instances may take: ``SMEM_MAX``; a
    generated form's, past its first instance, the share of which two CTAs
    fit an SM (each CTA reserves 1 KB).  Its slot holds what its instance
    pass stores, and one CTA an SM leaves 8 warps to hide the latency of
    the cells' constant reads (the CPU tests' all-ops function at n = 64:
    57.4 ms at 24 instances, 40.8 ms at 8)."""
    if ipb > 1 and _form(device_fn).traced:
        return SMEM_SM // 2 - 1024
    return SMEM_MAX


@functools.lru_cache(maxsize=1024)
def _fit(n: int, device_fn, lanes: int) -> tuple:
    """The instances per CTA a launch can take: 1 to ``_max_ipb`` whose
    ``shared_bytes`` fit ``_budget``; raises where not even one does.  The
    one rule behind the wrapper's default and the tuner's list.  Memoized:
    every launch with an explicit ``ipb`` checks it here."""
    fit = tuple(q for q in range(1, _max_ipb(device_fn, lanes) + 1)
                if shared_bytes(device_fn, n, q, lanes)
                <= _budget(device_fn, q))
    if not fit or not supports(device_fn, n, lanes):
        why = _form(device_fn).refusal(n, lanes)
        if why is not None:
            raise ValueError(f"chess_hvp: {why}")
        raise ValueError(f"n={n} needs more shared memory per instance than "
                         f"a CTA has ({SMEM_MAX} bytes) for {device_fn} at "
                         f"{lanes} lanes; the largest n is "
                         f"{max_n(device_fn, lanes)}")
    return fit


def instance_blocks(device_fn, n: int, csize: int) -> list:
    """The sweepable instances per CTA at (n, csize): the powers of two in
    ``_fit``, and its top (the most the wrapper picks) -- the ``cuda``
    backend's ``blk_m`` dial, for a hand-written form and a generated one
    alike.  Empty where one CTA cannot take an instance (past ``max_n``, or
    a form's refusal)."""
    lanes = lanes_for(csize)
    if not supports(device_fn, n, csize):
        return []
    fit = _fit(n, device_fn, lanes)
    return [q for q in fit if q & (q - 1) == 0 or q == fit[-1]]


def _instances_per_block(P: int, n: int, device_fn, lanes: int) -> int:
    """Instances per CTA: at least four strides of work for every worker,
    as little idle tail as possible, then as many as the form takes, inside
    ``_fit``.  Of ``chip_smoke.py`` phase 18's generated forms the half-SM
    budget binds the all-ops function's only (a 33-row slot: 8 and 13
    instances at csize 4 and 8); the 3- to 7-row slots keep 32."""
    fit = _fit(n, device_fn, lanes)
    workers = _workers(device_fn, lanes, n)
    lo = min(fit[-1], max(1, -(-4 * workers // P)))

    def idle(q):
        items = q * P
        return (-(-items // workers) * workers - items) / items

    return min(range(lo, fit[-1] + 1), key=lambda q: (idle(q), -q))


def is_instance_block(device_fn, n: int, csize: int, ipb) -> bool:
    """Whether ``ipb`` is one of ``instance_blocks(device_fn, n, csize)``:
    the one definition of an explicit instances per CTA, which the wrapper,
    the ``cuda`` backend and ``plan()`` all hold a ``blk_m`` to.  A form
    that is neither a hand-written form's name nor a generated form takes
    none."""
    if device_fn is None or (isinstance(device_fn, str)
                             and device_fn not in DEVICE_FNS):
        return False
    return (isinstance(ipb, int) and not isinstance(ipb, bool)
            and ipb in instance_blocks(device_fn, n, csize))


def _check_ipb(device_fn, n: int, csize: int, ipb) -> None:
    """An explicit instances per CTA must be one of ``instance_blocks`` of
    the form (a hand-written form's name or a generated form); raises
    ValueError otherwise, before any launch."""
    _fit(n, device_fn, lanes_for(csize))      # raises past max_n
    if not is_instance_block(device_fn, n, csize, ipb):
        raise ValueError(f"chess_hvp: ipb={ipb!r} is not one of the "
                         f"instances per CTA that {device_fn} takes at "
                         f"n={n}, csize={csize}: "
                         f"{instance_blocks(device_fn, n, csize)} (powers of "
                         f"two, and the most the form takes, inside shared "
                         f"memory)")


def _ipb(P: int, n: int, csize: int, device_fn: str, ipb) -> int:
    return (_instances_per_block(P, n, device_fn, lanes_for(csize))
            if ipb is None else ipb)


def kernel_grid(m: int, n: int, csize: int, symmetric: bool,
                device_fn: str, ipb=None):
    """Launch shape (CTAs, cells per instance).  The cell count is exactly
    the number of tangent sweeps per instance, ``num_chunk_evals``: the
    symmetric schedule enumerates only at-or-right-of-diagonal cells.  The
    CTA count follows from the instances per CTA: ``ipb`` where given (one
    of ``instance_blocks``), else ``_instances_per_block`` on the sub-cell work
    list (``sub_cells``, the cell list for csize <= 64)."""
    P = num_chunk_evals(n, csize, symmetric)
    if ipb is not None:
        _check_ipb(device_fn, n, csize, ipb)
    ipb = _ipb(len(sub_cells(n, csize, symmetric)[0]), n, csize, device_fn,
               ipb)
    return (-(-m // ipb), P)


def cell_operations(device_fn, n: int, lanes: int) -> int:
    """fp32 operations (FMA = 2) that one cell of the device form needs at
    ``lanes`` lanes.  A hand-written form's are counted from the hdual.cuh
    operators: add 2C+2, constant scale 2C+2, product 10C+4, unary map
    4C+2; 3C for the cell's scatter; transcendentals of the per-instance
    tables are not counted.  Fletcher-Powell is charged n sin and n cos
    maps per cell, once per coordinate.  This is the dense count: every
    lane of every coordinate's hDual, most of them structural zeros of the
    one-hot seeds.  A traced form's: the most one cell of its code runs
    (``TracedForm.cell_operations``).  The kernel is held to
    ``needed_work``."""
    return _form(device_fn).cell_operations(n, lanes)


def work(device_fn, m: int, n: int, csize: int, symmetric: bool,
         itemsize: int = 4):
    """(operations, bytes) of one launch: every cell's dense arithmetic at
    the csize lanes the schedule needs (no padding lanes, no sub-cell's
    repeated val/di), and A, V (``itemsize`` bytes each), the float32
    constants and the int32 work list read once, the output written once.
    A traced form counts what its code runs (``TracedForm.operations``):
    each sub-cell's ``eval`` and scatter, and its instance pass once an
    instance."""
    form = _form(device_fn)
    items = len(sub_cells(n, csize, symmetric)[0])
    nbytes = itemsize * 3 * m * n + 4 * (form.const_floats(n) + 2 * items)
    return form.operations(m, n, csize, symmetric), nbytes


def needed_cell_operations(device_fn: str, n: int, lanes: int, i: int,
                           cstart: int) -> int:
    """fp32 operations (FMA = 2) of one cell (row i, columns cstart..
    cstart+lanes-1 below n) of a hand-written form when hDuals are carried
    only by its active coordinates S = {i} and those columns, s = |S|, the
    rest entering as primal constants; the operator costs of
    ``cell_operations``.

    fletcher_powell  s 2(4C+2) + n (s 2(4C+4) + (10C+4) + (2C+2)) + 3C
    ackley           s (20C+12) + 24C+20 + 3C
    rosenbrock       |{k < n-1 : k in S or k+1 in S}| (38C+21) + 3C

    The per-instance primal sums are counted by ``needed_work``."""
    return _form(device_fn).needed_cell_operations(n, lanes, i, cstart)


def needed_work(device_fn, m: int, n: int, csize: int, symmetric: bool,
                itemsize: int = 4):
    """(operations, bytes) of one launch counted as the function needs
    them, the bound the kernel is held to; the bytes are ``work``'s.

    A hand-written form: ``needed_cell_operations`` over the cells of
    ``chunk_pairs``, plus once per instance the primal sums
    (Fletcher-Powell 4n^2 + n for its residuals, Ackley 4n for its two
    sums).  A traced form: the graph's operations that the seeds'
    structural zeros leave (``codegen.needed_operations``), the work no
    seed reaches once per instance, and 3 a column for the scatter.  A
    cell is counted at its own columns; a chunk wider than ``LANES[-1]``
    sub-cell by sub-cell (``sub_cells``), each at the width of its own
    columns, so that the count never exceeds the kernel's work."""
    return (_form(device_fn).needed_operations(m, n, csize, symmetric),
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


def _launch(A, V, out, rows, starts, csize, symmetric, device_fn, cptr,
            ipb=None):
    """Launch the kernel on the (rows, starts) work list at the wrapper's
    configuration (``ipb`` instances per CTA, or ``_instances_per_block``'s
    choice), on the current stream; returns the C entry's CUDA error code
    (0 on success).  ``device_fn`` is a hand-written form's name or a form
    (cptr: the pointers of its three constant ``arguments``).
    Checks nothing: ``chess_hvp_cuda`` does."""
    n = A.shape[1]
    lanes = lanes_for(csize)
    P = rows.shape[0]                  # sub-cells per instance
    ipb = _ipb(P, n, csize, device_fn, ipb)
    form = _form(device_fn)
    warps, staged = launch_config(form, n, lanes)
    head = (A.data_ptr(), V.data_ptr(), out.data_ptr(),
            build.DTYPE_CODES[A.dtype], rows.data_ptr(), starts.data_ptr(),
            P, A.shape[0], n, csize, lanes, int(bool(symmetric)))
    smem = shared_bytes(form, n, ipb, lanes)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        return form.launcher()(*head, form.code, ipb, warps, int(staged),
                               smem, *cptr, stream)


def chess_hvp_cuda(kf, A, V, csize: int, *, consts=(), device_fn=None,
                   symmetric: bool = False, ipb=None):
    """Batched HVP out[m] = H_f(A[m]) @ V[m] on the L2 cell schedule.

    kf, consts : the kernel form of f and its constant tensors (the plain
                 version's on CPU tensors, Fletcher-Powell's hand-written
                 form's on the card; a traced form reads them, on any
                 device, at every launch: ``TracedForm.constants``)
    device_fn  : None (the ``cuda`` backend's route): the form generated
                 from a trace of ``kf(y, *consts)`` (``trace.traced_form``;
                 its refusal raises TraceRefused, a ValueError, with the
                 reason); or the name of a hand-written CUDA device form
                 (``DEVICE_FNS``), which only an explicit caller reaches
    ipb        : instances per CTA; None keeps ``_instances_per_block``'s
                 choice.  One that ``instance_blocks`` of the form does not
                 list raises ValueError before any launch, on either device
                 (a generated form is traced for the check); the plain
                 version does not use it.

    A, V: (m, n), both float32, bfloat16 or float16; the result is in
    A.dtype, computed in float32.  Any m >= 1, any csize >= 1 (ragged tails
    masked on col < n; chunks wider than 64 columns run as sub-cells).
    CUDA tensors launch the kernel on the current stream; CPU tensors take
    the plain version."""
    _check(A, V, csize)
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"chess_hvp: unsupported device {A.device}")
    m, n = A.shape
    if ipb is not None or A.device.type == "cuda":
        form = _form(trace.traced_form(kf, consts, n) if device_fn is None
                     else device_fn)
        if ipb is not None:
            _check_ipb(form, n, csize, ipb)
    if A.device.type == "cpu":
        return chess_hvp_plain(kf, A, V, csize, consts, symmetric)
    if not (A.is_contiguous() and V.is_contiguous()):
        raise ValueError("chess_hvp: A and V must be contiguous")
    if not supports(form, n, csize):
        raise ValueError("chess_hvp: " + (
            form.refusal(n, lanes_for(csize))
            or f"n={n} is past the kernel's {max_n(form, csize)} for {form} "
               f"at csize={csize} (shared memory)"))
    args = form.arguments(consts, A.device, n)
    cptr = [None if t is None else t.data_ptr() for t in args]
    rows, starts = _cell_list(n, csize, symmetric, A.device)
    out = torch.empty_like(A)
    err = _launch(A, V, out, rows, starts, csize, symmetric, form, cptr, ipb)
    if err != 0:
        raise RuntimeError(f"chess_hvp: kernel launch failed with CUDA error "
                           f"{err} ({form}, m={m}, n={n}, "
                           f"csize={csize})")
    with _LAUNCHES_LOCK:        # dispatch workers launch concurrently
        chess_hvp_cuda.launches += 1
        chess_hvp_cuda.traced_launches += form.traced
    return out


chess_hvp_cuda.launches = 0
chess_hvp_cuda.traced_launches = 0      # of them, on generated forms
_LAUNCHES_LOCK = threading.Lock()
