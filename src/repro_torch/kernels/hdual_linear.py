"""hdual_linear: the fused hDual linear map Y[k] = X[k] @ W over every hDual
component, hand-written in CUDA C++ for Hopper, with its plain PyTorch
versions.

Counterpart of ``repro.kernels.hdual_linear`` (``hdual_linear_pallas``).  A
linear map acts on every hDual component alone, so pushing an hDual through
it is K2 = 2c+2 products against the same W.  The kernel
(``csrc/hdual_linear.cu``) folds the components into the rows of one GEMM,
so each W tile it stages is contracted against every component row (see the
note at the top of the source).

Operand groups.  The kernel reads up to four groups, each ``ncomp``
components of ``npoints`` rows at any strides (``Group``): the stacked
(K2, T, din) of ``hdual_linear`` is one group of K2 components, and
``hdual_linear_apply`` passes an HDual's val, di (T, din) and dj, dij
(T, din, c) as four groups read where they lie, and writes its four outputs
in the same layout, with no stacking copy.

Two variants, chosen by ``choose_variant``, a pure function of the shapes,
the dtype, the strides and the pointers' alignment:

* ``"wgmma"``: tensor cores through TMA (bfloat16/float16 directly, float32
  as 3xTF32), for groups whose components are interleaved per point (or
  stacked contiguously), din a multiple of 128 bytes and dout of 8, every
  pointer 16-byte aligned.
* ``"simt"``: float32 FFMA on the CUDA cores, for any strides and shapes.

``hdual_linear_cuda`` and ``hdual_linear_apply_cuda`` are the wrappers.  They
check their arguments and the reference's tiles on any device; on CUDA
tensors they launch a variant (building the library at first use,
``kernels/build.py``) and count it in ``hdual_linear_cuda.launches`` and
``hdual_linear_cuda.launches_by_variant``; on CPU tensors they take the plain
version ``groups_plain``, which reads and writes the same group descriptors
through ``torch.as_strided``; anything else raises.  There is no fallback
from a kernel.  ``hdual_linear_plain`` is the reference's function in plain
PyTorch; ``split_tf32`` is the 3xTF32 split the float32 kernel makes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.hdual import HDual

from . import build

__all__ = ["Group", "VARIANTS", "choose_variant", "groups_plain",
           "hdual_linear_apply_cuda", "hdual_linear_cuda",
           "hdual_linear_plain", "split_tf32", "stacked_group", "tc_form",
           "work"]

# the kernel's variants, by the code the C entry point takes
VARIANTS = {"simt": 0, "wgmma": 1}
TC_ROW_BYTES = 128       # the wgmma variant's depth per stage, in bytes
TC_ROWS = 128            # rows of a wgmma tile: at most 128 components a point


def work(K2: int, T: int, din: int, dout: int, itemsize: int):
    """(operations, bytes) of one call: 2 K2 T din dout float32 operations
    (FMA = 2); x and w read once and y written once, ``itemsize`` bytes
    each element."""
    ops = 2 * K2 * T * din * dout
    nbytes = itemsize * (K2 * T * din + din * dout + K2 * T * dout)
    return ops, nbytes


def hdual_linear_plain(x, w):
    """x (K2, T, din), w (din, dout) -> (K2, T, dout) in x.dtype: one einsum
    over all components with w cast to x.dtype, accumulated in float32."""
    w = w.to(x.dtype)
    return torch.einsum("ktd,df->ktf", x.float(), w.float()).to(x.dtype)


def split_tf32(x):
    """float32 x -> (big, small), both TF32 values (10 mantissa bits) with
    big + small ~ x: big = rna(x), small = rna(x - big), where rna rounds to
    TF32 to nearest with ties away from zero, as ``cvt.rna.tf32.f32`` does
    (half a TF32 unit is added to the magnitude bits, which are then
    truncated).  The float32 wgmma kernel splits both operands this way and
    sums small*W_big + big*W_small + big*W_big."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    big = rna(x)
    return big, rna(x - big)


class Group(NamedTuple):
    """ncomp components of npoints rows: element (component k, row t,
    depth d) of the input lies at storage offset
    ``inp.storage_offset() + k*in_strides[0] + t*in_strides[1] +
    d*in_strides[2]`` of ``inp``'s storage, and (k, t, column o) of the
    output likewise in ``out`` (strides in elements)."""
    inp: torch.Tensor
    out: torch.Tensor
    ncomp: int
    npoints: int
    in_strides: tuple
    out_strides: tuple


def stacked_group(x, y):
    """x (K2, T, din) and y (K2, T, dout) as one group of K2 components."""
    return Group(x, y, x.shape[0], x.shape[1], tuple(x.stride()),
                 tuple(y.stride()))


def _component_group(t, out):
    """An HDual component of shape (T, din) or (T, din, c) as a group of 1
    or c components, with its output (T, dout) or (T, dout, c)."""
    if t.dim() == 2:
        return Group(t, out, 1, t.shape[0], (0,) + tuple(t.stride()),
                     (0,) + tuple(out.stride()))
    return Group(t, out, t.shape[2], t.shape[0],
                 (t.stride(2), t.stride(0), t.stride(1)),
                 (out.stride(2), out.stride(0), out.stride(1)))


def tc_form(g: Group, din: int, dout: int):
    """The group as the wgmma variant reads it, or None: npoints points of
    cc interleaved components, element (point, d, k) at (point*din + d)*cc
    + k of the input and (point, o, k) at (point*dout + o)*cc + k of the
    output.  Components stacked one contiguous (npoints, din) block after
    the other fold into the points (cc = 1)."""
    (ks, rs, ds), (ko, ro, oo) = g.in_strides, g.out_strides
    cc = g.ncomp
    if ((cc == 1 or (ks == 1 and ko == 1)) and ds == cc and rs == din * cc
            and oo == cc and ro == dout * cc):
        return g
    if (ds == 1 and rs == din and ks == g.npoints * din and oo == 1
            and ro == dout and ko == g.npoints * dout):
        return g._replace(ncomp=1, npoints=g.ncomp * g.npoints)
    return None


def choose_variant(groups, din: int, dout: int, dtype) -> str:
    """"wgmma" when TMA and wgmma can take every group: din a multiple of
    128 bytes (whole swizzle rows), dout a multiple of 8 (wgmma's N), each
    group in ``tc_form`` with at most 128 components a point and fewer than
    2**31 points, and every input and output pointer 16-byte aligned;
    "simt" otherwise."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    if din % (TC_ROW_BYTES // itemsize) or dout % 8:
        return "simt"
    for g in groups:
        f = tc_form(g, din, dout)
        if (f is None or f.ncomp > TC_ROWS or f.npoints >= 2 ** 31
                or f.inp.data_ptr() % 16 or f.out.data_ptr() % 16):
            return "simt"
    return "wgmma"


def groups_plain(groups, w):
    """The plain version over group descriptors: each group's input read
    and its output written through ``torch.as_strided`` at the descriptor's
    strides, the product being ``hdual_linear_plain``."""
    din, dout = w.shape
    for g in groups:
        x = torch.as_strided(g.inp, (g.ncomp, g.npoints, din), g.in_strides,
                             g.inp.storage_offset())
        y = torch.as_strided(g.out, (g.ncomp, g.npoints, dout),
                             g.out_strides, g.out.storage_offset())
        y.copy_(hdual_linear_plain(x, w))


class _CGroup(ctypes.Structure):
    """csrc/hdual_linear.cu::hdual_linear::Group."""
    _fields_ = [("inp", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("ncomp", ctypes.c_longlong), ("npoints", ctypes.c_longlong),
                ("in_comp", ctypes.c_longlong), ("in_row", ctypes.c_longlong),
                ("in_d", ctypes.c_longlong), ("out_comp", ctypes.c_longlong),
                ("out_row", ctypes.c_longlong),
                ("out_o", ctypes.c_longlong)]


_LIB = None


def _launcher():
    global _LIB
    if _LIB is None:
        # first launch: one thread builds and loads, the rest wait on the
        # lock; the argtypes are set before the library is published
        with build.LOCK:
            if _LIB is None:
                lib = build.load("hdual_linear")
                p, i = ctypes.c_void_p, ctypes.c_int
                lib.hdual_linear_launch.argtypes = [p, i, p, p, i, i, i, i, p]
                lib.hdual_linear_launch.restype = ctypes.c_int
                _LIB = lib
    return _LIB.hdual_linear_launch


def _run(groups, w, variant):
    """Every group through W: the plain version on CPU tensors, one launch
    of the chosen (or given) variant on CUDA tensors.  A given variant is
    checked against ``choose_variant`` on either device."""
    din, dout = w.shape
    chosen = choose_variant(groups, din, dout, w.dtype)
    if variant is None:
        variant = chosen
    elif variant not in VARIANTS:
        raise ValueError(f"hdual_linear: variant must be one of "
                         f"{sorted(VARIANTS)}; got {variant!r}")
    elif variant == "wgmma" and chosen != "wgmma":
        raise ValueError("hdual_linear: the wgmma variant cannot take these "
                         "shapes, strides or pointers (choose_variant)")
    if w.device.type == "cpu":
        groups_plain(groups, w)
        return
    wt = None
    if variant == "wgmma":
        groups = [tc_form(g, din, dout) for g in groups]
        parts = 2 if w.dtype == torch.float32 else 1
        wt = torch.empty(parts * dout * din, dtype=w.dtype, device=w.device)
    cgroups = (_CGroup * len(groups))(*[
        _CGroup(g.inp.data_ptr(), g.out.data_ptr(), g.ncomp, g.npoints,
                *g.in_strides, *g.out_strides) for g in groups])
    launch = _launcher()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = launch(cgroups, len(groups), w.data_ptr(),
                     None if wt is None else wt.data_ptr(),
                     build.DTYPE_CODES[w.dtype], din, dout,
                     VARIANTS[variant], stream)
    if err != 0:
        raise RuntimeError(f"hdual_linear: {variant} launch failed with CUDA "
                           f"error {err} (w {tuple(w.shape)}, groups "
                           f"{[(g.ncomp, g.npoints) for g in groups]})")
    hdual_linear_cuda.launches += 1
    hdual_linear_cuda.launches_by_variant[variant] += 1


def _check_types(tensors, w):
    """Types and devices shared by both entry points; returns w in the
    tensors' dtype."""
    if not all(isinstance(t, torch.Tensor) for t in (*tensors, w)):
        raise TypeError("hdual_linear: inputs and w must be tensors")
    codes = build.DTYPE_CODES
    dtypes = {t.dtype for t in tensors}
    if (len(dtypes) != 1 or not all(d in codes for d in dtypes)
            or w.dtype not in codes):
        raise TypeError(f"hdual_linear: inputs (of one type) and w must be "
                        f"one of {sorted(map(str, codes))}; got "
                        f"{sorted(map(str, dtypes))}, {w.dtype}")
    devices = {t.device for t in tensors}
    if devices != {w.device}:
        raise ValueError(f"hdual_linear: x on {sorted(map(str, devices))}, "
                         f"w on {w.device}")
    if w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hdual_linear: unsupported device {w.device}")
    return w.to(tensors[0].dtype)


def _check_tiles(T, din, dout, bt, bo, bk):
    """The reference's tiles: clamped to the dims, they must divide them."""
    if min(T, din, dout) < 1 or min(bt, bo, bk) < 1:
        raise ValueError(f"hdual_linear: empty shape or tile: (T, din, "
                         f"dout) = {(T, din, dout)}, tiles {(bt, bo, bk)}")
    bt, bo, bk = min(bt, T), min(bo, dout), min(bk, din)
    if T % bt or dout % bo or din % bk:
        raise ValueError(f"hdual_linear: tiles must divide the dims: "
                         f"(T, din, dout) = {(T, din, dout)}, "
                         f"(bt, bk, bo) = {(bt, bk, bo)}")


def hdual_linear_cuda(x, w, *, bt: int = 128, bo: int = 128, bk: int = 128,
                      variant: str | None = None):
    """Y[k] = X[k] @ W for every stacked hDual component k.

    x: (K2, T, din) contiguous, w: (din, dout), float32, bfloat16 or
    float16; w is cast to x.dtype.  Returns (K2, T, dout) in x.dtype,
    accumulated in float32.  bt, bo, bk are the reference's tiles: clamped
    to T, dout, din, they must divide them (ValueError otherwise, on either
    device); the kernel's own tiles are fixed in its source.  CUDA tensors
    launch a variant (``choose_variant``'s, or ``variant``) on the current
    stream; CPU tensors take the plain version."""
    w = _check_types((x,), w)
    if x.dim() != 3 or w.dim() != 2:
        raise ValueError(f"hdual_linear: x must be (K2, T, din) and w "
                         f"(din, dout); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    K2, T, din = x.shape
    if w.shape[0] != din:
        raise ValueError(f"hdual_linear: w has {w.shape[0]} rows, x has "
                         f"din={din}")
    if K2 < 1:
        raise ValueError(f"hdual_linear: empty x {tuple(x.shape)}")
    _check_tiles(T, din, w.shape[1], bt, bo, bk)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("hdual_linear: x and w must be contiguous")
    y = torch.empty((K2, T, w.shape[1]), dtype=x.dtype, device=x.device)
    _run([stacked_group(x, y)], w, variant)
    return y


def hdual_linear_apply_cuda(hd, w, *, bt: int = 128, bo: int = 128,
                            bk: int = 128, variant: str | None = None):
    """The HDual ``hd`` of value shape (din,) or (T, din) through W, as the
    reference's ``hdual_linear_apply``: every component times W in one
    launch that reads val, di, dj, dij where they lie (any strides) and
    writes the result's four tensors, contiguous, in hd's layout.  The
    tiles are checked on (T, din, dout) as the reference checks them on the
    stacked components."""
    comps = (hd.val, hd.di, hd.dj, hd.dij)
    w = _check_types(comps, w)
    val = hd.val
    if val.dim() not in (1, 2) or w.dim() != 2:
        raise ValueError(f"hdual_linear_apply: value shape must be (din,) or "
                         f"(T, din) and w (din, dout); got "
                         f"{tuple(val.shape)}, {tuple(w.shape)}")
    c = hd.csize
    if (hd.di.shape != val.shape or hd.dj.shape != val.shape + (c,)
            or hd.dij.shape != hd.dj.shape or c < 1):
        raise ValueError(f"hdual_linear_apply: component shapes "
                         f"{[tuple(t.shape) for t in comps]} do not match")
    din, dout = w.shape
    if val.shape[-1] != din:
        raise ValueError(f"hdual_linear_apply: w has {din} rows, the value "
                         f"has din={val.shape[-1]}")
    vec = val.dim() == 1
    if vec:
        comps = tuple(t[None] for t in comps)
    T = comps[0].shape[0]
    _check_tiles(T, din, dout, bt, bo, bk)
    if not w.is_contiguous():
        raise ValueError("hdual_linear_apply: w must be contiguous")
    new = dict(dtype=val.dtype, device=val.device)
    outs = (torch.empty((T, dout), **new), torch.empty((T, dout), **new),
            torch.empty((T, dout, c), **new), torch.empty((T, dout, c), **new))
    _run([_component_group(t, o) for t, o in zip(comps, outs)], w, variant)
    if vec:
        outs = tuple(o[0] for o in outs)
    return HDual(*outs)


hdual_linear_cuda.launches = 0
hdual_linear_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)
