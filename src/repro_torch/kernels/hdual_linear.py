"""hdual_linear: the fused (2c+2)-component hDual linear map Y[k] = X[k] @ W,
hand-written in CUDA C++ for Hopper, with its plain PyTorch version.

Counterpart of ``repro.kernels.hdual_linear`` (``hdual_linear_pallas``).  A
linear map acts on every hDual component alone, so pushing an hDual through
it is K2 = 2c+2 products against the same W; the kernel
(``csrc/hdual_linear.cu``) reads each W tile once per CTA and k-step into
shared memory and contracts it against every component the CTA owns, in
float32 FFMA (see the note at the top of the source).

* ``hdual_linear_cuda`` is the wrapper.  It checks its arguments and the
  reference's tiles on any device; on a CUDA tensor it launches the kernel
  (building it at first use, ``kernels/build.py``) and counts the launch in
  ``hdual_linear_cuda.launches``; on a CPU tensor it returns the plain
  version; anything else raises.  There is no fallback from the kernel.
* ``hdual_linear_plain`` is the reference's function in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["hdual_linear_cuda", "hdual_linear_plain", "work"]


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


def _check(x, w, bt, bo, bk):
    """Argument checks shared by both devices; returns w in x.dtype."""
    if not (isinstance(x, torch.Tensor) and isinstance(w, torch.Tensor)):
        raise TypeError("hdual_linear: x and w must be tensors")
    codes = build.DTYPE_CODES
    if x.dtype not in codes or w.dtype not in codes:
        raise TypeError(f"hdual_linear: x and w must be one of "
                        f"{sorted(map(str, codes))}; got {x.dtype}, "
                        f"{w.dtype}")
    if x.device != w.device:
        raise ValueError(f"hdual_linear: x on {x.device}, w on {w.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hdual_linear: unsupported device {x.device}")
    if x.dim() != 3 or w.dim() != 2:
        raise ValueError(f"hdual_linear: x must be (K2, T, din) and w "
                         f"(din, dout); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    K2, T, din = x.shape
    if w.shape[0] != din:
        raise ValueError(f"hdual_linear: w has {w.shape[0]} rows, x has "
                         f"din={din}")
    dout = w.shape[1]
    if min(K2, T, din, dout) < 1 or min(bt, bo, bk) < 1:
        raise ValueError(f"hdual_linear: empty shape or tile: x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"tiles {(bt, bo, bk)}")
    # the reference's tiles: clamped to the dims, and they must divide them
    bt, bo, bk = min(bt, T), min(bo, dout), min(bk, din)
    if T % bt or dout % bo or din % bk:
        raise ValueError(f"hdual_linear: tiles must divide the dims: "
                         f"(T, din, dout) = {(T, din, dout)}, "
                         f"(bt, bk, bo) = {(bt, bk, bo)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("hdual_linear: x and w must be contiguous")
    return w.to(x.dtype)


_LIB = None


def _launcher():
    global _LIB
    if _LIB is None:
        lib = build.load("hdual_linear")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hdual_linear_launch.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.hdual_linear_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB.hdual_linear_launch


def hdual_linear_cuda(x, w, *, bt: int = 128, bo: int = 128, bk: int = 128):
    """Y[k] = X[k] @ W for every stacked hDual component k.

    x: (K2, T, din), w: (din, dout), float32, bfloat16 or float16; w is cast
    to x.dtype.  Returns (K2, T, dout) in x.dtype, accumulated in float32.
    bt, bo, bk are the reference's tiles: clamped to T, dout, din, they must
    divide them (ValueError otherwise, on either device); the kernel's own
    tiles are fixed in its source.  CUDA tensors launch the kernel on the
    current stream; CPU tensors take the plain version."""
    w = _check(x, w, bt, bo, bk)
    if x.device.type == "cpu":
        return hdual_linear_plain(x, w)
    K2, T, din = x.shape
    dout = w.shape[1]
    y = torch.empty((K2, T, dout), dtype=x.dtype, device=x.device)
    launch = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                     build.DTYPE_CODES[x.dtype], K2, T, din, dout, stream)
    if err != 0:
        raise RuntimeError(f"hdual_linear: kernel launch failed with CUDA "
                           f"error {err} (x {tuple(x.shape)}, w "
                           f"{tuple(w.shape)})")
    hdual_linear_cuda.launches += 1
    return y


hdual_linear_cuda.launches = 0
