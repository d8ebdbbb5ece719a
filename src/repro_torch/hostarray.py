"""Host arrays for tensors of every dtype the port computes in.

The service stacks requests into one numpy array per bucket, and a
checkpoint writes each leaf as an ``.npy`` file.  numpy has no bfloat16
(the reference gets one from ``ml_dtypes`` through jax, which the port does
not import), so a bfloat16 tensor has no numpy array of its own dtype.

These helpers keep the torch dtype beside a host array that numpy can
hold: the values themselves where numpy has the dtype, else float32, which
holds every bfloat16 value exactly.  Casting back on the device, or on
readback, gives the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["torch_dtype", "dtype_name", "host_dtype", "to_host", "to_device",
           "from_host"]

# torch dtypes numpy cannot hold -> the torch dtype their host arrays use
_WIDE = {torch.bfloat16: torch.float32}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a torch dtype, a numpy dtype or a dtype name
    (``"bfloat16"``, ``"float32"``, ``"torch.int64"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    dt = getattr(torch, name.removeprefix("torch."), None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"no torch dtype for {dtype!r}")
    return dt


def dtype_name(dtype) -> str:
    """``"bfloat16"`` for torch.bfloat16 (and for its numpy or name forms)."""
    return str(torch_dtype(dtype)).removeprefix("torch.")


def host_dtype(dtype) -> np.dtype:
    """The numpy dtype that holds values of ``dtype`` exactly on the host."""
    dt = torch_dtype(dtype)
    return torch.empty((), dtype=_WIDE.get(dt, dt)).numpy().dtype


def to_host(x) -> tuple[np.ndarray, torch.dtype]:
    """(host numpy array, torch dtype) of a tensor, a numpy array or a
    scalar.  A device tensor is copied to the host before any widening, so
    the device never holds a widened copy."""
    if isinstance(x, torch.Tensor):
        dt = x.dtype
        t = x.detach().cpu()
        if dt in _WIDE:
            t = t.to(_WIDE[dt])
        return t.numpy(), dt
    arr = np.asarray(x)
    dt = torch_dtype(arr.dtype)
    if dt in _WIDE:
        arr = arr.astype(host_dtype(dt))
    return arr, dt


def to_device(arr, dtype, device) -> torch.Tensor:
    """A host array on ``device`` in ``dtype`` (None: the array's own)."""
    t = torch.as_tensor(np.asarray(arr, order="C"), device=device)
    if dtype is not None and t.dtype != dtype:
        t = t.to(torch_dtype(dtype))
    return t


def from_host(arr, dtype):
    """A host array as a caller's value of ``dtype``: a numpy array where
    numpy has the dtype, else a CPU tensor of it."""
    dt = torch_dtype(dtype)
    if dt in _WIDE:
        return torch.from_numpy(np.asarray(arr, order="C")).to(dt)
    return np.asarray(arr, dtype=host_dtype(dt))
