"""Mesh construction on ``torch.distributed``.

Counterpart of ``repro.launch.mesh`` and of ``repro.compat.make_mesh``: a
named ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of a
process group.  Functions, not module constants: importing this module
initializes nothing.

A mesh needs a process group of its size.  A launcher (``torchrun``, or the
caller's own ``dist.init_process_group(..., rank=r, world_size=w)``)
starts one process per rank; ``make_test_mesh`` then builds the mesh over
that world.  With no group and a shape of one device, it starts a world of
one itself (NCCL on ``cuda``, gloo on ``cpu``, an in-memory store), which is
what one card gives: NCCL refuses two ranks on one GPU.

``SINGLE_POD`` and ``MULTI_POD`` are the reference's production layouts (a
256-device pod of ("data", "model") = (16, 16), and two of them under a
"pod" axis), kept as data: ``make_production_mesh`` builds one only inside a
world of that size.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

__all__ = ["make_test_mesh", "make_production_mesh", "SINGLE_POD",
           "MULTI_POD"]

SINGLE_POD = {"shape": (16, 16), "axes": ("data", "model")}
MULTI_POD = {"shape": (2, 16, 16), "axes": ("pod", "data", "model")}

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _init_world_of_one(device: torch.device) -> None:
    """A process group of this one process, on the device's backend, with
    an in-memory store (no address, no port)."""
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_test_mesh: no CUDA device is available; "
                               "pass device='cpu' for a gloo mesh")
        torch.cuda.set_device(device.index if device.index is not None
                              else torch.cuda.current_device())
    dist.init_process_group(_BACKENDS[device.type], store=dist.HashStore(),
                            rank=0, world_size=1)


def _mesh(shape: tuple, axes: tuple, device: torch.device):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device.type, shape, mesh_dim_names=axes)


def make_test_mesh(shape=(1, 1), axes=("data", "model"), device="cuda"):
    """A named DeviceMesh of ``shape`` over the launched process group, or
    over a world of one that this call starts when no group exists and the
    shape's product is 1.  ValueError when the shape's product is not the
    world size, or the shape and axes differ in length."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(str(a) for a in axes)
    device = torch.device(device)
    if device.type not in _BACKENDS:
        raise ValueError(f"make_test_mesh: no backend for {device.type!r}; "
                         f"expected one of {sorted(_BACKENDS)}")
    if len(shape) != len(axes):
        raise ValueError(f"make_test_mesh: shape {shape} and axes {axes} "
                         "differ in length")
    size = math.prod(shape)
    if not dist.is_initialized():
        if size != 1:
            raise ValueError(
                f"make_test_mesh: a {shape} mesh needs a process group of "
                f"{size} ranks; launch one (torchrun, or "
                "dist.init_process_group per rank) first")
        _init_world_of_one(device)
    world = dist.get_world_size()
    if size != world:
        raise ValueError(f"make_test_mesh: shape {shape} holds {size} "
                         f"devices, the process group {world}")
    return _mesh(shape, axes, device)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16x16 ("data", "model") pod of cards, or two of
    them under a leading "pod" axis (512 devices).  Raises ValueError
    outside a launched process group of exactly that size."""
    spec = MULTI_POD if multi_pod else SINGLE_POD
    size = math.prod(spec["shape"])
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != size:
        raise ValueError(
            f"make_production_mesh: the {spec['shape']} layout needs a "
            f"process group of {size} ranks; this process has "
            f"{'none' if world is None else world}")
    return _mesh(spec["shape"], spec["axes"], torch.device("cuda"))
