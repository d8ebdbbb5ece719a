"""Atomic checkpointing of pytrees of tensors.

Counterpart of ``repro.checkpoint.checkpoint``, with its layout and
contract:

Layout:  <dir>/step_<k>.tmp/  ->(atomic rename)->  <dir>/step_<k>/
           leaf files  <hash>.npy      (one per pytree leaf)
           meta.json   {step, leaves: {path: {file, shape, dtype}}}
         <dir>/LATEST  (text file with the step number, written last)

Fault-tolerance contract:
  * a crash mid-save leaves only a .tmp dir -> ignored on restore;
  * LATEST is updated only after the rename, so it always points at a
    complete checkpoint;
  * restore places each leaf on the device and in the dtype of the
    target tree's leaf; given ``shardings`` (the target's structure, with
    ``parallel.sharding.NamedSharding`` leaves) it makes each tensor leaf a
    DTensor on the sharding's mesh from this rank's block of the saved
    array -- the elastic restart: save on one mesh shape, restore on
    another;
  * a tree with DTensor leaves is saved by every rank of their mesh
    together: each leaf is gathered whole (in tree order on every rank),
    the first rank writes the global arrays, in the format above, and a
    barrier holds every rank until the checkpoint is published.  Such
    saves are synchronous, ``save_async`` included;
  * saves run on a background thread (async) with a join() barrier before
    the next save -- compute/IO overlap without torn states.

Leaf paths are ``torch.utils._pytree`` key paths (``keystr``).  A leaf is
a tensor, a numpy array or a Python scalar.  Leaves go to the host through
``repro_torch.hostarray``: a bfloat16 leaf is written as float32, which
holds it exactly, with ``"bfloat16"`` in ``meta.json``, and comes back
bit-exact.  Checkpoints of the reference are not read.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.hostarray import dtype_name, to_device, to_host
from repro_torch.parallel.sharding import gather

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]


def _leaf_file(path: str) -> str:
    return hashlib.sha1(path.encode()).hexdigest()[:16] + ".npy"


def _flatten_with_paths(tree) -> dict:
    flat, _ = pytree.tree_flatten_with_path(tree)
    return {pytree.keystr(kp): leaf for kp, leaf in flat}


def _host_leaf(leaf, copy: bool) -> tuple[np.ndarray, str]:
    """(host array, dtype name) of one leaf; a Python scalar is an array
    of numpy's dtype for it.  ``copy``: never an array that shares memory
    with the leaf (a CPU tensor's ``numpy()`` does)."""
    arr, dt = to_host(leaf)
    if copy and not (isinstance(leaf, torch.Tensor)
                     and leaf.device.type != "cpu"):
        arr = arr.copy()
    return arr, dtype_name(dt)


def _host_tree(tree, copy: bool = False):
    """{key path: (host array, dtype name)} of the tree's leaves."""
    return {path: _host_leaf(leaf, copy)
            for path, leaf in _flatten_with_paths(tree).items()}


def _is_sharded(tree) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(x, DTensor) for x in pytree.tree_leaves(tree))


def _save_sharded(ckpt_dir: str, step: int, tree) -> str:
    """Every rank gathers the leaves; the first writes; all wait for it."""
    import torch.distributed as dist
    host = _host_tree(gather(tree))
    final = os.path.join(ckpt_dir, f"step_{step}")
    if dist.get_rank() == 0:
        _write(ckpt_dir, step, host)
    dist.barrier()
    return final


def _write(ckpt_dir: str, step: int, host: dict) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    meta = {"step": step, "leaves": {}}
    for path, (arr, dtype) in host.items():
        fname = _leaf_file(path)
        np.save(os.path.join(tmp, fname), arr)
        meta["leaves"][path] = {"file": fname, "shape": list(arr.shape),
                                "dtype": dtype}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    return final


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    if _is_sharded(tree):
        return _save_sharded(ckpt_dir, step, tree)
    return _write(ckpt_dir, step, _host_tree(tree))


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        step = int(f.read().strip())
    if not os.path.exists(os.path.join(ckpt_dir, f"step_{step}")):
        return None                            # torn state: treat as absent
    return step


def _restore_leaf(arr: np.ndarray, target, sharding=None):
    """``arr`` as a value like ``target``: a tensor on its device and in
    its dtype (a DTensor of this rank's block on the sharding's mesh when
    one is given), a numpy array of its dtype, or a Python scalar of its
    type."""
    if isinstance(target, torch.Tensor):
        if sharding is not None:
            return _sharded_leaf(arr, target.dtype, sharding)
        return to_device(arr, target.dtype, target.device)
    if isinstance(target, np.ndarray):
        return arr.astype(target.dtype)
    return type(target)(arr.item())


def _sharded_leaf(arr: np.ndarray, dtype, sharding):
    """This rank's block of the saved global array, as a DTensor on the
    sharding's mesh's device (the block alone goes to the device)."""
    device = (torch.device("cuda", torch.cuda.current_device())
              if sharding.mesh.device_type == "cuda"
              else torch.device("cpu"))
    block = np.array(arr[sharding.local_slices(arr.shape)])   # a C copy
    return sharding.wrap(to_device(block, dtype, device), arr.shape)


def restore_checkpoint(ckpt_dir: str, step: int, target_tree,
                       shardings=None):
    """Restore into the structure of ``target_tree``: each leaf lands on
    its target leaf's device and in its dtype (tensors), or in its numpy
    dtype or Python type.  ``shardings`` (the same structure,
    ``NamedSharding`` leaves) reshards every tensor leaf onto the CURRENT
    mesh as a DTensor; a leaf that is not a tensor (the state's int
    seed) ignores its sharding.  A leaf whose saved shape differs from its
    target's raises ValueError."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    flat_shard = ({} if shardings is None
                  else _flatten_with_paths(shardings))
    flat, treedef = pytree.tree_flatten_with_path(target_tree)
    leaves = []
    for kp, tgt in flat:
        path = pytree.keystr(kp)
        info = meta["leaves"][path]
        arr = np.load(os.path.join(d, info["file"]))
        want = tuple(getattr(tgt, "shape", ()))
        if tuple(arr.shape) != want:
            raise ValueError(f"checkpoint leaf {path}: saved shape "
                             f"{tuple(arr.shape)}, target {want}")
        leaves.append(_restore_leaf(arr, tgt, flat_shard.get(path)))
    return pytree.tree_unflatten(leaves, treedef)


class CheckpointManager:
    """Async saves + retention GC + resume discovery."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def save_async(self, step: int, tree):
        self.join()
        if _is_sharded(tree):
            self.save(step, tree)
            return
        # to the host on the caller thread, as copies: the next step
        # updates the tensors in place right after
        host = _host_tree(tree, copy=True)

        def work():
            _write(self.dir, step, host)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, tree):
        self.join()
        save_checkpoint(self.dir, step, tree)
        self._gc()

    def join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    def latest(self) -> Optional[int]:
        self.join()
        return latest_step(self.dir)

    def restore(self, step: int, target_tree, shardings=None):
        return restore_checkpoint(self.dir, step, target_tree, shardings)
