"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch_kernels/lib<name>-<hash>.so``
at the repository root (git-ignored), compiled for Hopper::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so csrc/<name>.cu

at first use, one nvcc per source, all started together.  The hash covers
every source in ``csrc/`` and the flags, so an edited source is rebuilt and
an unchanged one is loaded as it is.  The sources have a plain C interface
and include no PyTorch headers, so a build takes seconds.  ``nvcc`` is
looked up on ``PATH``, then under ``$CUDA_HOME/bin`` and
``/usr/local/cuda/bin``; without it, building raises with the command it
tried.  The compiler's output (``-Xptxas -v``: registers
and spills per kernel) is kept beside the library as ``<name>-<hash>.log``.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "DTYPE_CODES", "nvcc_path",
           "build_all", "load", "build_log"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# element types the C entry points take, by the code they are passed as
# (the DType enums of csrc/*.cu)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_LOADED: dict = {}


def nvcc_path() -> str:
    """The nvcc executable, or raise naming where it was looked for."""
    found = shutil.which("nvcc")
    if found:
        return found
    tried = ["nvcc on PATH"]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = Path(root) / "bin" / "nvcc"
            tried.append(str(cand))
            if cand.is_file():
                return str(cand)
    raise RuntimeError(f"nvcc not found (tried: {', '.join(tried)}); the "
                       "CUDA kernels need the CUDA toolkit to build")


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _paths(name: str):
    tag = _sources_hash()
    return (BUILD_DIR / f"lib{name}-{tag}.so",
            BUILD_DIR / f"{name}-{tag}.log")


def build_all() -> dict:
    """Compile every ``csrc/*.cu`` that has no current library, one nvcc per
    source, all started together.  Returns {name: library path}."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = []
    for name in names:
        so, log = _paths(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        src = CSRC / f"{name}.cu"
        try:
            nvcc = nvcc_path()
        except RuntimeError as e:
            raise RuntimeError(f"{e}; could not run: nvcc "
                               f"{' '.join(NVCC_FLAGS)} -o {so} {src}") from None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((cmd, tmp, so, log, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cmd, tmp, so, log, proc in jobs:
        output = proc.communicate()[0]
        log.write_text(output)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{' '.join(cmd)}\n{output}")
        else:
            os.replace(tmp, so)        # atomic: readers see whole libraries
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {name: _paths(name)[0] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build_all()[name]))
    return lib


def build_log(name: str) -> str:
    """The compiler output of the current build of ``csrc/<name>.cu``."""
    return _paths(name)[1].read_text()
