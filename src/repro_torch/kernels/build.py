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
and spills per kernel) is kept beside the library as ``<name>-<hash>.log``,
after a first line ``# nvcc <seconds> s``.

``LOCK`` (reentrant) serializes building and loading within a process: the
serving stack's dispatch workers may be the first to launch a kernel, and
two threads must not run two builds of one source.  The wrappers' lazy
launchers take it too.  A temporary output is named by pid and thread, so
builds of other processes (or threads) never share a path.

Generated sources (``kernels/codegen.py``: the device form of a traced f at
one n) are built by ``load_generated``: the text is written to
``build/repro_torch_kernels/<prefix>-<hash>.cu``, named by the hash of the
text, the flags and the headers of ``csrc/`` it includes, and compiled with
the same flags plus ``-I csrc`` and ``-split-compile 0`` (``GENERATED_FLAGS``:
nvcc optimizes the lane instantiations on all cores; the same registers and
spills, in about half the time of one core on the CPU tests' all-ops
function) into ``lib<prefix>-<hash>.so`` beside it (log
``<prefix>-<hash>.log``), so a second process with the same function and n
builds nothing.  ``build_generated`` starts the nvcc of several
sources together.  A failed build raises with nvcc's log.  Nothing is
written anywhere but ``BUILD_DIR``.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "GENERATED_FLAGS",
           "DTYPE_CODES", "LOCK",
           "nvcc_path", "build_all", "load", "build_log", "generated_paths",
           "build_generated", "load_generated"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GENERATED_FLAGS = NVCC_FLAGS + ("-I", str(CSRC), "-split-compile", "0")

# element types the C entry points take, by the code they are passed as
# (the DType enums of csrc/*.cu)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_LOADED: dict = {}
LOCK = threading.RLock()


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
    with LOCK:
        return _build_all()


def _build_all() -> dict:
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = []
    for name in names:
        so, log = _paths(name)
        if not so.exists():
            jobs.append(([*NVCC_FLAGS, str(CSRC / f"{name}.cu")], so, log))
    _compile(jobs)
    return {name: _paths(name)[0] for name in names}


def _compile(jobs) -> None:
    """Run ``nvcc <args> -o <library>`` for every (args, library, log) of
    jobs, all started together, each into a temporary named by pid and
    thread and moved into place when it succeeds (atomic: readers see whole
    libraries).  Each log is the compiler's output after a line ``# nvcc
    <seconds> s``.  Raises with the failed commands and their output."""
    if not jobs:
        return
    try:
        nvcc = nvcc_path()
    except RuntimeError as e:
        raise RuntimeError(f"{e}; could not run: nvcc "
                           f"{' '.join(jobs[0][0])} -o {jobs[0][1]}") from None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    suffix = f".{os.getpid()}.{threading.get_ident()}.tmp"
    running = []
    for args, so, log in jobs:
        tmp = so.with_suffix(suffix)
        cmd = [nvcc, *args, "-o", str(tmp)]
        out = open(log.with_suffix(suffix), "w+")
        running.append((cmd, tmp, so, log, out, time.perf_counter(),
                        subprocess.Popen(cmd, stdout=out,
                                         stderr=subprocess.STDOUT)))
    failed = []
    while running:
        for job in list(running):
            cmd, tmp, so, log, out, t0, proc = job
            if proc.poll() is None:
                continue
            running.remove(job)
            out.seek(0)
            output = out.read()
            out.close()
            os.unlink(out.name)
            log.write_text(f"# nvcc {time.perf_counter() - t0:.1f} s\n"
                           + output)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{' '.join(cmd)}\n{output}")
            else:
                os.replace(tmp, so)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed.
    Concurrent first calls build once and get the same library."""
    with LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = ctypes.CDLL(str(build_all()[name]))
        return lib


def build_log(name: str) -> str:
    """The compiler output of the current build of ``csrc/<name>.cu``."""
    return _paths(name)[1].read_text()


def generated_paths(source: str, prefix: str = "chess_hvp_traced"):
    """(source, library, log) paths of a generated translation unit under
    ``BUILD_DIR``, named by the hash of its text, the flags and every
    header in ``csrc/``."""
    h = hashlib.sha256(" ".join(GENERATED_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(source.encode())
    tag = f"{prefix}-{h.hexdigest()[:16]}"
    return (BUILD_DIR / f"{tag}.cu", BUILD_DIR / f"lib{tag}.so",
            BUILD_DIR / f"{tag}.log")


def build_generated(sources) -> list:
    """Build every generated source that has no library yet, one nvcc per
    source, all started together; returns their library paths."""
    with LOCK:
        jobs = []
        for text in sources:
            cu, so, log = generated_paths(text)
            if so.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp_cu = cu.with_suffix(f".{os.getpid()}.{threading.get_ident()}"
                                    f".tmp")
            tmp_cu.write_text(text)
            os.replace(tmp_cu, cu)
            jobs.append(([*GENERATED_FLAGS, "-x", "cu", str(cu)], so, log))
        _compile(jobs)
        return [generated_paths(text)[1] for text in sources]


def load_generated(source: str) -> ctypes.CDLL:
    """The loaded library of a generated source, building it if needed."""
    with LOCK:
        so = build_generated([source])[0]
        lib = _LOADED.get(str(so))
        if lib is None:
            lib = _LOADED[str(so)] = ctypes.CDLL(str(so))
        return lib
