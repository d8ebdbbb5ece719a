#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Drives the port's main path -- ``engine.plan(f, 64, m=524288, csize="auto")``
then ``plan.batched_hvp(A, V)`` through the hand-written ``chess_hvp`` CUDA
kernel -- for the paper's three test functions on both schedules, at the
paper's scale (0.5M instances, n=64).  Phases, each fatal on failure:

  1. toolchain: the card's name and power limit, torch/CUDA, nvcc versions
  2. build the kernels from ``src/repro_torch/kernels/csrc`` with nvcc
     (seconds, registers and spills of every instantiation)
  3. kernel against its plain PyTorch version on the card: the CPU test
     sweep's small and ragged shapes, and the first, middle and last 256
     instances of each full-width batch (rtol 5e-3, atol 5e-3 *
     (1 + max|want|), the reference's kernel tolerance); a few instances
     against a float64 torch.func HVP at the same bound
  4. the main path at full width: backend resolves to ``cuda``, one launch
     per call, finite output, its first, middle and last 256 rows equal to
     phase 3's plain results; then CUDA-event timing of further calls
  5. one JSON line with the kernel's numbers, the card's name and power
     limit, and a last line ``{"ok": true, "device": {...}}``

Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.  Imports nothing of JAX or of the ``repro`` package.
"""

from __future__ import annotations

import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
M, N = 524288, 64                    # the paper's scale: 0.5M instances, n=64
SAMPLE = 256                         # rows checked against the plain version
SLICES = (0, M // 2 - SAMPLE // 2, M - SAMPLE)   # first, middle, last rows
FUNCTIONS = ("rosenbrock", "ackley", "fletcher_powell")
SCHEDULES = (True, False)            # symmetric (Alg. 8), full (Alg. 7)
CPU_SWEEP = [(16, 8, 2), (8, 16, 4), (8, 8, 8), (24, 12, 3), (8, 10, 4),
             (8, 9, 2), (5, 8, 2), (13, 7, 3), (4, 6, 16)]
RTOL = 5e-3                          # atol = RTOL * (1 + max|want|)
PEAK_FP32 = 67e12                    # H100 SXM fp32 (non-tensor) FLOP/s
PEAK_BYTES = 3.35e12                 # H100 SXM HBM3 bytes/s


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def check_close(got, want, what):
    """Max abs error of got vs want; fails past the kernel tolerance."""
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if not (err <= RTOL * (1.0 + scale)):
        fail(f"{what}: max abs err {err:.3e} > {RTOL} * (1 + {scale:.3e})")
    return err


def cuda_ms(fn, reps):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def ptxas_lines(log):
    """'chess_hvp<F, C>: R registers, S/L bytes spill stores/loads' per
    instantiation, from nvcc -Xptxas -v output."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?INS_\d+([A-Za-z]+)ELi(\d+)E",
                      line)
        if m:
            name = f"chess_hvp<{m.group(1)}, C={m.group(2)}>"
            spill = ("?", "?")
        elif name and "spill stores" in line:
            spill = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, {spill[0]} B spill stores,"
                       f" {spill[1]} B spill loads")
            name = None
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import engine
    from repro_torch.core import ref, testfns
    from repro_torch.kernels import build
    from repro_torch.kernels import chess_hvp as ck
    from repro_torch.kernels.ops import kernel_form

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False      # plain version: IEEE
    torch.backends.cudnn.allow_tf32 = False

    # 1. toolchain --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    nvcc = build.nvcc_path()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    print(" ".join(line for line in version.splitlines() if "release" in line))

    # 2. build ------------------------------------------------------------
    t0 = time.time()
    build.build_all()
    print(f"build: {time.time() - t0:.1f} s ({nvcc} -gencode "
          f"arch=compute_90a,code=sm_90a)")
    for line in ptxas_lines(build.build_log("chess_hvp")):
        print(f"  {line}")
    sys.stdout.flush()

    max_err = 0.0
    gen = torch.Generator(device=dev)

    @functools.lru_cache(maxsize=None)
    def kernel_args(fname, n):
        kf, consts, device_fn = kernel_form(testfns.FUNCTIONS[fname](n))
        return kf, tuple(c.to(dev) for c in consts), device_fn

    def run_kernel(fname, A, V, csize, symmetric):
        kf, consts, device_fn = kernel_args(fname, A.shape[1])
        return ck.chess_hvp_cuda(kf, A, V, csize, consts=consts,
                                 device_fn=device_fn, symmetric=symmetric)

    def run_plain(fname, A, V, csize, symmetric):
        kf, consts, _ = kernel_args(fname, A.shape[1])
        return ck.chess_hvp_plain(kf, A, V, csize, consts, symmetric)

    # 3. kernel against its plain version ---------------------------------
    for fname in FUNCTIONS:
        for m, n, csize in CPU_SWEEP:
            gen.manual_seed(m * 131 + n)
            A = torch.rand(m, n, generator=gen, device=dev) * 4 - 2
            V = torch.randn(m, n, generator=gen, device=dev)
            for symmetric in SCHEDULES:
                got = run_kernel(fname, A, V, csize, symmetric)
                want = run_plain(fname, A, V, csize, symmetric)
                max_err = max(max_err, check_close(
                    got, want, f"{fname} m={m} n={n} csize={csize} "
                    f"symmetric={symmetric}"))
    print(f"kernel vs plain, CPU sweep shapes: ok, max abs err {max_err:.3e}")

    data, cases = {}, {}
    for k, fname in enumerate(FUNCTIONS):
        gen.manual_seed(1000 + k)
        A = torch.rand(M, N, generator=gen, device=dev) * 4 - 2
        V = torch.randn(M, N, generator=gen, device=dev)
        data[fname] = (A, V)
        for symmetric in SCHEDULES:
            csize = engine.model_csize(N, symmetric)
            plain, err = [], 0.0
            for r0 in reversed(SLICES):    # ends on the first slice
                As, Vs = A[r0:r0 + SAMPLE], V[r0:r0 + SAMPLE]
                got = run_kernel(fname, As, Vs, csize, symmetric)
                plain.insert(0, run_plain(fname, As, Vs, csize, symmetric))
                err = max(err, check_close(
                    got, plain[0], f"{fname} rows {r0}:{r0 + SAMPLE} "
                    f"symmetric={symmetric}"))
            max_err = max(max_err, err)
            # float64 oracle on a few instances of the first slice
            f = testfns.FUNCTIONS[fname](N)
            exact = torch.stack([ref.hvp_fwdrev(f, As[i].double(),
                                                Vs[i].double())
                                 for i in range(4)])
            check_close(got[:4].double(), exact, f"{fname} vs float64")
            rel64 = ((got[:4].double() - exact).abs().max()
                     / exact.abs().max()).item()
            cases[(fname, symmetric)] = {
                "csize": csize, "cells": ck.kernel_grid(M, N, csize,
                                                        symmetric)[1],
                "plain_slices": plain, "max_abs_err_sample": err,
                "max_rel_err_float64": rel64,
                "sample_ms": cuda_ms(lambda: run_kernel(
                    fname, As, Vs, csize, symmetric), 3),
                "plain_sample_ms": cuda_ms(lambda: run_plain(
                    fname, As, Vs, csize, symmetric), 3)}
            print(f"{fname} symmetric={symmetric} csize={csize}: rows "
                  f"{SLICES} (+{SAMPLE} each) vs plain max abs err "
                  f"{err:.3e}, vs "
                  f"float64 max rel err {rel64:.3e}", flush=True)

    # 4. the main path at full width --------------------------------------
    ck.chess_hvp_cuda.launches = 0
    for fname in FUNCTIONS:
        A, V = data[fname]
        f = testfns.FUNCTIONS[fname](N)
        for symmetric in SCHEDULES:
            p = engine.plan(f, N, m=M, csize="auto", symmetric=symmetric)
            if p.backend_for("batched_hvp") != "cuda":
                fail(f"{p.describe()} resolved batched_hvp to "
                     f"{p.backend_for('batched_hvp')}, not cuda")
            before = ck.chess_hvp_cuda.launches
            out = p.batched_hvp(A, V)
            torch.cuda.synchronize()
            if ck.chess_hvp_cuda.launches != before + 1:
                fail(f"{fname}: batched_hvp did not launch the kernel once")
            if out.shape != (M, N) or not bool(torch.isfinite(out).all()):
                fail(f"{fname}: output not finite or of shape {(M, N)}")
            case = cases[(fname, symmetric)]
            for r0, want in zip(SLICES, case["plain_slices"]):
                max_err = max(max_err, check_close(
                    out[r0:r0 + SAMPLE], want,
                    f"{fname} main path rows {r0}:{r0 + SAMPLE} vs plain"))
            case["plan"] = p
    launches = ck.chess_hvp_cuda.launches
    if launches != len(cases):
        fail(f"main path launched the kernel {launches} times, expected "
             f"{len(cases)}")
    print(f"main path: {launches} launches of chess_hvp over "
          f"{len(cases)} batched_hvp calls", flush=True)

    total_ms = total_bound = total_plain = total_sample = 0.0
    report = {}
    for (fname, symmetric), case in cases.items():
        A, V = data[fname]
        p = case["plan"]
        reps = 2 if fname == "fletcher_powell" else 5
        ms = cuda_ms(lambda: p.batched_hvp(A, V), reps)
        ops, nbytes = ck.work(fname, M, N, case["csize"], symmetric)
        bound = max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
        total_ms += ms
        total_bound += bound
        total_plain += case["plain_sample_ms"]
        total_sample += case["sample_ms"]
        key = f"{fname}/{'symmetric' if symmetric else 'full'}"
        report[key] = {
            "csize": case["csize"], "cells": case["cells"], "ms": ms,
            "us_per_instance": ms * 1e3 / M, "bound_ms": bound,
            "fp32_ops": ops, "bytes": nbytes,
            "sample_ms": case["sample_ms"],
            "plain_sample_ms": case["plain_sample_ms"],
            "max_abs_err_sample": case["max_abs_err_sample"],
            "max_rel_err_float64": case["max_rel_err_float64"]}
        print(f"{key}: {ms:.3f} ms per call, {ms * 1e3 / M:.5f} us per "
              f"instance, bound {bound:.3f} ms ({ops:.4e} fp32 ops), "
              f"{SAMPLE}-row sample: kernel {case['sample_ms']:.3f} ms, "
              f"plain {case['plain_sample_ms']:.3f} ms", flush=True)

    # 5. results ----------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "chess_hvp", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/chess_hvp.cu",
        "replaces": "src/repro/kernels/chess_hvp.py:158",
        "launches": launches, "max_abs_err": max_err,
        "ms": total_ms, "plain_ms": total_plain, "bound_ms": total_bound,
        "bound_by": "operations", "library_ms": None,
        "sample_rows": SAMPLE, "sample_ms": total_sample,
        "shape": {"m": M, "n": N}, "cases": report}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
