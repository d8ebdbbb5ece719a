#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Drives the port's two kernel paths through the entry points a user calls,
at full width, and holds every kernel against its plain PyTorch version:

* chess_hvp, the main path: ``engine.plan(f, 64, m=524288, csize="auto")``
  then ``plan.batched_hvp(A, V)`` for the paper's three test functions on
  both schedules, at the paper's scale (0.5M instances, n=64); then the
  same path with bfloat16 A and V, and with chunks wider than 64 lanes
  (csize 128 and 96, m = 65,536), both resolved to the kernel by
  ``backend="auto"``.
* hdual_linear, through ``kernels.ops.hdual_linear_apply``: hDuals of
  T = 524,288 points at n = 64 (c = 4 and 8) and a 2560-wide layer
  (T = 4,096, c = 4), float32 and bfloat16, every one on the kernel's
  tensor-core (wgmma) variant; and a sin network with two
  hdual_linear_apply maps whose Hessian chunk is checked in float64.

Phases, each fatal on failure:

  1. toolchain: the card's name and power limit, torch/CUDA, nvcc versions,
     TF32 off (the plain versions' matrix products are IEEE float32)
  2. build the kernels from ``src/repro_torch/kernels/csrc`` with nvcc, one
     process per source (seconds, registers and spills); cuobjdump -sass
     shows HGMMA (wgmma) in every tensor-core instantiation of hdual_linear
  3. each kernel against its plain version on the card at the CPU tests'
     shapes: chess_hvp in float32, bfloat16, float16, csize 65-128 and n on
     both sides of Fletcher-Powell's staging size
     (rtol 5e-3, atol 5e-3 * (1 + max|want|), the reference's kernel
     tolerance); hdual_linear at the reference's sweep shapes and tiles
     (float32 rtol 1e-5, atol 1e-5 * din; bfloat16 1e-1, 1e-1 * din)
  4. chess_hvp's main path at full width (launch counts zeroed before it and
     read after): backend ``cuda``, one launch per call, finite output whose
     first, middle and last 256 rows equal the plain version's; a float64
     torch.func HVP on a few instances; CUDA-event timing against the bound
     of the work the active coordinates need (``needed_work``), with the
     first kernel's dense bound (``work``) beside it; then the bfloat16 and
     wide-chunk cases; a time that beats its needed bound fails
  5. hdual_linear's path at full width (counts zeroed before it and read
     after): one launch per hdual_linear_apply, of the wgmma variant, every
     element of the output against the plain version at the output's own
     scale (float32 rtol 1e-5, bfloat16 rtol 1e-2, both atol
     1e-5 * (1 + max|want|)), a bound shown to reject an all-zero output
     and, in float32, a TF32-rounded product of the same inputs; CUDA-event
     timing of the call, the kernel on the stacked components, its simt
     variant (the FFMA kernel) on the same data, the plain version and
     torch.matmul (the yardstick), against the least time of the card's
     routes for the same work (float32: bytes, or the faster of FFMA and
     three TF32 products), with the card's clocks, power and temperature
     read before and after; the network check
  6. one JSON line with both kernels' numbers, the card's name and power
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
FUNCTIONS = ("rosenbrock", "ackley", "fletcher_powell")
SCHEDULES = (True, False)            # symmetric (Alg. 8), full (Alg. 7)
CPU_SWEEP = [(16, 8, 2), (8, 16, 4), (8, 8, 8), (24, 12, 3), (8, 10, 4),
             (8, 9, 2), (5, 8, 2), (13, 7, 3), (4, 6, 16)]
WIDE_SWEEP = [(37, 100, 65), (37, 100, 96), (37, 100, 128), (9, 128, 128)]
# n on both sides of the largest n whose A^T and B^T Fletcher-Powell stages
# in shared memory: 168 at 4 lanes, 159 at 8, 55 at 64 (csize 40)
STAGING_SWEEP = [(3, 168, 4), (3, 169, 4), (3, 159, 8), (3, 160, 8),
                 (5, 55, 40), (5, 56, 40)]
RTOL = 5e-3                          # atol = RTOL * (1 + max|want|)
# chess_hvp's repairs at width: bfloat16 at the main path's scale, and
# chunks wider than 64 lanes (function, n, csize, symmetric) at M_WIDE
BF16_CASES = (("rosenbrock", True), ("fletcher_powell", True))
M_WIDE = 65536
WIDE_CASES = (("rosenbrock", 128, 128, False),
              ("fletcher_powell", 100, 96, True))
# hdual_linear's reference sweep (tests/test_kernels.py) and full-width
# cases (name, c, T, din, dout, dtype name)
LINEAR_SWEEP = [(6, 32, 16, 24, 32, 8, 16), (10, 128, 128, 128, 64, 128, 32),
                (4, 64, 32, 128, 16, 64, 32), (18, 8, 8, 8, 8, 8, 8)]
LINEAR_CASES = (("paper_c4", 4, M, N, N, "float32"),
                ("paper_c4", 4, M, N, N, "bfloat16"),
                ("paper_c8", 8, M, N, N, "float32"),
                ("wide_layer", 4, 4096, 2560, 2560, "float32"),
                ("wide_layer", 4, 4096, 2560, 2560, "bfloat16"))
LINEAR_TOL = {"float32": 1e-5, "bfloat16": 1e-1}   # atol = tol * din
# The full-width cases scale w by 1/sqrt(din), so their outputs are about
# N(0, 1) and the reference's din-scaled atol (set for |y| ~ sqrt(din)) would
# pass an all-zero output.  They are held at the output's own scale instead:
# kernel and plain version both sum exact-enough float32 products, in other
# orders (atol), and round the sum once to x.dtype (rtol: one bfloat16 ulp is
# at most 2**-7 of the value).
FULL_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
FULL_ATOL = 1e-5                     # atol = FULL_ATOL * (1 + max|want|)
PEAK_FP32 = 67e12                    # H100 SXM fp32 (non-tensor) FLOP/s
PEAK_TF32 = 495e12                   # H100 SXM tf32 dense tensor FLOP/s
PEAK_BF16 = 989e12                   # H100 SXM bf16 dense tensor FLOP/s
PEAK_BYTES = 3.35e12                 # H100 SXM HBM3 bytes/s
CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"


def smi_query(fields):
    """nvidia-smi's reading of the given fields for the first card."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def check_close(got, want, what):
    """Max abs error of got vs want; fails past the kernel tolerance."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if not (err <= RTOL * (1.0 + scale)):
        fail(f"{what}: max abs err {err:.3e} > {RTOL} * (1 + {scale:.3e})")
    return err


def within(got, want, rtol, atol):
    """(every element within atol + rtol * |want|, max abs err)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return bool((diff <= atol + rtol * want.abs()).all()), diff.max().item()


def check_elementwise(got, want, rtol, atol, what):
    """Every element within atol + rtol * |want|; returns the max abs err.
    Works in slices of the leading axis to bound the temporaries."""
    err = 0.0
    for k in range(got.shape[0]):
        ok, diff = within(got[k], want[k], rtol, atol)
        if not ok:
            fail(f"{what}: component {k} off by up to {diff:.3e} "
                 f"(rtol {rtol}, atol {atol})")
        err = max(err, diff)
    return err


def tf32(t):
    """float32 t rounded to TF32's 10 mantissa bits, as a TF32 tensor-core
    product reads its inputs."""
    import torch
    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)


def cuda_ms(fn, reps):
    """Mean CUDA-event time of reps calls, after one untimed call (the first
    call of a library kernel includes loading its module)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


TYPES = {"f": "float32", "13__nv_bfloat16": "bfloat16",
         "6__half": "float16"}


def kernel_name(entry):
    """A readable name for a mangled kernel entry of csrc/*.cu."""
    c = re.search(r"INS_\d+([A-Za-z]+)ELi(\d+)ELb([01])E", entry)
    if c:
        staged = ", staged" if c.group(3) == "1" else ""
        return f"chess_hvp<{c.group(1)}, C={c.group(2)}{staged}>"
    h = re.search(r"hdual_linear\d+(simt|tc)\d+(kernel|prep_w_kernel)I"
                  r"(f|13__nv_bfloat16|6__half)(?:Li(\d+)E)?E", entry)
    if h:
        variant = {"simt": "simt", "tc": "wgmma"}[h.group(1)]
        what = "prep_w" if h.group(2) == "prep_w_kernel" else variant
        bn = f", BN={h.group(4)}" if h.group(4) else ""
        return f"hdual_linear {what}<{TYPES[h.group(3)]}{bn}>"
    return entry


def ptxas_lines(log):
    """'<kernel>: R registers, S/L bytes spill stores/loads' per
    instantiation, from nvcc -Xptxas -v output."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(.*?)'", line)
        if m:
            name = kernel_name(m.group(1))
            spill = ("?", "?")
        elif name and "spill stores" in line:
            spill = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, {spill[0]} B spill stores,"
                       f" {spill[1]} B spill loads")
            name = None
    return out


def hgmma_counts(lib):
    """{kernel name: HGMMA instructions in its SASS} for every kernel of a
    built library, from cuobjdump -sass."""
    sass = subprocess.run([CUOBJDUMP, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            counts[name] = 0
        elif name and "HGMMA" in line:
            counts[name] += 1
    return counts


def linear_bound(ops, nbytes, dtype_name):
    """(bound ms, what bounds it, FFMA bound ms): the least time of the
    card's routes to the same result.  bfloat16: bytes or tensor-core
    operations.  float32: bytes, or operations by the faster float32-exact
    route, FFMA at 67 TFLOP/s or three TF32 products at 495 TFLOP/s; the
    FFMA-only bound is returned beside it, for comparison with earlier
    runs."""
    t_bytes = nbytes / PEAK_BYTES
    ffma = max(ops / PEAK_FP32, t_bytes) * 1e3
    if dtype_name == "float32":
        t_ops = min(ops / PEAK_FP32, 3 * ops / PEAK_TF32)
    else:
        t_ops = ops / PEAK_BF16
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_ops, t_bytes) * 1e3, by, ffma


def row_slices(m):
    """First, middle and last SAMPLE rows of an m-row batch."""
    return (0, m // 2 - SAMPLE // 2, m - SAMPLE)


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
    from repro_torch.core import hmath, ref, testfns
    from repro_torch.core.hdual import HDual, seed_point
    from repro_torch.kernels import build
    from repro_torch.kernels import chess_hvp as ck
    from repro_torch.kernels import hdual_linear as hl
    from repro_torch.kernels.ops import (hdual_linear, hdual_linear_apply,
                                         kernel_form)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False      # plain versions: IEEE
    torch.backends.cudnn.allow_tf32 = False
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    # 1. toolchain --------------------------------------------------------
    smi = smi_query("name,power.limit")
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32}")
    nvcc = build.nvcc_path()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    print(" ".join(line for line in version.splitlines() if "release" in line))

    # 2. build ------------------------------------------------------------
    t0 = time.time()
    libs = build.build_all()
    print(f"build: {time.time() - t0:.1f} s for {sorted(libs)} ({nvcc} "
          f"-gencode arch=compute_90a,code=sm_90a)")
    for name in sorted(libs):
        for line in ptxas_lines(build.build_log(name)):
            print(f"  {line}")
    hgmma = hgmma_counts(libs["hdual_linear"])
    wgmma_kernels = sorted(k for k in hgmma if "hdual_linear wgmma<" in k)
    print(f"  HGMMA instructions in the SASS: "
          f"{ {k: hgmma[k] for k in wgmma_kernels} }")
    for dname in ("float32", "bfloat16", "float16"):
        inst = [k for k in wgmma_kernels if f"<{dname}," in k]
        if not inst or not all(hgmma[k] for k in inst):
            fail(f"hdual_linear's {dname} tensor-core instantiations "
                 f"{inst} hold no HGMMA instruction")
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

    def points(seed, m, n, dtype=torch.float32):
        gen.manual_seed(seed)
        A = torch.rand(m, n, generator=gen, device=dev) * 4 - 2
        V = torch.randn(m, n, generator=gen, device=dev)
        return A.to(dtype), V.to(dtype)

    # 3. each kernel against its plain version at the tests' shapes -------
    sweeps = ([(s, torch.float32) for s in CPU_SWEEP + WIDE_SWEEP
               + STAGING_SWEEP]
              + [(s, torch.bfloat16) for s in CPU_SWEEP]
              + [(s, torch.float16) for s in CPU_SWEEP])
    for fname in FUNCTIONS:
        for (m, n, csize), dtype in sweeps:
            if dtype == torch.float16 and fname == "fletcher_powell":
                continue           # its HVPs (~1e5-1e6) overflow float16
            A, V = points(m * 131 + n, m, n, dtype)
            for symmetric in SCHEDULES:
                got = run_kernel(fname, A, V, csize, symmetric)
                if got.dtype != dtype:
                    fail(f"chess_hvp returned {got.dtype} for {dtype}")
                want = run_plain(fname, A, V, csize, symmetric)
                max_err = max(max_err, check_close(
                    got, want, f"{fname} m={m} n={n} csize={csize} "
                    f"symmetric={symmetric} {dtype}"))
    print(f"chess_hvp vs plain, test shapes (float32, bfloat16, float16, "
          f"csize 65-128, around the staging size): ok, max abs err "
          f"{max_err:.3e}", flush=True)

    lin_err = 0.0
    for K2, T, din, dout, bt, bo, bk in LINEAR_SWEEP:
        for dname, dtype in dtypes.items():
            gen.manual_seed(K2)
            x = torch.randn(K2, T, din, generator=gen, device=dev).to(dtype)
            w = torch.randn(din, dout, generator=gen, device=dev).to(dtype)
            tol = LINEAR_TOL[dname]
            lin_err = max(lin_err, check_elementwise(
                hdual_linear(x, w, bt=bt, bo=bo, bk=bk),
                hl.hdual_linear_plain(x, w), tol, tol * din,
                f"hdual_linear {(K2, T, din, dout)} {dname}"))
    print(f"hdual_linear vs plain, reference sweep shapes and tiles: ok, "
          f"max abs err {lin_err:.3e}", flush=True)

    # full-width data, and the plain version on row slices of it (at full
    # width its intermediates, (n, cells, m, 2c+2) floats, would not fit)
    data, cases = {}, {}
    for k, fname in enumerate(FUNCTIONS):
        A, V = data[fname] = points(1000 + k, M, N)
        for symmetric in SCHEDULES:
            csize = engine.model_csize(N, symmetric)
            plain, err = [], 0.0
            for r0 in reversed(row_slices(M)):    # ends on the first slice
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
                                                        symmetric, fname)[1],
                "plain_slices": plain, "max_abs_err_sample": err,
                "max_rel_err_float64": rel64,
                "sample_ms": cuda_ms(lambda: run_kernel(
                    fname, As, Vs, csize, symmetric), 3),
                "plain_sample_ms": cuda_ms(lambda: run_plain(
                    fname, As, Vs, csize, symmetric), 3)}
            print(f"{fname} symmetric={symmetric} csize={csize}: rows "
                  f"{row_slices(M)} (+{SAMPLE} each) vs plain max abs err "
                  f"{err:.3e}, vs float64 max rel err {rel64:.3e}",
                  flush=True)

    def zero_counts():
        ck.chess_hvp_cuda.launches = hl.hdual_linear_cuda.launches = 0
        hl.hdual_linear_cuda.launches_by_variant.update(
            dict.fromkeys(hl.VARIANTS, 0))

    # 4. chess_hvp's main path at full width ------------------------------
    zero_counts()
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
            for r0, want in zip(row_slices(M), case.pop("plain_slices")):
                max_err = max(max_err, check_close(
                    out[r0:r0 + SAMPLE], want,
                    f"{fname} main path rows {r0}:{r0 + SAMPLE} vs plain"))
            case["plan"] = p
    launches = ck.chess_hvp_cuda.launches
    if launches != len(cases) or hl.hdual_linear_cuda.launches:
        fail(f"main path launched chess_hvp {launches} times (expected "
             f"{len(cases)}) and hdual_linear "
             f"{hl.hdual_linear_cuda.launches} times (expected 0)")
    print(f"main path: {launches} launches of chess_hvp over "
          f"{len(cases)} batched_hvp calls", flush=True)

    total_ms = total_bound = total_dense = total_plain = total_sample = 0.0
    report = {}
    for (fname, symmetric), case in cases.items():
        A, V = data[fname]
        p = case.pop("plan")
        reps = 2 if fname == "fletcher_powell" else 5
        ms = cuda_ms(lambda: p.batched_hvp(A, V), reps)
        ops, nbytes = ck.needed_work(fname, M, N, case["csize"], symmetric)
        bound = max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
        dense_ops = ck.work(fname, M, N, case["csize"], symmetric)[0]
        dense = max(dense_ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
        if bound > ms:
            fail(f"{fname} symmetric={symmetric}: {ms:.3f} ms beats the "
                 f"needed bound {bound:.3f} ms")
        total_ms += ms
        total_bound += bound
        total_dense += dense
        total_plain += case["plain_sample_ms"]
        total_sample += case["sample_ms"]
        key = f"{fname}/{'symmetric' if symmetric else 'full'}"
        report[key] = dict(case, ms=ms, us_per_instance=ms * 1e3 / M,
                           bound_ms=bound, fp32_ops=ops, bytes=nbytes,
                           share=bound / ms, dense_bound_ms=dense,
                           dense_fp32_ops=dense_ops)
        print(f"{key}: {ms:.3f} ms per call, {ms * 1e3 / M:.5f} us per "
              f"instance, needed bound {bound:.3f} ms ({ops:.4e} fp32 ops, "
              f"{100 * bound / ms:.1f}%), dense bound {dense:.3f} ms, "
              f"{SAMPLE}-row sample: kernel {case['sample_ms']:.3f} ms, "
              f"plain {case['plain_sample_ms']:.3f} ms", flush=True)

    # the repairs through the same path: bfloat16 A and V, and chunks wider
    # than 64 lanes resolved by backend="auto"
    repairs = {}
    bf16_runs = [(fname, N, engine.model_csize(N, symmetric), symmetric, M,
                  torch.bfloat16) for fname, symmetric in BF16_CASES]
    wide_runs = [(fname, n, csize, symmetric, M_WIDE, torch.float32)
                 for fname, n, csize, symmetric in WIDE_CASES]
    for k, (fname, n, csize, symmetric, m, dtype) in enumerate(
            bf16_runs + wide_runs):
        A, V = points(2000 + k, m, n, dtype)
        f = testfns.FUNCTIONS[fname](n)
        p = engine.plan(f, n, m=m, csize=csize, symmetric=symmetric)
        if p.backend_for("batched_hvp") != "cuda":
            fail(f"{p.describe()} resolved to {p.backend_for('batched_hvp')}")
        before = ck.chess_hvp_cuda.launches
        out = p.batched_hvp(A, V)
        torch.cuda.synchronize()
        if ck.chess_hvp_cuda.launches != before + 1:
            fail(f"{p.describe()}: the kernel was not launched once")
        if out.dtype != dtype or not bool(torch.isfinite(out).all()):
            fail(f"{p.describe()}: output not finite or not {dtype}")
        err = 0.0
        for r0 in row_slices(m):
            As, Vs = A[r0:r0 + SAMPLE], V[r0:r0 + SAMPLE]
            err = max(err, check_close(
                out[r0:r0 + SAMPLE], run_plain(fname, As, Vs, csize,
                                               symmetric),
                f"{p.describe()} rows {r0}:{r0 + SAMPLE}"))
            torch.cuda.empty_cache()
        max_err = max(max_err, err)
        reps = 1 if fname == "fletcher_powell" else 3
        ms = cuda_ms(lambda: p.batched_hvp(A, V), reps)
        ops, nbytes = ck.needed_work(fname, m, n, csize, symmetric,
                                     itemsize=A.element_size())
        bound = max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
        dense = max(ck.work(fname, m, n, csize, symmetric)[0] / PEAK_FP32,
                    nbytes / PEAK_BYTES) * 1e3
        key = (f"{fname}/{'symmetric' if symmetric else 'full'}/n={n}/"
               f"csize={csize}/m={m}/{str(dtype).split('.')[-1]}")
        if bound > ms:
            fail(f"{key}: {ms:.3f} ms beats the needed bound {bound:.3f} ms")
        repairs[key] = {"ms": ms, "bound_ms": bound, "fp32_ops": ops,
                        "share": bound / ms, "dense_bound_ms": dense,
                        "bytes": nbytes, "max_abs_err_sample": err,
                        "sub_cells": len(ck.sub_cells(n, csize,
                                                      symmetric)[0])}
        print(f"{key}: backend cuda, {ms:.3f} ms per call, needed bound "
              f"{bound:.3f} ms ({100 * bound / ms:.1f}%), dense bound "
              f"{dense:.3f} ms, rows {row_slices(m)} vs plain max abs err "
              f"{err:.3e}", flush=True)

    # 5. hdual_linear's path at full width --------------------------------
    del data
    torch.cuda.empty_cache()

    def hdual_points(seed, c, T, din, dout, dtype):
        gen.manual_seed(seed)
        comps = [torch.randn(*shape, generator=gen, device=dev).to(dtype)
                 for shape in ((T, din), (T, din), (T, din, c), (T, din, c))]
        w = (torch.randn(din, dout, generator=gen, device=dev)
             / din ** 0.5).to(dtype)
        return HDual(*comps), w

    def stacked(hd):
        return torch.cat([hd.val[None], hd.di[None], hd.dj.movedim(-1, 0),
                          hd.dij.movedim(-1, 0)], dim=0)

    zero_counts()
    lin_cases = {}
    by_variant = hl.hdual_linear_cuda.launches_by_variant
    for k, (name, c, T, din, dout, dname) in enumerate(LINEAR_CASES):
        hd, w = hdual_points(3000 + k, c, T, din, dout, dtypes[dname])
        before = hl.hdual_linear_cuda.launches
        before_wgmma = by_variant["wgmma"]
        out = hdual_linear_apply(hd, w)
        torch.cuda.synchronize()
        if hl.hdual_linear_cuda.launches != before + 1:
            fail(f"hdual_linear_apply {name} did not launch the kernel once")
        if by_variant["wgmma"] != before_wgmma + 1:
            fail(f"hdual_linear_apply {name} {dname} did not run on the "
                 f"wgmma variant ({by_variant})")
        if not all(t.is_contiguous() for t in (out.val, out.di, out.dj,
                                                out.dij)):
            fail(f"hdual_linear_apply {name}: outputs not contiguous")
        if out.shape != (T, dout) or out.csize != c:
            fail(f"hdual_linear_apply {name}: value shape {out.shape}")
        x, y = stacked(hd), stacked(out)
        want = hl.hdual_linear_plain(x, w)
        rtol = FULL_RTOL[dname]
        atol = FULL_ATOL * (1.0 + want.abs().max().item())
        err = check_elementwise(y, want, rtol, atol,
                                f"hdual_linear {name} {dname}")
        # the bound has teeth: it rejects an all-zero output and, in
        # float32, the product a TF32 kernel would give on these inputs
        controls = {"zeros": torch.zeros_like(want[0])}
        if dname == "float32":
            controls["tf32"] = hl.hdual_linear_plain(tf32(x[:1]),
                                                     tf32(w))[0]
        for what, bad in controls.items():
            if within(bad, want[0], rtol, atol)[0]:
                fail(f"hdual_linear {name} {dname}: the check passes a "
                     f"{what} output (rtol {rtol}, atol {atol:.3e})")
        lin_cases[(name, dname)] = (hd, w, x, err, rtol, atol, list(controls))
        del want, controls
    lin_launches = hl.hdual_linear_cuda.launches
    if (lin_launches != len(LINEAR_CASES) or ck.chess_hvp_cuda.launches
            or by_variant != {"simt": 0, "wgmma": len(LINEAR_CASES)}):
        fail(f"hdual_linear path launched hdual_linear {lin_launches} times "
             f"({by_variant}; expected {len(LINEAR_CASES)}, all wgmma) and "
             f"chess_hvp {ck.chess_hvp_cuda.launches} times (expected 0)")
    print(f"hdual_linear path: {lin_launches} launches over "
          f"{len(LINEAR_CASES)} hdual_linear_apply calls, by variant "
          f"{by_variant}", flush=True)

    clocks = "clocks.sm,clocks.mem,power.draw,temperature.gpu"
    print(f"before the hdual_linear timings: {clocks} = {smi_query(clocks)}",
          flush=True)
    lin_report = {}
    lin_tot = dict.fromkeys(("ms", "apply_ms", "simt_ms", "plain_ms",
                             "bound_ms", "ffma_bound_ms", "library_ms"), 0.0)
    bound_by_ms = {"bytes": 0.0, "operations": 0.0}
    for (name, c, T, din, dout, dname) in LINEAR_CASES:
        hd, w, x, err, rtol, atol, rejected = lin_cases.pop((name, dname))
        K2 = 2 * c + 2
        before = dict(by_variant)
        apply_ms = cuda_ms(lambda: hdual_linear_apply(hd, w), 5)
        ms = cuda_ms(lambda: hdual_linear(x, w), 5)
        simt_ms = cuda_ms(lambda: hl.hdual_linear_cuda(x, w, variant="simt"),
                          3)
        if by_variant != {"simt": before["simt"] + 3 + 1,
                          "wgmma": before["wgmma"] + 2 * (5 + 1)}:
            fail(f"hdual_linear {name}: not one launch per call "
                 f"({before} -> {by_variant})")
        plain_ms = cuda_ms(lambda: hl.hdual_linear_plain(x, w), 3)
        x2 = x.reshape(K2 * T, din)
        library_ms = cuda_ms(lambda: torch.matmul(x2, w), 5)
        ops, nbytes = hl.work(K2, T, din, dout, x.element_size())
        bound, bound_by, ffma_bound = linear_bound(ops, nbytes, dname)
        key = f"{name}/{dname}"
        lin_report[key] = {
            "K2": K2, "T": T, "din": din, "dout": dout, "ms": ms,
            "apply_ms": apply_ms, "simt_ms": simt_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound,
            "bound_by": bound_by, "ffma_bound_ms": ffma_bound, "ops": ops,
            "bytes": nbytes, "max_abs_err": err, "rtol": rtol, "atol": atol,
            "controls_rejected": rejected}
        for field in lin_tot:
            lin_tot[field] += lin_report[key][field]
        bound_by_ms[bound_by] += bound
        lin_err = max(lin_err, err)
        print(f"hdual_linear {key} (K2={K2}, T={T}, {din}x{dout}): kernel "
              f"(wgmma) {ms:.3f} ms, hdual_linear_apply {apply_ms:.3f} ms, "
              f"simt variant {simt_ms:.3f} ms, bound {bound:.3f} ms "
              f"({bound_by}; FFMA-only {ffma_bound:.3f} ms), plain "
              f"{plain_ms:.3f} ms, torch.matmul {library_ms:.3f} ms, max abs "
              f"err {err:.3e} (rtol {rtol}, atol {atol:.3e}; rejects "
              f"{' and '.join(rejected)})", flush=True)
        del hd, w, x, x2
        torch.cuda.empty_cache()

    print(f"after the hdual_linear timings: {clocks} = {smi_query(clocks)}",
          flush=True)

    # the reference test's use of the entry point: sin(x W1) then . W2,
    # with one (row, chunk) cell seeded at T points
    n, hidden, T, c, row, cstart = N, 2560, 4096, 4, 5, 8
    gen.manual_seed(4000)
    W1 = torch.randn(n, hidden, generator=gen, device=dev) / n ** 0.5
    W2 = torch.randn(hidden, 1, generator=gen, device=dev) / hidden ** 0.5
    a = torch.randn(T, n, generator=gen, device=dev)
    y = seed_point(a.T, row, cstart, c)         # value shape (n, T)
    y = HDual(y.val.T, y.di.T, y.dj.movedim(0, 1), y.dij.movedim(0, 1))
    before = hl.hdual_linear_cuda.launches
    z = hmath.sin(hdual_linear_apply(y, W1))
    out = z.sum(-1) + hdual_linear_apply(z, W2)[:, 0]
    torch.cuda.synchronize()
    if hl.hdual_linear_cuda.launches != before + 2:
        fail("network: hdual_linear_apply did not launch twice")
    if out.dij.shape != (T, c) or not bool(torch.isfinite(out.dij).all()):
        fail("network: Hessian chunk not finite or of shape (T, c)")

    def net(p):
        h = torch.sin(p @ W1.double())
        return h.sum() + (h @ W2.double())[0]

    net_err = 0.0
    for t in (0, T // 2, T - 1):
        H = torch.func.hessian(net)(a[t].double())
        want = H[row, cstart:cstart + c]
        diff = (out.dij[t].double() - want).abs()
        if not bool((diff <= 1e-4 + 1e-3 * want.abs()).all()):
            fail(f"network: point {t} Hessian chunk off by "
                 f"{diff.max().item():.3e} (rtol 1e-3, atol 1e-4)")
        net_err = max(net_err, diff.max().item())
    print(f"network sin(x W1) . W2 (n={n}, hidden={hidden}, T={T}, c={c}): "
          f"H[{row}, {cstart}:{cstart + c}] vs float64 torch.func.hessian "
          f"max abs err {net_err:.3e}", flush=True)

    # 6. results ----------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "chess_hvp", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/chess_hvp.cu",
        "replaces": "src/repro/kernels/chess_hvp.py:158",
        "launches": launches, "max_abs_err": max_err,
        "ms": total_ms, "plain_ms": total_plain, "bound_ms": total_bound,
        "bound_by": "operations", "library_ms": None,
        "dense_bound_ms": total_dense,
        "sample_rows": SAMPLE, "sample_ms": total_sample,
        "shape": {"m": M, "n": N}, "cases": report, "repairs": repairs}, {
        "name": "hdual_linear", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hdual_linear.cu",
        "replaces": "src/repro/kernels/hdual_linear.py:44",
        "launches": lin_launches, "max_abs_err": lin_err,
        "ms": lin_tot["ms"], "plain_ms": lin_tot["plain_ms"],
        "bound_ms": lin_tot["bound_ms"],
        "bound_by": max(bound_by_ms, key=bound_by_ms.get),
        "library_ms": lin_tot["library_ms"],
        "apply_ms": lin_tot["apply_ms"], "simt_ms": lin_tot["simt_ms"],
        "ffma_bound_ms": lin_tot["ffma_bound_ms"],
        "launches_by_variant": {"wgmma": lin_launches, "simt": 0},
        "hgmma_in_sass": {k: hgmma[k] for k in wgmma_kernels},
        "cases": lin_report, "network_max_abs_err": net_err}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
