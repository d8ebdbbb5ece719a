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
* the tuner: ``engine.plan(f, 64, m=524288, csize="autotune")`` for the
  three functions on both schedules -- the joint csize x backend x blk_m
  sweep on the card, where ``blk_m`` is chess_hvp's instances per CTA --
  then each tuned plan's ``batched_hvp`` at full width; a second process on
  the same store; every instance block against the kernel's own pick; and
  the service's default online re-tune (``autotune_buckets``).
* the served path: ``CurvatureService`` + ``CurvatureFrontend`` built as
  ``repro_torch.launch.serve`` builds them, on the card, 8 TCP clients:
  2,048 HVPs of each test function at n = 64, 1,024 Rosenbrock HVPs at
  n in {48, 56, 64} and 8 Hessians at n = 16; every dense HVP bucket runs
  chess_hvp, mixed-n buckets the ragged torch.func path.
* pytree curvature: ``engine.plan(tgt.loss, None, device="cuda", ...)`` on
  the full-width h2o-danube-1.8b loss (1.83B float32 params, bfloat16
  compute, 2 x 512 tokens): hvp, quadform, ggn, fisher and diag, and diag
  through a service; no kernel lies on this path (torch.func).

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
     read before and after
  6. the network check: sin(x W1) . W2 through two hdual_linear_apply maps,
     one Hessian chunk against float64 torch.func.hessian
  7. the tuner on the card (store: a fresh ``chiprun_out/autotune_store.json``
     named by ``REPRO_TORCH_AUTOTUNE_CACHE``): (a) the six
     ``plan(..., csize="autotune")`` sweeps, each winner on ``cuda`` with no
     ``cuda`` candidate raising, printed with its candidate count, sweep
     time and probes; (b) the six tuned plans' ``batched_hvp`` at m =
     524,288 (counts zeroed before, read after): one launch a call, the
     first, middle and last 256 rows against the plain version at phase 4's
     tolerance, CUDA-event times beside the ``csize="auto"`` plan's in
     turns, against the needed bound; (c) a second process (``repro_torch``
     only) on the same store plans the same six with zero probes, to the
     same winners; (d) every ``instance_blocks`` entry of each function at
     n = 64, both schedules, and ``ipb=None``, against the plain version at
     the kernel tolerance, timed on 64- and 256-row buckets; (e) the server
     built as phase 8 builds it with no ``tuner=``: one dense round,
     ``svc.retune()`` (hot swaps > 0, no errors, every swapped bucket on
     ``cuda``), the round again with every row checked, every batched_hvp
     bucket on ``cuda`` and chess_hvp's launches equal to the ``cuda``
     batches; us per point by queue and bucket before and after
  8. the served path (counts and telemetry zeroed before its traffic and
     read after): the server on 127.0.0.1, ``max_batch`` 256,
     ``max_wait_us`` 500, cross-n on, ``symmetric=False``; 8 clients, each
     on its own thread with 32 requests in flight, priorities mixed as in
     the server's selftest.  Every dense HVP row against chess_hvp's plain
     version (rtol 5e-3, atol 5e-3 * (1 + max|want|)); every mixed-n row
     and Hessian against float64 torch.func (relative 1e-3, the selftest's
     bound); chess_hvp's launches equal to the batched_hvp batches the
     telemetry records, every one of them on backend ``cuda``; ragged
     batches > 0; one dense bucket under ``obs.profile_session``, whose
     trace must name the kernel and its ``repro:batched_hvp:cuda:b<k>``
     range.  Prints requests per second, p50/p99 round trip, batches and
     rows by bucket, each queue's us per point, and the same points
     through one ``plan.batched_hvp`` call (CUDA events)
  9. pytree curvature (kernel launch counts read before and after: the
     phase launches neither kernel).  (a) The full-width h2o-danube-1.8b
     loss, params and tokens (B = 2, S = 512) from a seeded generator on
     the card, ``lm_curvature_targets``, one plan (``n_probes`` 4, csize
     1) whose hvp/diag/ggn/fisher resolve to ``pytree_fwdrev`` and
     quadform to ``pytree_fwd``: each workload's CUDA-event ms (median of
     3 after a warm-up) and peak memory, against the least time for its
     matmul passes (bfloat16 rate; float32 score products at the FFMA
     rate).  Fatal: every output finite; v.Hv from hvp against
     quadform(v, v), and w.Hv against v.Hw, within 1e-3 of ||v|| ||Hv||
     (the bfloat16 bound of the CPU test of the same pair); v.Gv and v.Fv
     >= 0; the diag submitted through a service with budget 4 bitwise
     ``plan.diag`` for the same seed (budget 2 beside it).  (b) The
     reduced config at float32 compute: the same params, v, w and probes
     through the five workloads and block_hessian on the CPU and on the
     card (normalized error 1e-4); then 16 HVP and 8 budgeted diag submits
     from 4 threads to a service on the card, fewer batches than
     requests, every row bitwise the direct call
 10. a ``curvature`` JSON line with phase 9's numbers; one JSON line with
     both kernels' numbers (the tuner's under chess_hvp's ``tuning``, the
     served path's under ``serving``), the card's name and power limit,
     and a last line ``{"ok": true, "device": {...}}``

Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.  Imports nothing of JAX or of the ``repro`` package.
"""

from __future__ import annotations

import functools
import json
import os
import re
import subprocess
import sys
import threading
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
# the served path (phase 8): requests per test function at N, Rosenbrock
# requests at mixed n, Hessians at SERVE_HESSIAN_N, client threads, requests
# each client keeps in flight, and the server's knobs
SERVE_DENSE = 2048
SERVE_MIXED = 1024
SERVE_MIXED_NS = (48, 56, 64)
SERVE_HESSIANS = 8
SERVE_HESSIAN_N = 16
SERVE_CLIENTS = 8
SERVE_WINDOW = 32
SERVE_MAX_BATCH = 256
SERVE_MAX_WAIT_US = 500.0
SERVE_REL64 = 1e-3                   # max|got - want| / max|want|, float64
SERVE_PROFILE_ROWS = 64
# the tuner's phase: bucket sizes each instance block is timed at
SWEEP_ROWS = (64, 256)


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


def host_ms(fn, reps):
    """Mean host time of reps calls with no synchronize between them: the
    rate at which the host enqueues the work.  Where it nears cuda_ms's
    time of the same calls, the host, not the card, sets that time."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / reps * 1e3


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


def drive_clients(connect, address, jobs):
    """Run ``jobs`` -- (method, plan name, a, v or None) -- through
    SERVE_CLIENTS connections, one thread each, job i on client
    i % SERVE_CLIENTS with at most SERVE_WINDOW of its requests in flight,
    priority interactive for every third job (as the server's selftest
    mixes them).  Returns (results, round-trip seconds, wall seconds); a
    request the server failed fails the phase."""
    results, latency, errors = [None] * len(jobs), [None] * len(jobs), []

    def client(c):
        window = threading.Semaphore(SERVE_WINDOW)
        futs = []
        try:
            with connect(*address, client=f"smoke-{c}") as cli:
                for i in range(c, len(jobs), SERVE_CLIENTS):
                    method, name, a, v = jobs[i]
                    pr = "interactive" if i % 3 == 0 else "batch"
                    if not window.acquire(timeout=120):
                        raise TimeoutError("no response in 120 s")
                    t0 = time.perf_counter()
                    if method == "hvp":
                        fut = cli.submit_hvp(name, a, v, priority=pr)
                    else:
                        fut = cli.submit_hessian(name, a, priority=pr)

                    def done(f, i=i, t0=t0):
                        latency[i] = time.perf_counter() - t0
                        window.release()
                    fut.add_done_callback(done)
                    futs.append((i, fut))
                for i, fut in futs:
                    results[i] = fut.result(timeout=300)
        except Exception as e:          # reported by the main thread
            errors.append(f"client {c}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        fail("served requests failed: " + "; ".join(errors[:4]))
    return results, latency, wall


def dense_rounds(rng):
    """The dense round of phases 7 and 8: SERVE_DENSE HVPs of each
    function at N, the functions interleaved; returns (data by function,
    jobs)."""
    dense = {}
    for fname in FUNCTIONS:
        dense[fname] = (rng.uniform(-2, 2, (SERVE_DENSE, N)).astype("f4"),
                        rng.randn(SERVE_DENSE, N).astype("f4"))
    jobs = [("hvp", fname, dense[fname][0][i], dense[fname][1][i])
            for i in range(SERVE_DENSE) for fname in FUNCTIONS]
    return dense, jobs


def check_dense(results, dense, dev, what):
    """Every served dense row against chess_hvp's plain version at the
    kernel tolerance; returns the max abs error."""
    import numpy as np
    import torch
    from repro_torch import engine
    from repro_torch.core import testfns
    from repro_torch.kernels import chess_hvp as ck
    from repro_torch.kernels.ops import kernel_form

    csize = engine.model_csize(N, False)
    err = 0.0
    for k, fname in enumerate(FUNCTIONS):
        got = torch.as_tensor(np.asarray(results[k::len(FUNCTIONS)], "f4"),
                              device=dev)
        A, V = (torch.as_tensor(x, device=dev) for x in dense[fname])
        kf, consts, _ = kernel_form(testfns.FUNCTIONS[fname](N))
        consts = tuple(c.to(dev) for c in consts)
        for r0 in range(0, SERVE_DENSE, SAMPLE):
            sl = slice(r0, r0 + SAMPLE)
            err = max(err, check_close(
                got[sl], ck.chess_hvp_plain(kf, A[sl], V[sl], csize, consts,
                                            False),
                f"{what} {fname} rows {r0}:{r0 + SAMPLE} vs plain"))
    return err


def queue_report(records, tag):
    """Batches, rows and us per point by queue and bucket, from
    ``engine.execution_stats()`` records; printed and returned."""
    queues = []
    for r in records:
        sig = r["signature"]
        fname = getattr(sig[0], "__name__", repr(sig[0]))
        for b, info in r["by_bucket"].items():
            queues.append({"f": fname, "n": sig[1], "workload": r["workload"],
                           "backend": r["backend"], "bucket": b,
                           "csize": sig[2], "blk_m": dict(sig[8]).get("blk_m"),
                           "batches": info["executions"],
                           "rows": info["points"],
                           "us_per_point": info["us_per_point_mean"]})
    queues.sort(key=lambda q: (q["workload"], q["f"], q["n"], q["bucket"],
                               q["backend"]))
    for q in queues:
        print(f"{tag}   {q['workload']} {q['f']} n={q['n']} {q['backend']} "
              f"csize {q['csize']} blk_m {q['blk_m']} "
              f"bucket {q['bucket']}: {q['batches']} batches, "
              f"{q['rows'] / q['batches']:.1f} rows per batch, "
              f"{q['us_per_point']:.3f} us per point (kernel + readback)",
              flush=True)
    return queues


def serve_phase(smi, dev, zero_counts):
    """Phase 8: the served path on the card, with the server built as
    ``repro_torch.launch.serve`` builds it.  Returns its numbers."""
    from repro_torch import engine
    from repro_torch.launch.serve import build_plans
    from repro_torch.serving.frontend import CurvatureFrontend

    plans = build_plans(FUNCTIONS, symmetric=False, device=dev)
    svc = engine.CurvatureService(max_batch=SERVE_MAX_BATCH,
                                  max_wait_us=SERVE_MAX_WAIT_US,
                                  coalesce_across_n=True)
    fe = CurvatureFrontend(plans, service=svc, host="127.0.0.1", port=0)
    fe.start()
    try:
        return _serve_phase(smi, dev, zero_counts, fe, svc, plans)
    finally:
        fe.stop()
        svc.shutdown(wait=True)


def _serve_phase(smi, dev, zero_counts, fe, svc, plans):
    import numpy as np
    import torch
    from repro_torch import engine, obs
    from repro_torch.core import ref, testfns
    from repro_torch.kernels import chess_hvp as ck
    from repro_torch.kernels import hdual_linear as hl
    from repro_torch.serving.frontend import connect

    tag = f"[{smi}]"
    rng = np.random.RandomState(5000)
    dense, dense_jobs = dense_rounds(rng)
    mixed_n = rng.choice(SERVE_MIXED_NS, SERVE_MIXED)
    mixed = [(rng.uniform(-2, 2, n).astype("f4"), rng.randn(n).astype("f4"))
             for n in mixed_n]
    hess = [(FUNCTIONS[i % len(FUNCTIONS)],
             rng.uniform(-2, 2, SERVE_HESSIAN_N).astype("f4"))
            for i in range(SERVE_HESSIANS)]
    rounds = {
        "dense": dense_jobs,
        "mixed_n": [("hvp", "rosenbrock", a, v) for a, v in mixed],
        "hessian": [("hessian", fname, a, None) for fname, a in hess]}

    # the phase's counts start here: launches, telemetry, metrics
    zero_counts()
    engine.clear_telemetry()
    obs.reset()
    served, report = {}, {}
    for name, jobs in rounds.items():
        results, latency, wall = drive_clients(connect, fe.address, jobs)
        served[name] = results
        lat_ms = np.asarray(latency) * 1e3
        report[name] = {"requests": len(jobs), "wall_s": wall,
                        "requests_per_s": len(jobs) / wall,
                        "p50_ms": float(np.percentile(lat_ms, 50)),
                        "p99_ms": float(np.percentile(lat_ms, 99))}
        print(f"{tag} served {name}: {len(jobs)} requests in {wall:.3f} s, "
              f"{len(jobs) / wall:.1f} requests/s, round trip p50 "
              f"{report[name]['p50_ms']:.3f} ms, p99 "
              f"{report[name]['p99_ms']:.3f} ms", flush=True)
    torch.cuda.synchronize()
    launches = ck.chess_hvp_cuda.launches
    stats = svc.stats()
    records = engine.execution_stats()
    executions = obs.metrics_registry().value(
        "repro_executions_total", backend="cuda", workload="batched_hvp")
    hvp_recs = [r for r in records if r["workload"] == "batched_hvp"]
    not_cuda = sorted({r["backend"] for r in hvp_recs} - {"cuda"})
    batches = sum(b["executions"] for r in hvp_recs
                  for b in r["by_bucket"].values())
    rows = sum(b["points"] for r in hvp_recs
               for b in r["by_bucket"].values())
    if not_cuda:
        fail(f"served batched_hvp buckets ran on {not_cuda}, not cuda")
    if not (launches == batches == executions and launches > 0):
        fail(f"served path: chess_hvp launched {launches} times, the "
             f"telemetry records {batches} batched_hvp batches and the "
             f"metrics {executions}")
    if hl.hdual_linear_cuda.launches:
        fail("served path launched hdual_linear")
    if stats["ragged_batches"] <= 0:
        fail(f"served path formed no ragged batch ({stats})")
    print(f"{tag} served path: {launches} chess_hvp launches = {batches} "
          f"batched_hvp batches in the telemetry (all backend cuda), "
          f"{rows / batches:.1f} rows per launch; {stats['batches']} "
          f"batches in all, {stats['ragged_batches']} ragged "
          f"({stats['ragged_points']} rows), {stats.get('cross_n_fills', 0)}"
          f" cross-n fills, {stats['padded_rows']} padded rows", flush=True)

    # every served result against its reference
    dense_err = check_dense(served["dense"], dense, dev, "served")
    rel64 = 0.0
    for n in SERVE_MIXED_NS:
        idx = [i for i, m in enumerate(mixed_n) if m == n]
        A64 = torch.as_tensor(np.stack([mixed[i][0] for i in idx]),
                              device=dev).double()
        V64 = torch.as_tensor(np.stack([mixed[i][1] for i in idx]),
                              device=dev).double()
        want = torch.func.vmap(lambda a, v: ref.hvp_fwdrev(
            testfns.rosenbrock, a, v))(A64, V64)
        got = torch.as_tensor(np.asarray([served["mixed_n"][i]
                                          for i in idx]), device=dev)
        rel = ((got.double() - want).abs().amax(1)
               / want.abs().amax(1)).max().item()
        if not rel <= SERVE_REL64:
            fail(f"served mixed-n rows at n={n}: relative error {rel:.3e}")
        rel64 = max(rel64, rel)
    for (fname, a), got in zip(hess, served["hessian"]):
        f = testfns.FUNCTIONS[fname](SERVE_HESSIAN_N)
        want = ref.hessian_fwdrev(f, torch.as_tensor(a, device=dev).double())
        got = torch.as_tensor(np.asarray(got), device=dev).double()
        if got.shape != want.shape:
            fail(f"served {fname} Hessian of shape {tuple(got.shape)}")
        rel = ((got - want).abs().max() / want.abs().max()).item()
        if not rel <= SERVE_REL64:
            fail(f"served {fname} Hessian: relative error {rel:.3e}")
        rel64 = max(rel64, rel)
    print(f"{tag} served results: dense rows vs plain max abs err "
          f"{dense_err:.3e}; mixed-n rows and Hessians vs float64 max rel "
          f"err {rel64:.3e}", flush=True)

    # batches, rows and us per point by queue and bucket
    queues = queue_report(records, tag)

    # one dense bucket under the profiler: the trace names the kernel and
    # the dispatcher's range
    prof_dir = ROOT / "chiprun_out" / "serving_profile"
    plan = plans["rosenbrock"](N)
    A, V = dense["rosenbrock"]
    with obs.profile_session(str(prof_dir)) as where:
        if where is None:
            fail("the profiler did not start")
        futs = [svc.submit(plan, A[i], V[i])
                for i in range(SERVE_PROFILE_ROWS)]
        for f in futs:
            f.result(timeout=120)
        torch.cuda.synchronize()
    trace = max(prof_dir.glob("repro_torch_trace_*.json"),
                key=lambda p: p.stat().st_mtime)
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if "chess_hvp_kernel" in str(e.get("name"))
               and e.get("cat") == "kernel"]
    ranges = [e for e in events
              if str(e.get("name")).startswith("repro:batched_hvp:cuda:b")]
    if not kernels or not ranges:
        fail(f"the profiler trace {trace} names the kernel {len(kernels)} "
             f"times and the range {len(ranges)} times")
    profile = {"trace": str(trace.relative_to(ROOT)),
               "kernel_us": [e.get("dur") for e in kernels],
               "ranges": [(e["name"], e.get("cat"), e.get("dur"))
                          for e in ranges]}
    print(f"{tag} profiler trace {profile['trace']}: chess_hvp_kernel "
          f"{profile['kernel_us']} us inside ranges {profile['ranges']} us",
          flush=True)

    # the same points through one batched_hvp call per function
    direct = {}
    for fname in FUNCTIONS:
        p = plans[fname](N)
        A, V = (torch.as_tensor(x, device=dev) for x in dense[fname])
        ms = cuda_ms(lambda: p.batched_hvp(A, V), 3)
        ops, nbytes = ck.needed_work(fname, SERVE_DENSE, N, p.csize, False)
        bound = max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
        served_us = sum(q["us_per_point"] * q["rows"] for q in queues
                        if q["f"] == getattr(p.f, "__name__", "")
                        and q["n"] == N and q["workload"] == "batched_hvp")
        served_rows = sum(q["rows"] for q in queues
                          if q["f"] == getattr(p.f, "__name__", "")
                          and q["n"] == N
                          and q["workload"] == "batched_hvp")
        direct[fname] = {"batched_hvp_ms": ms,
                         "us_per_point": ms * 1e3 / SERVE_DENSE,
                         "served_us_per_point": served_us / served_rows,
                         "bound_ms": bound}
        print(f"{tag} {fname} n={N}: one batched_hvp of {SERVE_DENSE} points"
              f" {ms:.3f} ms ({ms * 1e3 / SERVE_DENSE:.4f} us per point, "
              f"needed bound {bound:.3f} ms); served "
              f"{served_us / served_rows:.4f} us per point", flush=True)
    return {"launches": launches, "batches": stats["batches"],
            "batched_hvp_batches": batches, "rows_per_launch": rows / batches,
            "ragged_batches": stats["ragged_batches"],
            "ragged_rows": stats["ragged_points"],
            "cross_n_fills": stats.get("cross_n_fills", 0),
            "padded_rows": stats["padded_rows"],
            "buckets": {str(b): c for b, c in stats["buckets"].items()},
            "max_abs_err_dense": dense_err, "max_rel_err_float64": rel64,
            "rounds": report, "queues": queues, "direct": direct,
            "profile": profile,
            "config": {"max_batch": SERVE_MAX_BATCH,
                       "max_wait_us": SERVE_MAX_WAIT_US,
                       "clients": SERVE_CLIENTS, "window": SERVE_WINDOW}}


WARM_SCRIPT = """\
import json, sys
import torch
from repro_torch import engine
from repro_torch.core import testfns
dev = torch.device("cuda", 0)
winners = {{}}
for fname in {functions!r}:
    f = testfns.FUNCTIONS[fname]({n})
    for symmetric in {schedules!r}:
        p = engine.plan(f, {n}, m={m}, csize="autotune", symmetric=symmetric,
                        device=dev)
        cfg = engine.lookup_tuned(p, "batched_hvp")
        winners[f"{{fname}}/{{symmetric}}"] = [
            cfg.backend, cfg.csize, cfg.blk_m, cfg.source,
            p.backend_for("batched_hvp")]
foreign = sorted(k for k in sys.modules
                 if k == "repro" or k.startswith(("repro.", "jax")))
print(json.dumps({{"probes": engine.probe_count(), "winners": winners,
                  "foreign": foreign}}))
"""


def tune_phase(smi, dev, zero_counts, points):
    """Phase 7: the tuner on the card.  (a) ``plan(f, N, m=M,
    csize="autotune")`` for each function and schedule: a cuda winner, no
    cuda candidate raising; (b) the six tuned plans' batched_hvp at full
    width (counts zeroed before, read after): one launch a call, sample
    rows against the plain version, CUDA-event times beside the
    ``csize="auto"`` plan's in turns (auto, tuned, tuned, auto) against the
    needed bound; (c) a second process on the same store plans the same
    six with zero probes to the same winners; (d) every instance block of
    ``chess_hvp`` at n = N, and the kernel's own pick, against the plain
    version, and its time on SWEEP_ROWS-row buckets; (e) the service's default re-tune on phase 8's
    dense round.  Returns the numbers."""
    import torch
    from repro_torch import engine
    from repro_torch.core import testfns
    from repro_torch.kernels import chess_hvp as ck
    from repro_torch.kernels import hdual_linear as hl
    from repro_torch.kernels.ops import kernel_form

    tag = f"[{smi}]"
    sched = {True: "symmetric", False: "full"}
    report = {"store": os.environ["REPRO_TORCH_AUTOTUNE_CACHE"],
              "offline": {}, "full_width": {}, "instance_blocks": {}}

    @functools.lru_cache(maxsize=None)
    def form(fname, n):
        kf, consts, device_fn = kernel_form(testfns.FUNCTIONS[fname](n))
        return kf, tuple(c.to(dev) for c in consts), device_fn

    # (a) the offline sweeps, through plan()
    tuned = {}
    for fname in FUNCTIONS:
        f = testfns.FUNCTIONS[fname](N)
        for symmetric in SCHEDULES:
            key = f"{fname}/{sched[symmetric]}"
            probes = engine.probe_count()
            t0 = time.perf_counter()
            p = engine.plan(f, N, m=M, csize="autotune", symmetric=symmetric,
                            device=dev)
            wall = time.perf_counter() - t0
            cfg = engine.lookup_tuned(p, "batched_hvp")
            if cfg is None or cfg.source != "sweep":
                fail(f"{key}: no fresh sweep behind the autotuned plan "
                     f"({cfg})")
            bad = [x for x in cfg.failures if x[0] == "cuda"]
            if bad:
                fail(f"{key}: cuda candidates raised in the sweep: {bad[:3]}")
            if cfg.backend != "cuda":
                fail(f"{key}: the sweep's winner is {cfg.backend}, not cuda")
            if (p.backend_for("batched_hvp") != cfg.backend
                    or p.opt("blk_m") != cfg.blk_m or p.csize != cfg.csize):
                fail(f"{p.describe()} does not carry its winner {cfg}")
            best = {}
            for bk, _c, _bm, t in cfg.trials:
                best[bk] = min(best.get(bk, t), t)
            at_csize = {str(bm): t * 1e3 for bk, c, bm, t in cfg.trials
                        if bk == "cuda" and c == cfg.csize}
            report["offline"][key] = {
                "backend": cfg.backend, "csize": cfg.csize,
                "blk_m": cfg.blk_m, "probe_ms": cfg.time_s * 1e3,
                "candidates": len(cfg.trials) + len(cfg.failures),
                "failures": [list(x) for x in cfg.failures],
                "sweep_s": cfg.sweep_s, "plan_s": wall,
                "probes": engine.probe_count() - probes,
                "best_probe_ms_by_backend": {k: v * 1e3
                                             for k, v in best.items()},
                "cuda_probe_ms_at_winning_csize": at_csize}
            tuned[(fname, symmetric)] = p
            print(f"{tag} autotune {key}: winner {cfg.backend} csize "
                  f"{cfg.csize} blk_m {cfg.blk_m} ({cfg.time_s * 1e3:.4f} ms "
                  f"on the probe batch); {len(cfg.trials)} candidates "
                  f"measured, {len(cfg.failures)} raised {cfg.failures}, "
                  f"sweep {cfg.sweep_s:.1f} s (plan {wall:.1f} s), "
                  f"{report['offline'][key]['probes']} probes; best probe "
                  f"ms by backend "
                  f"{ {k: round(v * 1e3, 4) for k, v in best.items()} }; "
                  f"cuda at csize {cfg.csize} by blk_m "
                  f"{ {k: round(v, 4) for k, v in at_csize.items()} }",
                  flush=True)

    # (b) the tuned plans at full width: the slice's path
    data = {fname: points(1000 + k, M, N) for k, fname in enumerate(FUNCTIONS)}
    zero_counts()
    err = 0.0
    for (fname, symmetric), p in tuned.items():
        A, V = data[fname]
        before = ck.chess_hvp_cuda.launches
        out = p.batched_hvp(A, V)
        torch.cuda.synchronize()
        if ck.chess_hvp_cuda.launches != before + 1:
            fail(f"{p.describe()}: batched_hvp did not launch the kernel once")
        if out.shape != (M, N) or not bool(torch.isfinite(out).all()):
            fail(f"{p.describe()}: output not finite or of shape {(M, N)}")
        kf, consts, _ = form(fname, N)
        for r0 in row_slices(M):
            sl = slice(r0, r0 + SAMPLE)
            err = max(err, check_close(
                out[sl], ck.chess_hvp_plain(kf, A[sl], V[sl], p.csize, consts,
                                            symmetric),
                f"autotuned {p.describe()} rows {r0}:{r0 + SAMPLE}"))
        del out
    launches = ck.chess_hvp_cuda.launches
    if launches != len(tuned) or hl.hdual_linear_cuda.launches:
        fail(f"autotuned path launched chess_hvp {launches} times (expected "
             f"{len(tuned)}) and hdual_linear "
             f"{hl.hdual_linear_cuda.launches} times")
    report.update(launches=launches, max_abs_err=err)
    print(f"{tag} autotuned path: {launches} launches of chess_hvp over "
          f"{len(tuned)} batched_hvp calls, rows {row_slices(M)} (+{SAMPLE} "
          f"each) vs plain max abs err {err:.3e}", flush=True)

    ms_total = auto_total = bound_total = 0.0
    for (fname, symmetric), p in tuned.items():
        A, V = data[fname]
        f = testfns.FUNCTIONS[fname](N)
        auto = engine.plan(f, N, m=M, csize="auto", symmetric=symmetric,
                           device=dev)
        if auto.backend_for("batched_hvp") != "cuda":
            fail(f"{auto.describe()} resolved to "
                 f"{auto.backend_for('batched_hvp')}")
        reps = 2 if fname == "fletcher_powell" else 5
        ta = [cuda_ms(lambda: auto.batched_hvp(A, V), reps)]
        tt = [cuda_ms(lambda: p.batched_hvp(A, V), reps) for _ in range(2)]
        ta.append(cuda_ms(lambda: auto.batched_hvp(A, V), reps))
        ms, ms_auto = sum(tt) / 2, sum(ta) / 2
        ops, nbytes = ck.needed_work(fname, M, N, p.csize, symmetric)
        bound = max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
        ops_a, nbytes_a = ck.needed_work(fname, M, N, auto.csize, symmetric)
        bound_auto = max(ops_a / PEAK_FP32, nbytes_a / PEAK_BYTES) * 1e3
        if bound > ms:
            fail(f"autotuned {fname}: {ms:.3f} ms beats the needed bound "
                 f"{bound:.3f} ms")
        key = f"{fname}/{sched[symmetric]}"
        report["full_width"][key] = {
            "csize": p.csize, "blk_m": p.opt("blk_m"), "ms": ms,
            "ms_turns": tt, "auto_csize": auto.csize, "auto_ms": ms_auto,
            "auto_ms_turns": ta, "bound_ms": bound,
            "auto_bound_ms": bound_auto, "tuned_over_auto": ms / ms_auto}
        ms_total += ms
        auto_total += ms_auto
        bound_total += bound
        print(f"{tag} {key} at m={M}: autotuned (csize {p.csize}, blk_m "
              f"{p.opt('blk_m')}) {ms:.3f} ms {tt}, auto (csize "
              f"{auto.csize}, the wrapper's pick) {ms_auto:.3f} ms {ta}; "
              f"tuned / auto {ms / ms_auto:.3f}; needed bound {bound:.3f} ms "
              f"(auto's {bound_auto:.3f} ms)", flush=True)
    report.update(ms=ms_total, auto_ms=auto_total, bound_ms=bound_total)
    del data
    torch.cuda.empty_cache()

    # (c) a warm store answers a second process with zero probes
    t0 = time.perf_counter()
    warm = subprocess.run(
        [sys.executable, "-c", WARM_SCRIPT.format(
            functions=FUNCTIONS, schedules=SCHEDULES, n=N, m=M)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    if warm.returncode != 0:
        fail(f"warm-store process failed: {warm.stderr[-2000:]}")
    got = json.loads(warm.stdout.strip().splitlines()[-1])
    want = {f"{fname}/{symmetric}": ["cuda", p.csize, p.opt("blk_m"), "disk",
                                     "cuda"]
            for (fname, symmetric), p in tuned.items()}
    if got["probes"] != 0 or got["foreign"] or got["winners"] != want:
        fail(f"warm-store process: {got} (expected zero probes, winners "
             f"{want})")
    report["warm_store"] = dict(got, wall_s=time.perf_counter() - t0)
    print(f"{tag} warm store, a second process: {got['probes']} probes, the "
          f"same six winners ({time.perf_counter() - t0:.1f} s)", flush=True)

    # (d) every instance block against the kernel's own pick
    for fname in FUNCTIONS:
        kf, consts, device_fn = form(fname, N)
        for symmetric in SCHEDULES:
            csize = engine.model_csize(N, symmetric)
            blocks = ck.instance_blocks(fname, N, csize)
            P = len(ck.sub_cells(N, csize, symmetric)[0])
            pick = ck._instances_per_block(P, N, fname, ck.lanes_for(csize))
            for m in SWEEP_ROWS:
                A, V = points(6000 + m, m, N)

                def run(ipb):
                    return ck.chess_hvp_cuda(kf, A, V, csize, consts=consts,
                                             device_fn=device_fn,
                                             symmetric=symmetric, ipb=ipb)
                want = ck.chess_hvp_plain(kf, A, V, csize, consts, symmetric)
                times, host = {}, {}
                for ipb in [None] + blocks:
                    check_close(run(ipb), want, f"{fname} "
                                f"{sched[symmetric]} m={m} ipb={ipb} (None: "
                                f"the kernel's pick, {pick}) vs plain")
                    times[str(ipb)] = cuda_ms(lambda: run(ipb), 20)
                    host[str(ipb)] = host_ms(lambda: run(ipb), 20)
                best = min(times, key=times.get)
                key = f"{fname}/{sched[symmetric]}/m={m}"
                report["instance_blocks"][key] = {
                    "csize": csize, "default_ipb": pick, "ms": times,
                    "host_ms": host, "best": best,
                    "default_over_best": times["None"] / times[best]}
                ms4 = {k: round(v, 4) for k, v in times.items()}
                host4 = {k: round(v, 4) for k, v in host.items()}
                print(f"{tag} {key} csize {csize}: ms a call by ipb {ms4}, "
                      f"host enqueue ms {host4} (None = the wrapper's "
                      f"{pick}); every ipb matches the plain version",
                      flush=True)

    # (e) the service's default re-tune
    report["retune"] = retune_phase(smi, dev, zero_counts)
    return report


def retune_phase(smi, dev, zero_counts):
    """The server as phase 8 builds it, with no tuner=: one dense round,
    ``svc.retune()`` (autotune_buckets on the card; every swapped bucket on
    cuda), the same round again with every row checked, every batched_hvp
    bucket on cuda and the launches equal to the cuda batches."""
    import numpy as np
    import torch
    from repro_torch import engine
    from repro_torch.kernels import chess_hvp as ck
    from repro_torch.kernels import hdual_linear as hl
    from repro_torch.launch.serve import build_plans
    from repro_torch.serving.frontend import CurvatureFrontend, connect

    tag = f"[{smi}]"
    plans = build_plans(FUNCTIONS, symmetric=False, device=dev)
    svc = engine.CurvatureService(max_batch=SERVE_MAX_BATCH,
                                  max_wait_us=SERVE_MAX_WAIT_US,
                                  coalesce_across_n=True)
    fe = CurvatureFrontend(plans, service=svc, host="127.0.0.1", port=0)
    fe.start()
    try:
        dense, jobs = dense_rounds(np.random.RandomState(5000))
        engine.clear_telemetry()
        rounds = {}
        for when in ("before", "after"):
            if when == "after":
                t0 = time.perf_counter()
                summary = svc.retune()
                retune_s = time.perf_counter() - t0
                if summary["errors"] or summary["hot_swaps"] <= 0:
                    fail(f"the default re-tune: {summary}")
                learned = svc.tuning_report()
                swapped = {f"{q['f']}/n={q['n']}": q["buckets"]
                           for q in learned if q["buckets"]}
                off_card = {(k, b): w["backend"]
                            for k, bk in swapped.items()
                            for b, w in bk.items() if w["backend"] != "cuda"}
                if off_card:
                    fail(f"the default re-tune swapped buckets off the "
                         f"kernel: {off_card}")
                # the same pass refits each tuned queue's dispatcher knobs
                knobs = {f"{q['f']}/n={q['n']}": [q["max_batch"],
                                                  q["max_wait_us"]]
                         for q in learned if q["buckets"]}
                print(f"{tag} default re-tune: {summary} in {retune_s:.2f} s;"
                      f" winners {swapped}; dispatcher knobs (max_batch, "
                      f"max_wait_us) {knobs}", flush=True)
                zero_counts()
                engine.clear_telemetry()
            results, latency, wall = drive_clients(connect, fe.address, jobs)
            torch.cuda.synchronize()
            launches = ck.chess_hvp_cuda.launches
            records = engine.execution_stats()
            err = check_dense(results, dense, dev, f"re-tune round {when}")
            print(f"{tag} dense round {when} the re-tune: {len(jobs)} "
                  f"requests in {wall:.3f} s, {len(jobs) / wall:.1f} "
                  f"requests/s; rows vs plain max abs err {err:.3e}; us per "
                  f"point by queue and bucket:", flush=True)
            rounds[when] = {"wall_s": wall, "requests_per_s": len(jobs) / wall,
                            "p50_ms": float(np.percentile(latency, 50)) * 1e3,
                            "max_abs_err": err,
                            "queues": queue_report(records, tag)}
        not_cuda = sorted({r["backend"] for r in records
                           if r["workload"] == "batched_hvp"} - {"cuda"})
        if not_cuda:
            fail(f"re-tuned round: batched_hvp buckets ran on {not_cuda}, "
                 f"not cuda")
        cuda_batches = sum(b["executions"] for r in records
                           if r["workload"] == "batched_hvp"
                           and r["backend"] == "cuda"
                           for b in r["by_bucket"].values())
        if not (launches == cuda_batches > 0) or hl.hdual_linear_cuda.launches:
            fail(f"re-tuned round: chess_hvp launched {launches} times, the "
                 f"telemetry records {cuda_batches} cuda batches; "
                 f"hdual_linear {hl.hdual_linear_cuda.launches} times")
        print(f"{tag} re-tuned round: {launches} chess_hvp launches = "
              f"{cuda_batches} cuda batches in the telemetry", flush=True)
        return {"summary": summary, "retune_s": retune_s, "knobs": knobs,
                "winners": {k: {str(b): v for b, v in bk.items()}
                            for k, bk in swapped.items()},
                "launches_after": launches,
                "cuda_batches_after": cuda_batches, "rounds": rounds}
    finally:
        fe.stop()
        svc.shutdown(wait=True)

# the pytree curvature phase (phase 9): the full-width h2o-danube-1.8b loss
# at B = 2 sequences of S = 512 tokens, float32 params and bfloat16
# compute (the config's own), then the reduced config at float32 compute
# on the card against the CPU
CURV_ARCH = "h2o-danube-1.8b"
CURV_B, CURV_S = 2, 512
CURV_PROBES = 4                      # the plan's n_probes; diag at csize 1
CURV_SEED = 0                        # params and tokens
CURV_DIAG_SEED = 3                   # the diag's probe seed
CURV_REPS = 3                        # timed calls after one warm-up
# two AD routes to one number in bfloat16, in units of ||v|| ||Hv||: the
# bound tests/test_torch_curvature_contracts.py holds the reduced configs to
BF16_ROUTES = 1e-3
# forward-equivalent matmul passes each workload needs: an HVP (jvp of
# grad) 3 forward + 6 backward, quadform (jvp of jvp) 1 + 2 + 2 + 3, the
# GGN and Fisher products a shared primal, one tangent (2) and one
# transpose (2); diag CURV_PROBES HVPs
CURV_PASSES = {"hvp": 9, "quadform": 8, "ggn": 5, "fisher": 5,
               "diag": 9 * CURV_PROBES}
CURV_RED_S = 48                      # the reduced config's window is 32
CURV_RED_CSIZE = 2
CURV_REL = 1e-4                      # card vs CPU, normalized error
CURV_BLOCK_CSIZE = 16                # block_hessian of final_norm (64 rows)
CURV_SERVE_THREADS = 4               # 4 HVP and 2 diag submits each


def median_cuda_ms(fn, digest, reps=CURV_REPS):
    """(median CUDA-event ms of reps calls after one warm-up, ``digest`` of
    the warm-up's result, peak bytes allocated during the warm-up).  The
    warm-up's result is digested (reduced to numbers, or moved to the
    host) and dropped before the timed calls, so no call runs beside
    another's output."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    kept = digest(out)
    del out
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[reps // 2], kept, peak


def device_busy_ms(fn, top=6):
    """(wall ms of one call, ms the card spent in kernels during it, the
    ``top`` operators by the device time of the kernels they launched, as
    (name, ms, calls)) under torch.profiler.  Busy time sums the kernel
    events only (an operator's row repeats its kernels' time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    return wall, busy, [(e.key, e.self_device_time_total / 1e3, e.count)
                        for e in ops[:top]]


def tree_dot(a, b):
    """sum over leaves of a . b, each leaf summed in float64."""
    import torch
    from torch.utils import _pytree as pt
    return sum(float(torch.sum(x * y, dtype=torch.float64))
               for x, y in zip(pt.tree_leaves(a), pt.tree_leaves(b)))


def tree_finite(tree, what):
    import torch
    from torch.utils import _pytree as pt
    for leaf in pt.tree_leaves(tree):
        if not bool(torch.isfinite(leaf).all()):
            fail(f"{what}: non-finite values")


def tree_nerr(got, want):
    """||got - want|| / ||want|| over all leaves, in float64 on the host."""
    import numpy as np
    from torch.utils import _pytree as pt
    g = np.concatenate([np.asarray(x.double()).ravel()
                        for x in pt.tree_leaves(got)])
    w = np.concatenate([np.asarray(x.double()).ravel()
                        for x in pt.tree_leaves(want)])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def trees_equal(got, want):
    """Bitwise equality of two trees (host numpy or tensors)."""
    import numpy as np
    from torch.utils import _pytree as pt
    return all(np.array_equal(np.asarray(g), np.asarray(w))
               for g, w in zip(pt.tree_leaves(got), pt.tree_leaves(want)))


def curvature_bound_ms(cfg, B, S, passes):
    """The least time for a workload of ``passes`` forward-equivalent
    passes: 2 x (matmul params) x tokens per pass and the bfloat16
    probabilities-times-values products at the card's bfloat16 dense rate,
    the float32 score products (TF32 off) at its FFMA rate."""
    T = B * S
    mm_params = cfg.num_params() - cfg.vocab_size * cfg.d_model  # no gather
    attn = 2 * B * cfg.num_heads * S * S * cfg.head_dim_ * cfg.num_layers
    bf16_flops = passes * (2 * mm_params * T + attn)
    fp32_flops = passes * attn
    return (bf16_flops / PEAK_BF16 + fp32_flops / PEAK_FP32) * 1e3


def curvature_phase(smi, dev, launch_counts):
    """Phase 9: pytree curvature on the full-width h2o-danube-1.8b loss,
    then the reduced config on the card against the CPU (see the module
    docstring)."""
    import torch
    from torch.utils import _pytree as pt

    from repro_torch import engine
    from repro_torch.configs import get_config
    from repro_torch.core import curvature as tc
    from repro_torch.engine.service import CurvatureService
    from repro_torch.models.model import make_batch
    from repro_torch.models.params import init_params
    from repro_torch.models.targets import lm_curvature_targets

    before = launch_counts()
    report = {"config": CURV_ARCH, "batch": CURV_B, "seq": CURV_S,
              "n_probes": CURV_PROBES, "diag_csize": 1,
              "bf16_routes_bound": BF16_ROUTES}

    # (a) full width ----------------------------------------------------
    cfg = get_config(CURV_ARCH)
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(CURV_SEED)
    params = init_params(cfg, gen, device=dev)
    batch = make_batch(cfg, CURV_B, CURV_S, gen, device=dev)
    tgt = lm_curvature_targets(cfg, batch)
    plan = engine.plan(tgt.loss, None, csize=1, device=dev,
                       options={"n_probes": CURV_PROBES,
                                **tgt.plan_options()})
    backends = {w: plan.backend_for(w) for w in CURV_PASSES}
    if backends != {"hvp": "pytree_fwdrev", "diag": "pytree_fwdrev",
                    "ggn": "pytree_fwdrev", "fisher": "pytree_fwdrev",
                    "quadform": "pytree_fwd"}:
        fail(f"curvature plan resolves to {backends}")
    report.update(params=cfg.num_params(), tokens=CURV_B * CURV_S,
                  setup_s=time.time() - t0, backends=backends)
    print(f"[{smi}] curvature: {CURV_ARCH} at full width, "
          f"{cfg.num_params():,} params (float32, compute "
          f"{cfg.compute_dtype}), B={CURV_B} x S={CURV_S} = "
          f"{CURV_B * CURV_S} tokens; one plan, backends {backends}",
          flush=True)

    v = tc.rademacher_like(1, params)
    work = {}

    def record(name, ms, peak):
        bound = curvature_bound_ms(cfg, CURV_B, CURV_S, CURV_PASSES[name])
        work[name] = {"ms": ms, "peak_gb": peak / 1e9, "bound_ms": bound,
                      "bound_share": bound / ms,
                      "passes": CURV_PASSES[name]}
        print(f"[{smi}] curvature {name}: {ms:.1f} ms (median of "
              f"{CURV_REPS} after a warm-up), peak {peak / 1e9:.2f} GB, "
              f"bound {bound:.2f} ms ({CURV_PASSES[name]} passes), "
              f"{bound / ms:.1%} of it", flush=True)

    def hvp_numbers(hv):
        # w is drawn here, after the warm-up's peak was read
        tree_finite(hv, "hvp")
        w = tc.rademacher_like(2, params)
        return tree_dot(v, hv), tree_dot(hv, hv) ** 0.5, tree_dot(w, hv)

    ms, (vhv, hv_norm, whv), peak = median_cuda_ms(
        lambda: plan.hvp(params, v), hvp_numbers)
    record("hvp", ms, peak)
    wall, busy, top = device_busy_ms(lambda: plan.hvp(params, v))
    # the idle share of the unprofiled call: kernel time over its median
    work["hvp"].update(profiled_wall_ms=wall, device_busy_ms=busy,
                       device_idle_share=max(0.0, 1.0 - busy / ms),
                       top_ops=top)
    print(f"[{smi}] curvature hvp under torch.profiler: {wall:.1f} ms wall "
          f"(profiled), the card in kernels {busy:.1f} ms, idle "
          f"{max(0.0, 1.0 - busy / ms):.1%} of the {ms:.1f} ms call; by "
          f"device time: "
          + "; ".join(f"{k} {t:.1f} ms x{c}" for k, t, c in top),
          flush=True)
    scale = tree_dot(v, v) ** 0.5 * hv_norm
    hw = plan.hvp(params, tc.rademacher_like(2, params))
    tree_finite(hw, "hvp (w)")
    vhw = tree_dot(v, hw)
    del hw

    ms, quad, peak = median_cuda_ms(lambda: plan.quadform(params, v, v),
                                    float)
    record("quadform", ms, peak)
    routes = abs(quad - vhv) / scale
    sym = abs(whv - vhw) / scale
    print(f"[{smi}] curvature: v.Hv {vhv:.6e} (hvp) vs {quad:.6e} "
          f"(quadform), |diff| / (||v|| ||Hv||) = {routes:.3e}; w.Hv "
          f"{whv:.6e} vs v.Hw {vhw:.6e}, {sym:.3e} (bound {BF16_ROUTES})",
          flush=True)
    if not (routes <= BF16_ROUTES and sym <= BF16_ROUTES):
        fail(f"curvature: AD routes disagree ({routes:.3e}, {sym:.3e} > "
             f"{BF16_ROUTES})")

    def v_dot(name):
        def digest(out):
            tree_finite(out, name)
            return tree_dot(v, out)
        return digest

    psd = {}
    for name, call in (("ggn", plan.ggn), ("fisher", plan.fisher)):
        ms, psd[name], peak = median_cuda_ms(lambda: call(params, v),
                                             v_dot(name))
        record(name, ms, peak)
        if not psd[name] >= 0.0:
            fail(f"curvature: v.{name}(v) = {psd[name]:.6e} < 0")
    print(f"[{smi}] curvature: v.Gv {psd['ggn']:.6e}, v.Fv "
          f"{psd['fisher']:.6e} (both >= 0)", flush=True)
    del v

    def to_host(diag):
        tree_finite(diag, "diag")
        return pt.tree_map(lambda t: t.cpu(), diag)

    ms, diag, peak = median_cuda_ms(
        lambda: plan.diag(params, CURV_DIAG_SEED), to_host)
    record("diag", ms, peak)

    # the served diag: budgets 4 and 2 through a service, one row a bucket
    # (two rows of the full-width tree do not fit beside the model's work)
    host = pt.tree_map(lambda t: t.cpu(), params)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with CurvatureService(max_batch=1, max_wait_us=0.0) as svc:
        futs = {p: svc.submit(plan, host, CURV_DIAG_SEED, workload="diag",
                              n_probes=p) for p in (CURV_PROBES, 2)}
        served = {p: f.result(timeout=600) for p, f in futs.items()}
        stats = svc.stats()
    served_s = time.time() - t0
    if not trees_equal(served[CURV_PROBES], diag):
        fail("curvature: the served budget-4 diag is not bitwise plan.diag")
    for p, tree in served.items():
        tree_finite(pt.tree_map(torch.from_numpy, tree), f"served diag {p}")
    if trees_equal(served[2], diag):
        fail("curvature: the budget-2 diag equals the budget-4 one")
    report["served_diag"] = {
        "budgets": [CURV_PROBES, 2], "s": served_s,
        "batches": stats["batches"],
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "budget4_bitwise_plan_diag": True}
    print(f"[{smi}] curvature: served diag, budgets {CURV_PROBES} and 2, "
          f"{stats['batches']} buckets in {served_s:.1f} s (host marshalling "
          f"of two {cfg.num_params() * 4 / 1e9:.2f} GB rows included), peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; budget "
          f"{CURV_PROBES} bitwise plan.diag", flush=True)
    report["workloads"] = work
    report["vHv"] = {"hvp": vhv, "quadform": quad, "routes_err": routes,
                     "wHv": whv, "vHw": vhw, "symmetry_err": sym}
    report["psd"] = psd
    del host, diag, served, plan, tgt, batch
    torch.cuda.empty_cache()

    # (b) the card against the CPU, reduced config, float32 compute ------
    report["reduced"] = reduced_curvature(smi, dev)
    after = launch_counts()
    if after != before:
        fail(f"curvature: kernel launches changed {before} -> {after}")
    return report


def reduced_curvature(smi, dev):
    """The reduced h2o-danube-1.8b at float32 compute: the same params, v,
    w and probes through the five workloads and block_hessian on the CPU
    and on the card; then the pytree service on the card."""
    import dataclasses
    import threading

    import torch
    from torch.utils import _pytree as pt

    from repro_torch import engine
    from repro_torch.configs import get_config
    from repro_torch.core import curvature as tc
    from repro_torch.engine.service import CurvatureService
    from repro_torch.models.model import make_batch
    from repro_torch.models.params import init_params
    from repro_torch.models.targets import lm_curvature_targets

    cfg = dataclasses.replace(get_config(CURV_ARCH, reduced=True),
                              compute_dtype="float32")
    cpu = torch.device("cpu")
    params = init_params(cfg, CURV_SEED, device=cpu)
    batch = make_batch(cfg, CURV_B, CURV_RED_S, CURV_SEED, device=cpu)
    v, w = tc.rademacher_like(1, params), tc.rademacher_like(2, params)
    gen = torch.Generator().manual_seed(CURV_DIAG_SEED)
    probes = tc._stack([tc.rademacher_like(gen, params)
                        for _ in range(CURV_PROBES)])

    def on(device, tree):
        return pt.tree_map(lambda t: t.to(device), tree)

    def run(device):
        p, vv, ww, pr = (on(device, t) for t in (params, v, w, probes))
        tgt = lm_curvature_targets(cfg, on(device, batch))
        plan = engine.plan(tgt.loss, None, csize=CURV_RED_CSIZE,
                           device=device,
                           options={"n_probes": CURV_PROBES,
                                    **tgt.plan_options()})
        out = {"hvp": plan.hvp(p, vv), "quadform": plan.quadform(p, vv, ww),
               "ggn": plan.ggn(p, vv), "fisher": plan.fisher(p, vv),
               "diag": tc._diag_from_probes(tc._hvp_map(tgt.loss, p), pr,
                                            CURV_RED_CSIZE),
               "block_hessian": tc.block_hessian(
                   tgt.loss, p, "final_norm", csize=CURV_BLOCK_CSIZE)}
        return {k: on(cpu, o) for k, o in out.items()}, plan, p

    want, _, _ = run(cpu)
    got, plan, dparams = run(dev)
    errs = {k: tree_nerr(got[k], want[k]) for k in want}
    print(f"[{smi}] curvature, reduced {CURV_ARCH} (float32 compute, TF32 "
          f"off), card vs CPU normalized error: "
          + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
          + f" (bound {CURV_REL})", flush=True)
    bad = {k: e for k, e in errs.items() if not e <= CURV_REL}
    if bad:
        fail(f"curvature: card vs CPU past {CURV_REL}: {bad}")

    # the pytree service on the card: HVP and budgeted diag submits from
    # CURV_SERVE_THREADS threads, every row the direct call's
    points = [pt.tree_map(lambda t: t.numpy(), init_params(cfg, s,
                                                           device=cpu))
              for s in range(CURV_SERVE_THREADS)]
    jobs, results = [], {}
    for c in range(CURV_SERVE_THREADS):
        for i in range(4):
            jobs.append((c, ("hvp", c, i)))
        for i in range(2):
            k = 2 * c + i
            jobs.append((c, ("diag", c, k)))

    def client(c, svc):
        for cc, job in jobs:
            if cc != c:
                continue
            kind, pc, i = job
            if kind == "hvp":
                results[job] = svc.submit(plan, points[pc], points[i])
            else:
                results[job] = svc.submit(
                    plan, points[pc], i, workload="diag",
                    n_probes=1 + i % CURV_PROBES)

    with CurvatureService(max_batch=8, max_wait_us=20000.0) as svc:
        threads = [threading.Thread(target=client, args=(c, svc))
                   for c in range(CURV_SERVE_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        rows = {job: fut.result(timeout=120) for job, fut in results.items()}
        stats = svc.stats()
    if not stats["batches"] < len(rows):
        fail(f"curvature service: {stats['batches']} batches for "
             f"{len(rows)} requests")
    tgt = lm_curvature_targets(cfg, on(dev, batch))
    for (kind, pc, i), row in rows.items():
        point = on(dev, pt.tree_map(torch.from_numpy, points[pc]))
        if kind == "hvp":
            direct = plan.hvp(point, on(dev, pt.tree_map(torch.from_numpy,
                                                         points[i])))
        else:
            direct = tc.hutchinson_diag_budgeted(
                tgt.loss, point, i, 1 + i % CURV_PROBES,
                n_probes=CURV_PROBES, csize=CURV_RED_CSIZE)
        if not trees_equal(row, on(cpu, direct)):
            fail(f"curvature service: {kind} row {pc}/{i} is not the "
                 f"direct call")
    n_hvp = sum(1 for j in rows if j[0] == "hvp")
    print(f"[{smi}] curvature service (reduced, card): {n_hvp} HVP and "
          f"{len(rows) - n_hvp} diag submits (budgets 1-{CURV_PROBES}) from "
          f"{CURV_SERVE_THREADS} threads in {stats['batches']} batches, "
          f"every row bitwise the direct call", flush=True)
    return {"card_vs_cpu_nerr": errs, "bound": CURV_REL,
            "service": {"requests": len(rows), "batches": stats["batches"],
                        "hvp": n_hvp, "diag": len(rows) - n_hvp}}


def main():
    # phase 9 holds the full-width LM loss's HVP work (64 GB) beside two
    # parameter-sized accumulators on one card: expandable segments keep
    # the allocator's fragmentation from failing that allocation
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
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

    # the tuner's store: a fresh file in the git-ignored output directory
    store = ROOT / "chiprun_out" / "autotune_store.json"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(store)
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

    # 6. the network check: the reference test's use of the entry point,
    # sin(x W1) then . W2, with one (row, chunk) cell seeded at T points
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

    # 7. the tuner on the card -------------------------------------------
    del W1, W2, a, y, z, out
    torch.cuda.empty_cache()
    t_tune = time.time()
    tuning = tune_phase(smi, dev, zero_counts, points)
    print(f"tuning: {time.time() - t_tune:.1f} s", flush=True)
    # phase 8 is measured as PR 18 measured it: no tuned record or
    # telemetry of this phase answers its plans
    engine.clear_autotune_cache()
    engine.clear_telemetry()
    torch.cuda.empty_cache()

    # 8. the served path --------------------------------------------------
    t_serve = time.time()
    serving = serve_phase(smi, dev, zero_counts)
    print(f"served path: {time.time() - t_serve:.1f} s", flush=True)

    # 9. pytree curvature on the full-width LM loss -----------------------
    engine.clear_telemetry()
    torch.cuda.empty_cache()
    t_curv = time.time()
    curvature = curvature_phase(
        smi, dev, lambda: (ck.chess_hvp_cuda.launches,
                           hl.hdual_linear_cuda.launches))
    print(f"curvature: {time.time() - t_curv:.1f} s", flush=True)

    # 10. results ---------------------------------------------------------
    print(json.dumps({"curvature": curvature}))
    print(json.dumps({"kernels": [{
        "name": "chess_hvp", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/chess_hvp.cu",
        "replaces": "src/repro/kernels/chess_hvp.py:158",
        "launches": launches, "max_abs_err": max_err,
        "ms": total_ms, "plain_ms": total_plain, "bound_ms": total_bound,
        "bound_by": "operations", "library_ms": None,
        "dense_bound_ms": total_dense,
        "sample_rows": SAMPLE, "sample_ms": total_sample,
        "shape": {"m": M, "n": N}, "cases": report, "repairs": repairs,
        "tuning": tuning, "serving": serving}, {
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
