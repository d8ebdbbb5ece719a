"""Roofline report: the dry-run cells AND the curvature backends.

Counterpart of ``repro.launch.roofline``.  The default mode reads the
records of ``launch.dryrun`` (``artifacts/dryrun_torch/*.json``, ``--dir``)
and renders the per-cell three-term table, with the H100 constants of
``launch.hlo_analysis``:

  compute    = FLOPs_per_device / 989 TFLOP/s (bfloat16 compute; 67 for
               float32: the record's ``roofline_peak_flops``)
  memory     = bytes_per_device / 3.35 TB/s
  collective = wire_bytes_per_device / 450 GB/s (NVLink, one direction)

with MODEL_FLOPS / FLOPs (the useful-compute ratio: catches remat and
replicated work), the memory a device holds at its peak (hbm_GiB =
argument + temp + output - alias) and the dominant term per cell, then the
cell with the worst useful-FLOP ratio and the most collective-bound one.

``--curvature`` instead times each (backend, schedule) of the plan's
batched-HVP callable on the plan's device and reports

  flops, bytes   = counts, not a compiled program's cost model (PyTorch
                   compiles none): the fp32 operations (FMA = 2) that the
                   schedule's cells of Rosenbrock's hDual sweep need, over
                   the coordinates each cell makes active, times m
                   (``kernels.chess_hvp.needed_work``, the count that
                   ``chip_smoke.py`` holds the kernel to); A and V read
                   once and R written once (3 m n itemsize bytes)
  pct_roofline   = 100 * bound / measured, bound the larger of flops at
                   67 TFLOP/s (float32 FFMA) and bytes at 3.35 TB/s (the
                   H100 constants of ``hlo_analysis``; overridable).  On
                   the CPU the absolute % is nominal, comparable across
                   rows only; every record names its device
  cells_executed = the schedule's tangent sweeps per instance: for ``cuda``
                   its launch grid's cells (``kernels.chess_hvp
                   .kernel_grid``), for ``vmap_l2`` its cell enumeration
                   (``num_chunk_evals``), for the static ``sharded_rows``
                   rows the cyclic cell lists of ``core.distributed``
  cells_min      = the minimum sweeps the schedule is ALLOWED: the full
                   n*ceil(n/csize) grid, or the kept upper triangle for
                   symmetric (``num_chunk_evals``)

and the symmetric-vs-full speedup per backend.  The process exits nonzero
if any symmetric schedule EXECUTES more chunk cells than the triangle bound
(single-device backends must hit it exactly; the cyclic sharded layout gets
its one-block-per-shard padding slack) -- the gate that symmetric skipping
never regresses to masking.

On a card the measured rows run at the sharded main path's shapes, one
rank's share: m = 2,048 instances at n = 64, each schedule at the op
model's csize (``engine.opmodel.model_csize``), for ``vmap_l2`` and
``cuda``.  On the CPU only ``vmap_l2`` runs, at small shapes (smaller still
with ``--quick``).

The flops and bytes of both modes are counts, not a compiled program's
cost model (the reference's ``_hlo_cost``): PyTorch compiles none.
``--curvature`` counts them from the shapes (above), the dry run from one
call of the step (``launch.dryrun``).

Usage: python -m repro_torch.launch.roofline [--dir artifacts/dryrun_torch]
           [--md]
       python -m repro_torch.launch.roofline --curvature [--quick] [--md]
           [--out table.md] [--json records.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import time

__all__ = ["load_records", "render_table", "run_table", "run_curvature",
           "curvature_records", "render_curvature", "sharded_rows_records"]

DEFAULT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "artifacts", "dryrun_torch")

# the measured rows' (m, n) on a card: the sharded main path's share of
# one rank (chip_smoke.py phase 11)
CARD_M, CARD_N = 2048, 64

def _fmt_t(x):
    if x >= 1.0:
        return f"{x:7.2f}s "
    if x >= 1e-3:
        return f"{x * 1e3:7.2f}ms"
    return f"{x * 1e6:7.2f}us"


def load_records(d: str = DEFAULT_DIR) -> list[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def render_table(recs: list[dict], md: bool = False) -> str:
    rows = []
    hdr = ["cell", "status", "t_compute", "t_memory", "t_collective",
           "bound", "useful_ratio", "hbm_GiB"]
    for r in recs:
        if r["status"] == "ok":
            t = r["roofline"]
            mem = r.get("memory", {})
            hbm = (mem.get("argument_size_in_bytes", 0)
                   + mem.get("temp_size_in_bytes", 0)
                   + mem.get("output_size_in_bytes", 0)
                   - mem.get("alias_size_in_bytes", 0)) / 2 ** 30
            ur = r.get("useful_flop_ratio")
            rows.append([r["cell"], "ok", _fmt_t(t["compute_s"]),
                         _fmt_t(t["memory_s"]), _fmt_t(t["collective_s"]),
                         t["bound"],
                         f"{ur:.2f}" if ur is not None else "-",
                         f"{hbm:.2f}"])
        elif r["status"] == "skipped":
            rows.append([r["cell"], "SKIP", "-", "-", "-", "-", "-", "-"])
        else:
            rows.append([r["cell"], "ERROR", "-", "-", "-", "-", "-", "-"])
    widths = [max(len(str(row[i])) for row in rows + [hdr])
              for i in range(len(hdr))]

    def line(row):
        cells = [str(c).ljust(w) for c, w in zip(row, widths)]
        return ("| " + " | ".join(cells) + " |") if md else "  ".join(cells)

    out = [line(hdr)]
    if md:
        out.append("|" + "|".join("-" * (w + 2) for w in widths) + "|")
    out += [line(r) for r in rows]
    return "\n".join(out)


def run_table(d: str = DEFAULT_DIR, md: bool = False) -> None:
    """Print the table of the records in ``d`` and the two summary
    lines."""
    recs = load_records(d)
    print(render_table(recs, md))
    ok = [r for r in recs if r["status"] == "ok"]
    if ok:
        worst = min(ok, key=lambda r: r.get("useful_flop_ratio") or 1e9)
        coll = max(ok, key=lambda r: r["roofline"]["collective_s"]
                   / max(r["roofline"]["step_time_lower_bound_s"], 1e-30))
        print(f"\nworst useful-FLOP ratio : {worst['cell']}"
              f" ({worst.get('useful_flop_ratio'):.3f})")
        print(f"most collective-bound   : {coll['cell']}")


def _median_time(fn, device, reps: int = 5) -> float:
    """Median seconds of one call after a warm-up call: CUDA events on a
    card, the host clock on the CPU."""
    import torch
    fn()
    ts = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            ts.append(start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _executed_cells(backend: str, m: int, n: int, csize: int, blk_m,
                    symmetric: bool, form=None) -> int:
    """The schedule's tangent-sweep count per instance -- for ``cuda`` the
    launch grid's cell extent of ``form``, the device form the backend runs
    (``kernels.ops.backend_form``; the kernel enumerates no ghost cells)."""
    if backend == "cuda":
        from repro_torch.kernels.chess_hvp import kernel_grid
        if form is None:
            raise ValueError("_executed_cells: the cuda row needs the form "
                             "its backend runs")
        return kernel_grid(m, n, csize, symmetric, form, blk_m)[1]
    from repro_torch.core.api import num_chunk_evals
    return num_chunk_evals(n, csize, symmetric)


def sharded_rows_records(n: int, csize: int, size: int) -> list[dict]:
    """The static cell accounting of ``sharded_rows`` on ``size`` model
    shards (host-side layouts; its wall clock needs a mesh): the cyclic
    symmetric row and the full row."""
    from repro_torch.core.api import num_chunk_evals
    from repro_torch.core.distributed import cyclic_layout, rows_per_shard
    lay = cyclic_layout(n, csize, size)
    tri = num_chunk_evals(n, csize, True)
    nchunk = -(-n // csize)
    return [{
        "backend": "sharded_rows", "schedule": "sym",
        "m": 1, "n": n, "csize": csize, "shards": size,
        "cells_executed": size * lay.executed,
        "cells_kept": int(sum(lay.kept)),
        "cells_min": tri,
        # balance bound: every shard pads to the max kept count, so the
        # total may exceed the triangle by < one block per other shard
        "cells_allowed": tri + (size - 1) * lay.block_cells_bound,
        "status": "static",
    }, {
        "backend": "sharded_rows", "schedule": "full",
        "m": 1, "n": n, "csize": csize, "shards": size,
        "cells_executed": size * rows_per_shard(n, size) * nchunk,
        "cells_min": num_chunk_evals(n, csize, False),
        "status": "static",
    }]


def curvature_records(quick: bool = False, peak_flops: float | None = None,
                      peak_bw: float | None = None,
                      device="cuda") -> list[dict]:
    """Measure the curvature backends on both schedules on ``device``; one
    record per (backend, schedule), ``cuda`` and the main path's shapes on
    a card only, plus the two static ``sharded_rows`` rows."""
    import numpy as np
    import torch

    from repro_torch import engine
    from repro_torch.core import testfns
    from repro_torch.core.api import num_chunk_evals
    from repro_torch.engine.opmodel import model_csize
    from repro_torch.kernels.chess_hvp import needed_work
    from repro_torch.kernels.ops import backend_form
    from .hlo_analysis import HBM_BW, PEAK_FLOPS, roofline_terms

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("roofline: no CUDA device is available; pass "
                           "--device cpu for a nominal CPU report")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    pf = peak_flops or PEAK_FLOPS
    bw = peak_bw or HBM_BW
    # (backend, m, n, csize); csize None = the op model's pick per schedule
    if device.type == "cuda":
        configs = [(b, CARD_M, CARD_N, None) for b in ("vmap_l2", "cuda")]
    else:
        configs = [("vmap_l2", 16, 24, 4) if quick else
                   ("vmap_l2", 32, 48, 4)]
    recs = []
    for backend, m, n, csize_pin in configs:
        rng = np.random.RandomState(n)
        A = torch.as_tensor(rng.uniform(-2, 2, (m, n)), dtype=torch.float32,
                            device=device)
        V = torch.as_tensor(rng.randn(m, n), dtype=torch.float32,
                            device=device)
        f = testfns.FUNCTIONS["rosenbrock"](n)
        for sym in (False, True):
            csize = csize_pin or model_csize(n, sym)
            p = engine.plan(f, n, m=m, csize=csize, backend=backend,
                            symmetric=sym, device=device)
            run = p.executable("batched_hvp")
            cells = _executed_cells(backend, m, n, csize, None, sym,
                                    backend_form(f, n)
                                    if backend == "cuda" else None)
            flops = float(needed_work("rosenbrock", m, n, csize, sym)[0])
            nbytes = float(3 * m * n * A.element_size())
            t = _median_time(lambda r=run: r(A, V), device)
            terms = roofline_terms(flops, nbytes, 0.0)
            bound = max(flops / pf, nbytes / bw)
            recs.append({
                "backend": backend, "schedule": "sym" if sym else "full",
                "device": name, "m": m, "n": n, "csize": csize,
                "cells_executed": cells,
                "cells_min": num_chunk_evals(n, csize, sym),
                "flops": flops, "bytes": nbytes,
                "measured_s": t, "bound_s": bound,
                "pct_roofline": 100.0 * bound / t if t > 0 else 0.0,
                "bound_term": terms["bound"],
                "status": "measured",
            })
    recs += sharded_rows_records(*((24, 4, 4) if quick else (48, 4, 4)))
    return recs


def _sweep_gate(recs: list[dict]) -> list[str]:
    """The gate: symmetric schedules must not execute more chunk cells than
    the triangle bound (exact for single-device backends; cyclic sharded
    gets its documented one-block-per-shard padding slack)."""
    failures = []
    for r in recs:
        if r["schedule"] != "sym":
            continue
        allowed = r.get("cells_allowed", r["cells_min"])
        if r["cells_executed"] > allowed:
            failures.append(
                f"{r['backend']}: executed {r['cells_executed']} symmetric "
                f"chunk cells > allowed {allowed} (triangle {r['cells_min']})")
        if r.get("cells_kept", r["cells_executed"]) != r["cells_min"]:
            failures.append(
                f"{r['backend']}: kept {r.get('cells_kept')} != triangle "
                f"{r['cells_min']}")
    return failures


def render_curvature(recs: list[dict], md: bool = False) -> str:
    hdr = ["backend", "sched", "n", "csize", "cells", "min", "flops",
           "measured", "bound", "%roof"]
    rows = []
    for r in recs:
        rows.append([
            r["backend"], r["schedule"], r["n"], r["csize"],
            r["cells_executed"], r["cells_min"],
            f"{r['flops']:.2e}" if r.get("flops") else "-",
            _fmt_t(r["measured_s"]) if r.get("measured_s") else "-",
            _fmt_t(r["bound_s"]) if r.get("bound_s") else "-",
            f"{r['pct_roofline']:.2f}" if r.get("pct_roofline") else "-",
        ])
    widths = [max(len(str(row[i])) for row in rows + [hdr])
              for i in range(len(hdr))]

    def line(row):
        cells = [str(c).ljust(w) for c, w in zip(row, widths)]
        return ("| " + " | ".join(cells) + " |") if md else "  ".join(cells)

    out = [line(hdr)]
    if md:
        out.append("|" + "|".join("-" * (w + 2) for w in widths) + "|")
    out += [line(r) for r in rows]
    # per-backend symmetric-vs-full wall-clock speedup
    by = {}
    for r in recs:
        if r.get("measured_s"):
            by.setdefault(r["backend"], {})[r["schedule"]] = r["measured_s"]
    for b, d in sorted(by.items()):
        if "sym" in d and "full" in d:
            out.append(f"\n{b}: symmetric-vs-full wall-clock speedup = "
                       f"{d['full'] / d['sym']:.2f}x")
    return "\n".join(out)


def run_curvature(quick: bool = False, md: bool = False,
                  out: str | None = None, json_out: str | None = None,
                  device="cuda") -> int:
    recs = curvature_records(quick=quick, device=device)
    devices = sorted({r["device"] for r in recs if "device" in r})
    table = render_curvature(recs, md=md)
    print(f"device: {', '.join(devices)}")
    print(table)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as fh:
            fh.write(table + "\n")
    if json_out:
        os.makedirs(os.path.dirname(json_out) or ".", exist_ok=True)
        with open(json_out, "w") as fh:
            json.dump(recs, fh, indent=2)
    failures = _sweep_gate(recs)
    for msg in failures:
        print("SWEEP-GATE FAIL:", msg)
    if not failures:
        print("\nsweep gate: all symmetric schedules within the triangle "
              "bound")
    return 1 if failures else 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=DEFAULT_DIR,
                    help="the dry-run records to tabulate")
    ap.add_argument("--curvature", action="store_true",
                    help="measure the curvature backends instead of "
                         "reading dry-run records")
    ap.add_argument("--md", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the backends run (default: the card)")
    ap.add_argument("--out", default=None, help="write the table here")
    ap.add_argument("--json", default=None, help="write raw records here")
    args = ap.parse_args()
    if args.curvature:
        raise SystemExit(run_curvature(quick=args.quick, md=args.md,
                                       out=args.out, json_out=args.json,
                                       device=args.device))
    run_table(args.dir, args.md)


if __name__ == "__main__":
    main()
