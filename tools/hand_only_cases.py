#!/usr/bin/env python3
"""Where a hand-written chess_hvp form takes a plan that the generated form
of the same test function refuses.

    PYTHONPATH=src python tools/hand_only_cases.py

For each of the paper's test functions and each lane instantiation (a csize
maps to one: ``chess_hvp.lanes_for``), it finds the largest n that the
hand-written form takes (``chess_hvp.max_n``) and the largest n that the
form generated from a trace of the function's kernel form takes
(``chess_hvp.supports`` on ``trace.lower(kf, consts, n)``), and prints the
(function, n, csize) ranges that only the hand-written form takes.  Runs on
the CPU: it traces and counts, and builds nothing.

Every n up to ``--dense`` is checked one by one; above it the generated
form's largest n is found by bisection, which holds because the form's
shared slot, its local arrays and its refusals are the same at every n the
script traces (it checks that, and fails where they differ), so that its
shared memory grows with n and nothing else does (below ``--dense`` a
form may differ: at n = 1 Ackley's sums fold).  A Fletcher-Powell form
carries its n x n matrices: each is traced once and dropped (``lower``,
uncached), so the script holds one at a time.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.core import testfns
from repro_torch.kernels import chess_hvp as ck
from repro_torch.kernels import trace
from repro_torch.kernels.ops import kernel_form

NAMES = ("rosenbrock", "ackley", "fletcher_powell")


def function_at(name: str, n: int):
    """The test function at n; Fletcher-Powell's coefficients built afresh
    (seeded, not cached), so that a large n is not kept."""
    if name != "fletcher_powell":
        return testfns.FUNCTIONS[name](n)
    rng = np.random.RandomState(n)
    A = rng.randint(-100, 101, size=(n, n)).astype(np.float32)
    B = rng.randint(-100, 101, size=(n, n)).astype(np.float32)
    E = rng.uniform(-1e3, 1e3, size=(n,)).astype(np.float32)
    return testfns.build_fletcher_powell(A, B, E)


class Generated:
    """supports() of the generated form at each n, each n traced once; from
    ``floor`` on (the bisection's range), the structure every trace must
    share (slot rows and scalars, local bytes at every lane count)."""

    def __init__(self, name: str, floor: int):
        self.name, self.floor, self.seen, self.shape = name, floor, {}, None

    def fits(self, n: int) -> dict:
        if n not in self.seen:
            kf, consts, _ = kernel_form(function_at(self.name, n))
            form = trace.lower(kf, consts, n)
            shape = (form.rows, form.scalars,
                     tuple(form.local_bytes(c) for c in ck.LANES))
            if n >= self.floor:
                if self.shape is None:
                    self.shape = shape
                elif shape != self.shape:
                    raise SystemExit(
                        f"{self.name}: the generated form at n={n} has "
                        f"slot/local {shape}, not {self.shape}: bisection "
                        f"does not hold")
            self.seen[n] = {c: ck.supports(form, n, c) for c in ck.LANES}
        return self.seen[n]


def largest(gen: Generated, lanes: int, lo: int, hi: int) -> int:
    """The largest n in [lo, hi] the generated form takes at ``lanes``
    (lo is known to fit), by bisection."""
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if gen.fits(mid)[lanes] else (lo, mid - 1)
    return lo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dense", type=int, default=256,
                    help="check every n up to this one by one")
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = {"cases": [], "caps": {}}
    for name in NAMES:
        gen = Generated(name, args.dense)
        caps = out["caps"][name] = {}
        for lanes in ck.LANES:
            hand = ck.max_n(name, lanes)
            # n = 1 .. dense one by one: any refusal below the bisection
            for n in range(1, min(args.dense, hand) + 1):
                if not gen.fits(n)[lanes]:
                    out["cases"].append([name, n, n, lanes])
            top = (largest(gen, lanes, args.dense, hand)
                   if hand > args.dense and gen.fits(args.dense)[lanes]
                   else None)
            if top is not None and top < hand:
                out["cases"].append([name, top + 1, hand, lanes])
            caps[lanes] = {"hand_max_n": hand, "generated_max_n": top}
        out["caps"][name]["slot_rows_scalars_local"] = gen.shape
        print(f"{name}: generated form's slot {gen.shape[0]} rows + "
              f"{gen.shape[1]} scalars, local bytes by lanes "
              f"{dict(zip(ck.LANES, gen.shape[2]))}; {len(gen.seen)} n "
              f"traced", flush=True)
        for lanes, c in caps.items():
            if isinstance(lanes, int):
                print(f"  C={lanes:2d}: hand-written max n {c['hand_max_n']},"
                      f" generated max n {c['generated_max_n']} (checked up "
                      f"to the hand-written's)", flush=True)
    csizes = {1: "1", 2: "2", 4: "3-4", 8: "5-8", 16: "9-16", 32: "17-32",
              64: ">= 33"}
    print("(function, n, csize) that only the hand-written form takes:")
    for name, lo, hi, lanes in out["cases"]:
        print(f"  {name}: n = {lo}..{hi} at csize {csizes[lanes]} "
              f"({lanes} lanes)")
    if not out["cases"]:
        print("  none")
    print(f"{time.perf_counter() - t0:.1f} s")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
