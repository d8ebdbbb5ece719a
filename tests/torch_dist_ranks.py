"""Rank processes of the port's multi-rank CPU tests (gloo, one process per
rank), and ``spawn``, which runs them.

    python tests/torch_dist_ranks.py <body> <rank> <world> <store> <in> <out>

Each rank joins a gloo world through a ``FileStore`` at <store>, runs the
named body on the inputs in <in> (an .npz the pytest process wrote), and
writes what it computed to <out>/rank<r>.npz and <out>/rank<r>.json; the
test compares those with the JAX reference's answers, which it computed
before the spawn.  The rank processes import ``repro_torch`` only.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FUNCTIONS = ("rosenbrock", "ackley", "fletcher_powell")


def spawn(body: str, world: int, tmp_path, inputs: dict,
          timeout: float = 120.0):
    """Run ``body`` on ``world`` gloo ranks; returns each rank's
    (arrays, json) in rank order.  Every rank must end within ``timeout``
    seconds of the spawn: a hung collective kills the world and fails."""
    tmp_path = Path(tmp_path)
    src = tmp_path / "in.npz"
    out = tmp_path / "out"
    out.mkdir()
    np.savez(src, **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        log = open(tmp_path / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, body, str(r), str(world),
             str(tmp_path / "store"), str(src), str(out)],
            env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        text = (tmp_path / f"rank{bad[0]}.log").read_text()[-4000:]
        raise AssertionError(f"ranks {bad} failed or timed out after "
                             f"{timeout} s; rank {bad[0]}'s log:\n{text}")
    return [(dict(np.load(out / f"rank{r}.npz")),
             json.loads((out / f"rank{r}.json").read_text()))
            for r in range(world)]


# ---------------------------------------------------------------------------
# bodies (run in the rank processes)
# ---------------------------------------------------------------------------

def _raises(fn, exc):
    try:
        fn()
    except exc:
        return True
    return False


def distributed_body(inputs):
    """core.distributed and the sharded backends on a ("data", "model") =
    (2, 4) mesh."""
    import torch

    from repro_torch import engine
    from repro_torch.core import distributed, testfns
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

    mesh = make_test_mesh((2, 4), ("data", "model"), device="cpu")
    arrays, info = {}, {"backends": {}}
    # shapes that are not the world, and the production layouts outside a
    # world of their size, raise
    info["mesh_refusals"] = [
        _raises(lambda: make_test_mesh((2, 2), ("data", "model"),
                                       device="cpu"), ValueError),
        _raises(lambda: make_test_mesh((8,), ("data", "model"),
                                       device="cpu"), ValueError),
        _raises(make_production_mesh, ValueError),
        _raises(lambda: make_production_mesh(multi_pod=True), ValueError)]
    # the mesh is part of the plan's signature: a second mesh of the same
    # layout and a second plan() hash and compare equal, and share the
    # cached callable (no second build)
    again = make_test_mesh((2, 4), ("data", "model"), device="cpu")
    p1 = engine.plan(testfns.rosenbrock, 13, csize=4, mesh=mesh,
                     device="cpu")
    fn = p1.executable("hvp")
    builds = engine.trace_count()
    p2 = engine.plan(testfns.rosenbrock, 13, csize=4, mesh=again,
                     device="cpu")
    info["mesh_signature"] = [
        hash(again) == hash(mesh) and again == mesh,
        p2.cache_key("hvp", "sharded_rows") == p1.cache_key(
            "hvp", "sharded_rows"),
        p2.executable("hvp") is fn and engine.trace_count() == builds]
    t = {k: torch.as_tensor(v) for k, v in inputs.items()}

    def note(key, p, *workloads):
        info["backends"][key] = [p.backend_for(w) for w in workloads]

    # sharded_rows: every function, ragged and divisible n, both schedules
    # and both layouts, through plan(mesh=...)
    for fname in FUNCTIONS:
        for n in (13, 16):
            f = testfns.FUNCTIONS[fname](n)
            for sym in (False, True):
                for lay in ("cyclic", "block"):
                    key = f"{fname}_{n}_{int(sym)}_{lay}"
                    p = engine.plan(f, n, csize=4, mesh=mesh, symmetric=sym,
                                    row_layout=lay, device="cpu")
                    note(key, p, "hvp", "hessian", "batched_hvp")
                    arrays[f"hvp_{key}"] = p.hvp(t[f"a{n}"], t[f"v{n}"])
                    arrays[f"hess_{key}"] = p.hessian(t[f"a{n}"])

    # the cell counter witnesses the executed/kept accounting
    f = testfns.rosenbrock
    counters = {}
    for n in (13, 16):
        for lay in ("cyclic", "block"):
            seen = []
            distributed.distributed_hvp_rows(
                mesh, f, t[f"a{n}"], t[f"v{n}"], csize=4, symmetric=True,
                row_layout=lay, cell_counter=seen.append)
            distributed.distributed_hessian_rows(
                mesh, f, t[f"a{n}"], csize=4, symmetric=True,
                row_layout=lay, cell_counter=seen.append)
            counters[f"{n}_{lay}"] = seen
    info["counters"] = counters

    # L0: instances over the data axis, direct and through the engine
    A, V = t["A"], t["V"]
    for sym in (False, True):
        for level in ("L1", "L2"):
            arrays[f"batched_{int(sym)}_{level}"] = (
                distributed.distributed_batched_hvp(
                    mesh, f, A, V, csize=2, level=level, symmetric=sym))
    p = engine.plan(f, A.shape[1], csize=2, mesh=mesh, symmetric=False,
                    device="cpu")
    arrays["batched_plan"] = p.batched_hvp(A, V)
    info["indivisible_m"] = _raises(
        lambda: p.batched_hvp(A[:3], V[:3]), ValueError)
    info["unknown_layout"] = [
        _raises(lambda: distributed.distributed_hvp_rows(
            mesh, f, t["a13"], t["v13"], csize=4, symmetric=sym,
            row_layout="diagonal"), ValueError) for sym in (False, True)]
    # each rank would tune alone: csize="autotune" on a mesh of 8 raises
    info["autotune_refused"] = [
        _raises(lambda: engine.plan(f, 13, m=m, csize="autotune", mesh=mesh,
                                    device="cpu"), ValueError)
        for m in (None, 16)]

    # a mesh-less plan never resolves to a mesh-native backend
    flat = engine.plan(f, 13, csize=4, device="cpu")
    note("flat", flat, "hvp", "hessian", "batched_hvp", "batched_hessian")

    # a data-only mesh has no row axis: hvp falls through to the flat
    # backends, batched_hvp shards over all eight ranks
    mesh_d = make_test_mesh((8,), ("data",), device="cpu")
    p_d = engine.plan(f, 13, csize=4, mesh=mesh_d, device="cpu")
    note("data_only", p_d, "hvp", "batched_hvp")
    arrays["batched_data8"] = p_d.batched_hvp(A, V)

    # the model_axis option: a mesh whose row axis is named "rows"
    mesh_rows = make_test_mesh((2, 4), ("data", "rows"), device="cpu")
    note("rows_default", engine.plan(f, 13, csize=4, mesh=mesh_rows,
                                     device="cpu"), "hvp")
    p_rows = engine.plan(f, 13, csize=4, mesh=mesh_rows, model_axis="rows",
                         symmetric=True, device="cpu")
    note("rows_named", p_rows, "hvp")
    arrays["hvp_rows_named"] = p_rows.hvp(t["a13"], t["v13"])

    # two data axes: one group over ("pod", "data")
    mesh3 = make_test_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    p3 = engine.plan(f, A.shape[1], csize=2, mesh=mesh3, symmetric=False,
                     data_axes=("pod", "data"), device="cpu")
    note("pod_data", p3, "batched_hvp", "hvp")
    arrays["batched_pod_data"] = p3.batched_hvp(A, V)
    arrays["hvp_pod_data"] = p3.hvp(t["a13"][:A.shape[1]],
                                    t["v13"][:A.shape[1]])
    return {k: v.numpy() for k, v in arrays.items()}, info


def collectives_body(inputs):
    """parallel.collectives on a ("pod", "data") = (2, 4) mesh: each rank
    holds row pod * 4 + data of g and syncs it."""
    import torch

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import hierarchical_grad_sync

    mesh = make_test_mesh((2, 4), ("pod", "data"), device="cpu")
    row = mesh.get_local_rank("pod") * 4 + mesh.get_local_rank("data")
    g = torch.as_tensor(inputs["g"])
    arrays = {}
    for method in ("none", "bf16", "int8"):
        gen = torch.Generator().manual_seed(0)
        arrays[method] = hierarchical_grad_sync(
            {"g": g[row:row + 1].clone()}, mesh, data_axis="data",
            pod_axis="pod", generator=gen, method=method)["g"].numpy()
    return arrays, {"row": int(row)}


BODIES = {"distributed": distributed_body, "collectives": collectives_body}


def main(argv):
    body, rank, world, store, src, out = argv
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        arrays, info = BODIES[body](dict(np.load(src)))
        np.savez(Path(out) / f"rank{rank}.npz", **arrays)
        (Path(out) / f"rank{rank}.json").write_text(json.dumps(info))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
