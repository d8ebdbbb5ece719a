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
    # csize="autotune" on the mesh of 8 is one SPMD sweep: every rank
    # times the same candidates, the times reduced over the mesh, so every
    # rank plans the same csize (ROADMAP C.4)
    tuned_hvp = engine.plan(f, 13, csize="autotune", mesh=mesh, device="cpu")
    tuned_batched = engine.plan(f, A.shape[1], m=A.shape[0],
                                csize="autotune", mesh=mesh, device="cpu")
    info["autotune_csize"] = [tuned_hvp.csize, tuned_batched.csize]
    arrays["hvp_autotune"] = tuned_hvp.hvp(t["a13"], t["v13"])
    arrays["batched_autotune"] = tuned_batched.batched_hvp(A, V)

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


def sharding_body(inputs):
    """parallel.sharding's DTensor placements on a ("pod", "data",
    "model") = (2, 2, 2) mesh."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.params import flatten, init_params, param_specs
    from repro_torch.parallel.sharding import NamedSharding, shard_like

    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    x = torch.as_tensor(inputs["x"])
    ns = NamedSharding(mesh, (("pod", "data"), "model"))
    dt = ns.shard(x)
    arrays = {"shard": dt.to_local().numpy(),
              "distribute": distribute_tensor(
                  x, mesh, ns.placements()).to_local().numpy(),
              "full": dt.full_tensor().numpy()}
    # every reduced-config leaf: NamedSharding.shard and distribute_tensor
    # cut the same block, and shard_like of the gathered leaf places it so
    cfg = get_config("minitron-4b", reduced=True)
    params = flatten(init_params(cfg, 0, device="cpu"))
    ok = True
    for path, spec in flatten(param_specs(cfg, mesh)).items():
        leaf = NamedSharding(mesh, spec)
        mine = leaf.shard(params[path])
        theirs = distribute_tensor(params[path], mesh, leaf.placements())
        again = shard_like(mine.full_tensor(), theirs)
        ok &= (torch.equal(mine.to_local(), theirs.to_local())
               and torch.equal(again.to_local(), theirs.to_local())
               and torch.equal(mine.full_tensor(), params[path]))
    return arrays, {"coords": [mesh.get_local_rank(a)
                               for a in ("pod", "data", "model")],
                    "placements": [str(p) for p in ns.placements()],
                    "params_placed": bool(ok)}


def _flat_params(inputs, prefix="p/"):
    return {k[len(prefix):]: v for k, v in inputs.items()
            if k.startswith(prefix)}


def _train_config(name):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name, reduced=True),
                               compute_dtype="float32")


def _run_steps(step_fn, state, batches):
    """Run the steps; (state, [metrics as floats per step])."""
    out = []
    for b in batches:
        state, m = step_fn(state, b)
        out.append({k: float(v) for k, v in m.items()})
    return state, out


def mesh_training_body(inputs):
    """training.steps on ("data", "model") = (2, 4) and ("pod", "data",
    "model") = (2, 2, 2) meshes, the reduced minitron-4b at float32
    compute: the mesh step (AdamW; SophiaH on (2, 4)) and the shard-map
    step, every rank returning its whole params after two steps."""
    import torch
    from torch.utils import _pytree as pt

    from repro_torch import convert
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.params import flatten
    from repro_torch.optim import adamw, sophia_h, warmup_cosine
    from repro_torch.parallel.sharding import NamedSharding, batch_spec
    from repro_torch.training import (TrainState, make_shard_map_train_step,
                                      make_train_step, state_shardings)

    cfg = _train_config("minitron-4b")
    B, S = (int(v) for v in inputs["shape"])
    lr = tuple(float(v) for v in inputs["lr"])
    sophia = {k: float(v) if k == "hess_batch_frac" else int(v)
              for k, v in zip(("hess_every", "n_probes", "csize",
                               "hess_batch_frac"), inputs["sophia"])}
    ds = SyntheticTokens(cfg.vocab_size, B, S, 0, device="cpu")
    arrays, info = {}, {}

    def state_on(mesh, opt, sharded):
        params = convert.lm_params_from_numpy(_flat_params(inputs),
                                              device="cpu")
        if sharded:
            sh = state_shardings(cfg, mesh, opt, params)
            params = pt.tree_map(lambda s, p: s.shard(p), sh.params, params)
        return TrainState(params, opt.init(params),
                          torch.zeros((), dtype=torch.int64), 1)

    def record(key, state, metrics):
        info[key] = metrics
        for prefix, tree in (("", state.params),
                             ("m/", state.opt_state["m"])):
            for path, leaf in flatten(tree).items():
                if hasattr(leaf, "full_tensor"):
                    leaf = leaf.full_tensor()
                arrays[f"{key}/{prefix}{path}"] = leaf.numpy()
        if key.startswith("mesh"):
            info[key + "_dtensor"] = all(
                hasattr(x, "full_tensor")
                for x in pt.tree_leaves((state.params, state.opt_state)))

    meshes = {"24": make_test_mesh((2, 4), ("data", "model"), device="cpu"),
              "222": make_test_mesh((2, 2, 2), ("pod", "data", "model"),
                                    device="cpu")}
    for name, mesh in meshes.items():
        # the (2, 4) mesh takes whole batches, the (2, 2, 2) mesh batches
        # sharded by batch_spec: each rank makes only its own rows
        rows = None if name == "24" else NamedSharding(mesh,
                                                       batch_spec(mesh))
        batches = [{"tokens": ds.batch_at(k, rows)} for k in range(2)]
        opt = adamw(warmup_cosine(*lr))
        state, m = _run_steps(make_train_step(cfg, mesh, opt),
                              state_on(mesh, opt, True), batches)
        record(f"mesh_adamw_{name}", state, m)
        if name == "24":
            opt = sophia_h(warmup_cosine(*lr), **sophia)
            state, m = _run_steps(make_train_step(cfg, mesh, opt),
                                  state_on(mesh, opt, True), batches)
            record(f"mesh_sophia_{name}", state, m)
        for compress in (("none",) if name == "24"
                         else ("none", "bf16", "int8")):
            opt = adamw(warmup_cosine(*lr))
            step = make_shard_map_train_step(cfg, mesh, opt,
                                             compress=compress)
            state, m = _run_steps(step, state_on(mesh, opt, False), batches)
            record(f"smap_{compress}_{name}", state, m)
    info["cli"] = _train_cli_resume(str(inputs["ckpt_dir"]))
    _moe_sharded(inputs, arrays, info)
    return arrays, info


def _moe_sharded(inputs, arrays, info):
    """models.moe_sharded on a ("data", "model") = (4, 2) mesh: each rank
    takes its data coordinate's 16 of the 64 tokens, its outputs and the
    gradients of <y, r> for the tokens and the whole weights; the
    fallback on 5 experts; then two mesh steps of the reduced
    granite-moe-1b-a400m with ``moe_impl="shard_map_local"`` on the (2, 4)
    mesh (one expert a rank), and two with ``"gspmd_sort"`` at capacity
    factor 0.5, which route the global batch."""
    import dataclasses

    import torch
    from torch.utils import _pytree as pt

    from repro_torch import convert
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.moe_sharded import moe_block_sharded
    from repro_torch.models.params import flatten
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.training import (TrainState, make_train_step,
                                      state_shardings)

    mesh = make_test_mesh((4, 2), ("data", "model"), device="cpu")
    d = mesh.get_local_rank("data")
    rows = slice(16 * d, 16 * (d + 1))
    info["moe_coords"] = [d, mesh.get_local_rank("model")]
    for tag, name in (("moe", "granite-moe-1b-a400m"),
                      ("moe5", "granite-moe-3b-a800m")):
        cfg = dataclasses.replace(_train_config(name), capacity_factor=4.0)
        x = torch.as_tensor(inputs[f"{tag}/x"][rows]).requires_grad_()
        p = {k: torch.as_tensor(v).requires_grad_()
             for k, v in _flat_params(inputs, f"{tag}/p/").items()}
        y, aux = moe_block_sharded(x, p, cfg, mesh)
        (y * torch.as_tensor(inputs[f"{tag}/r"][rows])).sum().backward()
        arrays[f"{tag}/y"] = y.detach().numpy()
        arrays[f"{tag}/gx"] = x.grad.numpy()
        for k, v in p.items():
            arrays[f"{tag}/g/{k}"] = v.grad.numpy()
        info[f"{tag}/aux"] = aux.item()

    cfg = dataclasses.replace(_train_config("granite-moe-1b-a400m"),
                              moe_impl="shard_map_local")
    mesh24 = make_test_mesh((2, 4), ("data", "model"), device="cpu")
    B, S = (int(v) for v in inputs["shape"])
    ds = SyntheticTokens(cfg.vocab_size, B, S, 0, device="cpu")
    opt = adamw(warmup_cosine(*(float(v) for v in inputs["lr"])))
    params = convert.lm_params_from_numpy(_flat_params(inputs, "g/"),
                                          device="cpu")
    sh = state_shardings(cfg, mesh24, opt, params)
    params = pt.tree_map(lambda s, q: s.shard(q), sh.params, params)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int64), 1)
    state, m = _run_steps(make_train_step(cfg, mesh24, opt), state,
                          [{"tokens": ds.batch_at(k)} for k in range(2)])
    info["moe_mesh_step"] = m
    for path, leaf in flatten(state.params).items():
        arrays[f"moe_mesh_step/{path}"] = leaf.full_tensor().numpy()

    # gspmd_sort on the same mesh routes the global batch: every rank
    # gathers the data ranks' rows (capacity factor 0.5: tokens drop)
    from repro_torch.models import moe
    from repro_torch.models.model import loss_fn
    from repro_torch.training.steps import _local_rows

    cfg = dataclasses.replace(_train_config("granite-moe-1b-a400m"),
                              moe_impl="gspmd_sort", capacity_factor=0.5)
    params = convert.lm_params_from_numpy(_flat_params(inputs, "g/"),
                                          device="cpu")
    with torch.no_grad(), moe.record_drops() as drops:
        loss_fn(params, cfg, _local_rows({"tokens": ds.batch_at(0)},
                                         mesh24), mesh24)
    info["moe_global_drops"] = [[int(d), n] for d, n in drops]
    sh = state_shardings(cfg, mesh24, opt, params)
    params = pt.tree_map(lambda s, q: s.shard(q), sh.params, params)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int64), 1)
    state, m = _run_steps(make_train_step(cfg, mesh24, opt), state,
                          [{"tokens": ds.batch_at(k)} for k in range(2)])
    info["moe_global_step"] = m
    for path, leaf in flatten(state.params).items():
        arrays[f"moe_global_step/{path}"] = leaf.full_tensor().numpy()


def _train_cli_resume(ckpt):
    """``launch.train --data-mesh 2`` on the world: 4 steps with a
    checkpoint every 2; then LATEST is rewound to step 2 (step 4's
    checkpoint kept aside) and a second run resumes there.  Rank 0
    reports whether the resumed step-4 checkpoint equals the first run's
    bitwise."""
    import shutil

    import torch.distributed as dist

    from repro_torch.launch import train as train_cli

    args = ["--arch", "minitron-4b", "--reduced", "--steps", "4",
            "--batch", "4", "--seq", "16", "--ckpt-every", "2",
            "--device", "cpu", "--data-mesh", "2", "--ckpt-dir", ckpt]
    first = train_cli.main(args)
    step4, aside = Path(ckpt) / "step_4", Path(ckpt + "_aside")
    if dist.get_rank() == 0:
        shutil.copytree(step4, aside)
        shutil.rmtree(step4)
        (Path(ckpt) / "LATEST").write_text("2")
    dist.barrier()
    again = train_cli.main(args)
    out = {"final": [first["final_step"], again["final_step"]],
           "resumed_steps": [m["step"] for m in again["metrics"]]}
    if dist.get_rank() == 0:
        meta = json.loads((aside / "meta.json").read_text())["leaves"]
        out["leaves"] = len(meta)
        out["equal"] = all(
            np.array_equal(np.load(aside / leaf["file"]),
                           np.load(step4 / leaf["file"]))
            for leaf in meta.values())
    return out


def pipeline_body(inputs):
    """training.pipeline on a ("pipe", "data") = (4, 2) mesh, the elastic
    restore from a (2, 4) to a (4, 2) mesh, and sharded synthetic rows on
    a ("pod", "data", "model") = (2, 2, 2) mesh."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.sharding import NamedSharding, batch_spec
    from repro_torch.training.pipeline import pipeline_forward, stack_stages

    arrays, info = {}, {}
    # GPipe: 8 layers in 4 stages, 4 microbatches; forward and the
    # gradients of out.sum() w.r.t. the staged params and x
    mesh = make_test_mesh((4, 2), ("pipe", "data"), device="cpu")
    staged = {k: v.clone().requires_grad_() for k, v in stack_stages(
        {"w": torch.as_tensor(inputs["w"]),
         "b": torch.as_tensor(inputs["b"])}, 4).items()}
    x = torch.as_tensor(inputs["x"]).clone().requires_grad_()

    def body(lp, h):
        return torch.tanh(h @ lp["w"] + lp["b"])

    out = pipeline_forward(body, staged, x, mesh, n_microbatches=4)
    out.sum().backward()
    arrays.update(out=out.detach().numpy(), gw=staged["w"].grad.numpy(),
                  gb=staged["b"].grad.numpy(), gx=x.grad.numpy())

    # elastic restart: saved from DTensors on (2, 4), restored onto (4, 2)
    # with ("model", "data") placements
    tree = {"w": torch.as_tensor(inputs["tw"]),
            "m": torch.as_tensor(inputs["tm"])}
    ckpt = str(inputs["ckpt_dir"])
    mesh_a = make_test_mesh((2, 4), ("data", "model"), device="cpu")
    save_checkpoint(ckpt, 3, {k: NamedSharding(mesh_a, ("data", "model"))
                              .shard(v) for k, v in tree.items()})
    mesh_b = make_test_mesh((4, 2), ("data", "model"), device="cpu")
    target = {k: torch.zeros_like(v) for k, v in tree.items()}
    shards = {k: NamedSharding(mesh_b, ("model", "data")) for k in tree}
    restored = restore_checkpoint(ckpt, 3, target, shards)
    for k, v in restored.items():
        arrays[f"restored_{k}"] = v.full_tensor().numpy()
        arrays[f"restored_local_{k}"] = v.to_local().numpy()
    info["restored_mesh"] = {k: list(v.device_mesh.shape)
                             for k, v in restored.items()}
    info["restored_slices"] = [
        [s.start, s.stop] for s in shards["w"].local_slices(
            tree["w"].shape)]

    # sharded data: each rank makes only its rows of the global batch
    mesh3 = make_test_mesh((2, 2, 2), ("pod", "data", "model"),
                           device="cpu")
    made = []
    ds = SyntheticTokens(int(inputs["vocab"]), 8, 16, 3, device="cpu")
    real = ds._tokens_np

    def counted(step, rows):
        made.extend(int(r) for r in rows)
        return real(step, rows)

    ds._tokens_np = counted
    tok = ds.batch_at(5, NamedSharding(mesh3, batch_spec(mesh3)))
    arrays["rows"] = tok.to_local().numpy()
    info["rows_made"] = made
    info["coords"] = [mesh3.get_local_rank(a)
                      for a in ("pod", "data", "model")]
    arrays["rows_full"] = tok.full_tensor().numpy()
    dist.barrier()
    return arrays, info


BODIES = {"distributed": distributed_body, "collectives": collectives_body,
          "sharding": sharding_body, "mesh_training": mesh_training_body,
          "pipeline": pipeline_body}


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
