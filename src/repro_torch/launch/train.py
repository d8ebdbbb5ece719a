"""Training entry point, on one device or on a mesh of ranks.

  python -m repro_torch.launch.train --arch h2o-danube-1.8b [--reduced] \
      --steps 200 --batch 8 --seq 256 --optimizer sophia_h \
      --ckpt-dir "$TMPDIR/ckpt" [--device cuda|cpu] [--data-mesh D] \
      [--moe-impl gspmd_sort|shard_map_local]

  torchrun --nproc-per-node 4 -m repro_torch.launch.train ... --data-mesh 2

Counterpart of ``repro.launch.train``: the same flags, plus ``--device``
(the card by default) and ``--moe-impl`` (the config's ``moe_impl``:
``shard_map_local`` runs each rank's own experts on a mesh,
``models.moe_sharded``).  Runs the step-keyed synthetic token pipeline
through ``make_train_step`` inside the fault-tolerant ``TrainLoop``, which
resumes from the latest checkpoint in ``--ckpt-dir``.  SophiaH runs with
its defaults, as in the reference.

The multi-host entry: when the launcher's environment names a world
(``WORLD_SIZE`` and ``MASTER_ADDR``, as ``torchrun`` sets them), the
process joins it (``dist.init_process_group``, NCCL on the card, gloo on
the CPU) and takes ``cuda:LOCAL_RANK``; the counterpart of the
reference's ``COORDINATOR_ADDRESS``.  Then, or whenever ``--data-mesh`` is
given, it trains on a ("data", "model") mesh of (D, world // D) (D = 0:
the whole world on "data"): params placed by ``param_specs``, batches
sharded by ``batch_spec``, the state resumed onto the mesh through
``state_shardings``.  Outside a world, ``--data-mesh 1`` starts a world of
one; any other D raises.  With neither, it runs on one device with no
mesh.  Every architecture trains: the enc-dec and VLM families' batches
come from ``data.global_batch_at``, with its seeded ``frames`` /
``patches`` (a VLM's ``--seq`` counts its patches, as the reference's).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.data import SyntheticTokens, global_batch_at
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.params import init_params
from repro_torch.optim import OPTIMIZERS
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.parallel.sharding import NamedSharding, batch_spec
from repro_torch.training import (TrainLoop, TrainLoopConfig, TrainState,
                                  make_train_step, state_shardings)


def _join_world(device_type: str) -> torch.device:
    """Join the world the launcher's environment names (multi-host
    entry); the device this rank trains on."""
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl")
        return torch.device("cuda", local)
    dist.init_process_group("gloo")
    return torch.device("cpu")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--optimizer", default="adamw",
                    choices=list(OPTIMIZERS))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--data-mesh", type=int, default=None,
                    help="data axis size of the ('data', 'model') mesh "
                         "(0 = the whole world); omitted outside a "
                         "launched world: one device, no mesh")
    ap.add_argument("--moe-impl", default=None,
                    choices=("gspmd_sort", "shard_map_local"),
                    help="the MoE dispatch (default: the config's)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device; pass --device cpu to train on the CPU")

    cfg = get_config(args.arch, reduced=args.reduced)
    if args.moe_impl is not None:
        cfg = dataclasses.replace(cfg, moe_impl=args.moe_impl)
    device = torch.device(args.device)
    joined = False
    owned = not dist.is_initialized()     # a caller's world outlives us
    if (os.environ.get("WORLD_SIZE") and os.environ.get("MASTER_ADDR")
            and owned):
        device = _join_world(args.device)       # multi-host entry
        joined = True
    mesh = None
    if joined or args.data_mesh is not None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        dsize = args.data_mesh or world
        if world % dsize:
            ap.error(f"--data-mesh {dsize} does not divide the world of "
                     f"{world}")
        mesh = make_test_mesh((dsize, world // dsize), ("data", "model"),
                              device=device.type)
    try:
        return _train(args, cfg, device, mesh)
    finally:
        if mesh is not None and owned:
            dist.destroy_process_group()


def _train(args, cfg, device, mesh):
    opt = OPTIMIZERS[args.optimizer](
        warmup_cosine(args.lr, max(args.steps // 20, 1), args.steps))
    params = init_params(cfg, args.seed, device=device)
    shardings = None
    if mesh is not None:
        shardings = state_shardings(cfg, mesh, opt, params)
        params = pytree.tree_map(lambda s, p: s.shard(p), shardings.params,
                                 params)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int64, device=device),
                       args.seed + 1)

    step_fn = make_train_step(cfg, mesh, opt)
    ds = SyntheticTokens(cfg.vocab_size, args.batch, args.seq, args.seed,
                         device=device)
    bsharding = (NamedSharding(mesh, batch_spec(mesh))
                 if mesh is not None else None)

    shape = InputShape("train", args.seq, args.batch, "train")

    def batch_fn(step):
        if cfg.frontend:
            return global_batch_at(cfg, shape, step, sharding=bsharding,
                                   seed=args.seed, device=device)
        return {"tokens": ds.batch_at(step, bsharding)}

    # one rank logs and prints; every rank saves and restores together
    first = mesh is None or dist.get_rank() == 0
    loop = TrainLoop(
        TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                        ckpt_every=args.ckpt_every,
                        log_path=(os.path.join(args.ckpt_dir, "metrics.jsonl")
                                  if first else None)),
        step_fn, batch_fn, state, state_shardings=shardings)
    result = loop.run()
    if first:
        last = [m for m in result["metrics"] if "loss" in m][-5:]
        print(f"finished at step {result['final_step']}; last losses: "
              + ", ".join(f"{m['loss']:.4f}" for m in last))
        if result["stragglers"]:
            print(f"stragglers detected: {result['stragglers']}")
    return result


if __name__ == "__main__":
    main()
