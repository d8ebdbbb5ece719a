"""End-to-end training on the PyTorch port: a ~100M-parameter
decoder LM trained with SophiaH, whose diagonal-Hessian preconditioner
comes from the CHESSFAD chunked-HVP engine -- the paper's "many HVPs,
chunked" workload running as a production optimizer feature.

Default run is CPU-sized (lm-tiny); --full trains the real ~100M config
for --steps steps (same code).  Checkpoints go to --ckpt-dir (default
$TMPDIR/repro_torch_<model>), and a run resumes from its LATEST.

    PYTHONPATH=src python examples_torch/train_lm.py --device cpu  # tiny
    PYTHONPATH=src python examples_torch/train_lm.py --full --steps 300
"""

import argparse
import os
import tempfile

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data import SyntheticTokens
from repro_torch.engine import resolve_device
from repro_torch.models.params import init_params
from repro_torch.optim import adamw, sophia_h
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.training import (TrainLoop, TrainLoopConfig, TrainState,
                                  make_train_step)


def lm_100m() -> ModelConfig:
    """~100M decoder (GPT-2-small-ish, llama-style blocks)."""
    return ModelConfig(name="lm-100m", family="dense", num_layers=12,
                       d_model=768, num_heads=12, num_kv_heads=12,
                       d_ff=2048, vocab_size=32000)


def lm_tiny() -> ModelConfig:
    return ModelConfig(name="lm-tiny", family="dense", num_layers=4,
                       d_model=128, num_heads=4, num_kv_heads=4,
                       d_ff=512, vocab_size=2048)


def main(argv=None):
    """Trains; returns the printed figures and the loop's per-step metrics
    (``"metrics"``).  Raises AssertionError if the loss did not drop."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true", help="~100M params")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--optimizer", default="sophia_h",
                    choices=["sophia_h", "adamw"])
    ap.add_argument("--hess-every", type=int, default=10)
    ap.add_argument("--probes", type=int, default=4)
    ap.add_argument("--csize", type=int, default=2,
                    help="CHESSFAD probe chunk for the curvature engine")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = lm_100m() if args.full else lm_tiny()
    n_params = cfg.num_params()
    print(f"model {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"optimizer={args.optimizer}")

    lr = warmup_cosine(3e-4 if args.full else 1e-3,
                       max(args.steps // 20, 1), args.steps)
    if args.optimizer == "sophia_h":
        opt = sophia_h(lr, hess_every=args.hess_every,
                       n_probes=args.probes, csize=args.csize)
    else:
        opt = adamw(lr)

    params = init_params(cfg, 0, device=device)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int64, device=device), 1)
    step_fn = make_train_step(cfg, None, opt)
    ds = SyntheticTokens(cfg.vocab_size, args.batch, args.seq, seed=0,
                         device=device)

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             f"repro_torch_{cfg.name}")
    loop = TrainLoop(
        TrainLoopConfig(total_steps=args.steps, ckpt_dir=ckpt_dir,
                        ckpt_every=max(args.steps // 4, 1),
                        log_path=os.path.join(ckpt_dir, "metrics.jsonl")),
        step_fn,
        lambda s: {"tokens": ds.batch_at(s)},
        state)
    resumed = loop.maybe_resume()
    if resumed:
        print(f"resumed from checkpoint at step {resumed}")
    result = loop.run()

    ms = [m for m in result["metrics"] if "loss" in m]
    first = sum(m["loss"] for m in ms[:10]) / max(len(ms[:10]), 1)
    last = sum(m["loss"] for m in ms[-10:]) / max(len(ms[-10:]), 1)
    print(f"steps: {result['final_step']}  "
          f"loss {first:.3f} -> {last:.3f}  "
          f"(checkpoints in {ckpt_dir})")
    assert last < first, "training must reduce loss"
    return {"model": cfg.name, "params": n_params,
            "optimizer": args.optimizer, "resumed": resumed,
            "final_step": result["final_step"], "first": first,
            "last": last, "ckpt_dir": ckpt_dir,
            "stragglers": result["stragglers"],
            "metrics": result["metrics"], "device": str(device)}


if __name__ == "__main__":
    main()
