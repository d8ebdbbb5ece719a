"""Training entry point on one device.

  python -m repro_torch.launch.train --arch h2o-danube-1.8b [--reduced] \
      --steps 200 --batch 8 --seq 256 --optimizer sophia_h \
      --ckpt-dir "$TMPDIR/ckpt" [--device cuda|cpu]

Counterpart of ``repro.launch.train``: the same flags, plus ``--device``
(the card by default).  Runs the step-keyed synthetic token pipeline
through ``make_train_step`` inside the fault-tolerant ``TrainLoop``, which
resumes from the latest checkpoint in ``--ckpt-dir``.  SophiaH runs with
its defaults, as in the reference.  The mesh (``--data-mesh``) and the
multi-host entry wait for the distributed slice.  Dense architectures
only: the other families raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokens
from repro_torch.models.model import _dense_only
from repro_torch.models.params import init_params
from repro_torch.optim import OPTIMIZERS
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.training import (TrainLoop, TrainLoopConfig, TrainState,
                                  make_train_step)


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
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device; pass --device cpu to train on the CPU")

    cfg = get_config(args.arch, reduced=args.reduced)
    _dense_only(cfg)
    device = torch.device(args.device)
    opt = OPTIMIZERS[args.optimizer](
        warmup_cosine(args.lr, max(args.steps // 20, 1), args.steps))
    params = init_params(cfg, args.seed, device=device)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int64, device=device),
                       args.seed + 1)

    step_fn = make_train_step(cfg, opt)
    ds = SyntheticTokens(cfg.vocab_size, args.batch, args.seq, args.seed,
                         device=device)

    def batch_fn(step):
        return {"tokens": ds.batch_at(step)}

    loop = TrainLoop(
        TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                        ckpt_every=args.ckpt_every,
                        log_path=os.path.join(args.ckpt_dir,
                                              "metrics.jsonl")),
        step_fn, batch_fn, state)
    result = loop.run()
    last = [m for m in result["metrics"] if "loss" in m][-5:]
    print(f"finished at step {result['final_step']}; last losses: "
          + ", ".join(f"{m['loss']:.4f}" for m in last))
    if result["stragglers"]:
        print(f"stragglers detected: {result['stragglers']}")
    return result


if __name__ == "__main__":
    main()
