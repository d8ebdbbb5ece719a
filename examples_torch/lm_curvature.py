"""CHESSFAD inside the LM, on the PyTorch port: curvature diagnostics on a
real (reduced) model, driven by the CurvatureEngine's pytree backends.

1. Chunked Hutchinson diagonal-Hessian estimate of the full training loss
   (the SophiaH preconditioner) via ``plan(f, None).diag(...)`` -- the
   probe batch plays the chunk role and the callable is cached.
2. One HVP through the same plan's cache (pytree_fwdrev backend).
3. A DENSE block Hessian of the loss w.r.t. one small parameter block via
   the paper's chunked row algorithm -- eigenvalues tell you how stiff that
   block is.

    PYTHONPATH=src python examples_torch/lm_curvature.py --arch qwen1.5-4b
    PYTHONPATH=src python examples_torch/lm_curvature.py --device cpu \
        --probes 2 --csize 2
"""

import argparse

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import engine
from repro_torch.configs import get_config
from repro_torch.core.curvature import block_hessian, rademacher_like
from repro_torch.models.model import loss_fn, make_batch
from repro_torch.models.params import flatten, init_params


def main(argv=None):
    """Runs the diagnostics; returns the printed figures."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--probes", type=int, default=8)
    ap.add_argument("--csize", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="where the model and the plan live (default the "
                         "card)")
    args = ap.parse_args(argv)
    device = engine.resolve_device(args.device)

    cfg = get_config(args.arch, reduced=True)
    params = init_params(cfg, 0, device=device)
    batch = make_batch(cfg, 2, 32, device=device)
    f = lambda p: loss_fn(p, cfg, batch)[0]

    out = {"arch": cfg.name, "probes": args.probes, "csize": args.csize,
           "device": str(device)}
    out["loss"] = float(f(params))
    print(f"loss at init: {out['loss']:.4f}")

    # ONE pytree plan: diag and hvp share the engine's callable cache
    plan = engine.plan(f, None, csize=args.csize, backend="pytree_fwdrev",
                       n_probes=args.probes, device=device)

    # --- chunked Hutchinson diag(H) over the whole parameter tree -------
    diag = plan.diag(params, 1)
    flat = flatten(diag)
    mags = {k: float(v.abs().float().mean()) for k, v in flat.items()}
    by_mag = sorted(mags.items(), key=lambda kv: -kv[1])
    out["diag_top"] = dict(by_mag[:5])
    out["diag_finite"] = all(bool(torch.isfinite(v).all())
                             for v in flat.values())
    print(f"\nHutchinson diag(H) ({args.probes} probes in chunks of "
          f"{args.csize} through one linearization):")
    for k, v in by_mag[:5]:
        print(f"  {k:42s} mean|h| = {v:.3e}")

    # --- one HVP through the same plan (cached callable) -----------------
    probe = rademacher_like(2, params)
    hv = plan.hvp(params, probe)
    hv_norm = torch.sqrt(sum((leaf.float() ** 2).sum()
                             for leaf in pytree.tree_leaves(hv)))
    out.update(hv_norm=float(hv_norm), backend=plan.backend_for("hvp"))
    print(f"\n|H v| for one Rademacher probe: {out['hv_norm']:.3e} "
          f"(backend={out['backend']})")

    # --- dense block Hessian of the final norm scale ---------------------
    H = block_hessian(f, params, "final_norm", csize=args.csize)
    evals = np.linalg.eigvalsh(H.detach().cpu().double().numpy())
    cond = abs(evals).max() / max(abs(evals).min(), 1e-12)
    out.update(block_rows=H.shape[0], eig_min=float(evals.min()),
               eig_max=float(evals.max()), condition=float(cond))
    print(f"\nblock Hessian of final_norm ({H.shape[0]}x{H.shape[0]}), "
          f"chunked rows (csize={args.csize}):")
    print(f"  eigenvalue range: [{evals.min():.3e}, {evals.max():.3e}]")
    print(f"  condition estimate: {cond:.1e}")
    return out


if __name__ == "__main__":
    main()
