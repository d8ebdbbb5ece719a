"""Quickstart: CHESSFAD chunked Hessians and HVPs in five minutes, on the
PyTorch port.

    PYTHONPATH=src python examples_torch/quickstart.py                # card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu

Covers the paper's core API surface: write a function against
repro_torch.core.hmath, get chunked Hessians / Hessian-vector products with
the csize dial, and cross-check against torch.func's own AD.  Without a
card, and without ``--device cpu``, it raises the engine's
no-CUDA-device error.
"""

import argparse

import numpy as np
import torch

import repro_torch.core.hmath as hm
from repro_torch import engine
from repro_torch.core import ref, testfns
from repro_torch.core.api import (batched_hvp, gradient, hessian, hvp,
                                  num_chunk_evals, optimal_csize)
from repro_torch.core.funclock import FUNC_LOCK


def my_function(x):
    """Any composition of hmath/HDual ops works on values AND hDuals --
    the PyTorch analogue of the paper's 'replace double with hDual'."""
    return hm.sin(x[0] * x[1]) + hm.exp(x[2] * 0.5) + (x * x).sum(0)


def _err(got, want) -> float:
    return float((got - want).abs().max())


def _host(t):
    return t.detach().cpu().numpy()


def main(argv=None):
    """Runs the quickstart; returns its printed figures, and under
    ``"arrays"`` the results as host arrays."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where every plan runs (default the card)")
    args = ap.parse_args(argv)
    device = engine.resolve_device(args.device)

    n = 8
    a = testfns.sample_point(n, seed=0, device=device)
    out = {"n": n, "device": str(device)}
    arrays = out["arrays"] = {}

    # --- dense Hessian, chunked (paper Alg. 6: symmetric SCHUNK-HESS) ----
    csize = optimal_csize(n)            # paper §5: sqrt(n/2)
    H = hessian(my_function, a, csize=csize, symmetric=True)
    H_ref = ref.hessian_fwdrev(my_function, a)
    out.update(csize=csize, evals=num_chunk_evals(n, csize, True),
               evals_unsymmetric=n * n // csize, H_err=_err(H, H_ref))
    print(f"Hessian ({n}x{n}), csize={csize}, evals={out['evals']} "
          f"(vs {out['evals_unsymmetric']} unsymmetric)")
    print("  max |H - H_torch| =", out["H_err"])

    # --- Hessian-vector product without materializing H (Alg. 8) --------
    v = testfns.sample_point(n, seed=1, device=device)
    r = hvp(my_function, a, v, csize=csize, symmetric=True)
    out["Hv_err"] = _err(r, H_ref @ v)
    print("  max |Hv - (Hv)_torch| =", out["Hv_err"])

    # --- the gradient falls out of the same pass (paper §4) -------------
    g = gradient(my_function, a, csize=csize)
    with FUNC_LOCK:
        g_ref = torch.func.grad(my_function)(a)
    out["g_err"] = _err(g, g_ref)
    print("  max |g - g_torch| =", out["g_err"])
    arrays.update(a=_host(a), v=_host(v), H=_host(H), H_ref=_host(H_ref),
                  Hv=_host(r), Hv_ref=_host(H_ref @ v), g=_host(g),
                  g_ref=_host(g_ref))

    # --- batched instances: the paper's GPU workload (Alg. 9/10/Fig 2) --
    m = 64
    rng = np.random.RandomState(0)
    A = torch.as_tensor(rng.uniform(-2, 2, (m, n)), dtype=torch.float32,
                        device=device)
    V = torch.as_tensor(rng.randn(m, n), dtype=torch.float32, device=device)
    arrays.update(A=_host(A), V=_host(V))
    out["batched"] = {}
    for level in ("L0", "L1", "L2"):
        R = batched_hvp(testfns.rosenbrock, A, V, csize=csize, level=level)
        finite = bool(torch.isfinite(R).all())
        out["batched"][level] = {"shape": list(R.shape), "finite": finite}
        arrays[f"batched_{level}"] = _host(R)
        print(f"  batched {level}: out {tuple(R.shape)}, finite={finite}")

    # --- the engine underneath: plan once, execute cached ----------------
    plan = engine.plan(testfns.rosenbrock, n, m=m, csize="auto",
                       backend="auto", symmetric=False, device=device)
    R = plan.execute(A, V)              # shape-dispatched single entry point
    out["plan"] = {"csize": plan.csize,
                   "backend": plan.backend_for("batched_hvp"),
                   "shape": list(R.shape)}
    arrays["plan"] = _host(R)
    print(f"  engine plan: csize={plan.csize}, "
          f"backend={out['plan']['backend']}, out {tuple(R.shape)}")
    return out


if __name__ == "__main__":
    main()
