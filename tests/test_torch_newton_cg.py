"""repro_torch.optim.newton_cg (tests/test_newton_cg.py is the template):
both HVP engines drive the gradient to ~0, the engines agree, descent is
monotone, and the trajectory follows the reference's at n = 8.

Trajectory bound: per-iteration f and gnorm within 1e-5 relative, and the
same iteration count, over the first 6 Newton steps of Rosenbrock.  Both
packages run float32; on this nonconvex function a rounding difference
grows by a few times per Newton step (gnorm drifts past 1e-5 relative from
about step 7, with either engine, though both runs still converge in 26-27
steps), so a longer horizon would compare rounding noise, not the port."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import testfns as jtestfns  # noqa: E402
from repro.optim.newton_cg import newton_cg as jnewton_cg  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core import testfns  # noqa: E402
from repro_torch.optim.newton_cg import newton_cg  # noqa: E402


@pytest.mark.parametrize("engine_name", ["chessfad", "fwdrev"])
def test_rosenbrock_minimized(engine_name):
    n = 8
    x0 = torch.zeros(n) - 0.5
    x, info = newton_cg(testfns.rosenbrock, x0, engine=engine_name, csize=2,
                        max_outer=80, cg_iters=30, device="cpu")
    # global minimum at x = 1
    np.testing.assert_allclose(x.numpy(), np.ones(n), atol=1e-3)
    assert info["trajectory"][-1]["f"] < 1e-6


def test_engines_agree_on_quadratic():
    n = 12
    f = testfns.make_fletcher_powell(n)
    x0 = testfns.sample_point(n, seed=3) * 0.1
    # both must reach a stationary point of the same basin; FP's +-100
    # integer coefficients put gradient scales at ~1e4, so the criterion
    # is relative to the starting gradient (and each run stops at a tenth
    # of it instead of running on to max_outer)
    g0 = float(torch.linalg.norm(torch.func.grad(f)(x0)))
    kw = dict(max_outer=30, grad_tol=1e-5 * g0, device="cpu")
    xa, ia = newton_cg(f, x0, engine="chessfad", csize=4, **kw)
    xb, ib = newton_cg(f, x0, engine="fwdrev", **kw)
    assert ia["trajectory"][0]["gnorm"] == pytest.approx(g0, rel=1e-6)
    assert ia["trajectory"][-1]["gnorm"] < 1e-4 * g0
    assert ib["trajectory"][-1]["gnorm"] < 1e-4 * g0
    np.testing.assert_allclose(float(f(xa)), float(f(xb)), rtol=1e-2,
                               atol=1e-3)


def test_descent_monotone():
    n = 6
    x0 = testfns.sample_point(n, seed=1)
    _, info = newton_cg(testfns.ackley, x0, engine="fwdrev", max_outer=6,
                        device="cpu")
    fs = [t["f"] for t in info["trajectory"]]
    assert all(b <= a + 1e-9 for a, b in zip(fs, fs[1:]))


@pytest.mark.parametrize("engine_name", ["chessfad", "fwdrev"])
def test_trajectory_follows_reference(engine_name):
    x0 = np.zeros(8, np.float32) - 0.5
    kw = dict(engine=engine_name, csize=2, max_outer=6, cg_iters=30)
    _, got = newton_cg(testfns.rosenbrock, torch.tensor(x0), device="cpu",
                       **kw)
    _, want = jnewton_cg(jtestfns.rosenbrock, jnp.asarray(x0), **kw)
    assert set(got) == set(want)
    assert got["iterations"] == want["iterations"]
    assert got["hvp_calls_upper_bound"] == want["hvp_calls_upper_bound"]
    for g, w in zip(got["trajectory"], want["trajectory"]):
        assert set(g) == set(w) and g["iter"] == w["iter"]
        np.testing.assert_allclose(g["f"], w["f"], rtol=1e-5)
        np.testing.assert_allclose(g["gnorm"], w["gnorm"], rtol=1e-5)


def test_chessfad_plans_the_single_point_hvp_on_vmap():
    """The plan's workload is ``hvp``; ``cuda`` serves only
    ``batched_hvp``, so ``auto`` resolves Newton-CG to a vmap backend on
    any device (the reference resolves it to vmap on the TPU)."""
    p = engine.plan(testfns.rosenbrock, 64, csize=4, symmetric=True,
                    device="cpu")
    assert p.backend_for("hvp").startswith("vmap_l")


def test_named_backends_and_typos():
    x0 = torch.zeros(4) - 0.5
    xr, _ = newton_cg(testfns.rosenbrock, x0, engine="reference", csize=2,
                      max_outer=3, device="cpu")
    xc, _ = newton_cg(testfns.rosenbrock, x0, engine="chessfad", csize=2,
                      max_outer=3, device="cpu")
    np.testing.assert_allclose(xr.numpy(), xc.numpy(), rtol=1e-5, atol=1e-6)
    xp, _ = newton_cg(lambda x: (x ** 4).sum() + (x ** 2).sum(), x0,
                      engine="pytree_fwdrev", max_outer=5, device="cpu")
    assert float(torch.linalg.norm(xp)) < float(torch.linalg.norm(x0))
    with pytest.raises(ValueError):
        newton_cg(testfns.rosenbrock, x0, engine="no_such_backend",
                  device="cpu")
