"""core.api port vs the JAX reference, batched part: the L0/L1/L2 schedules
(Alg. 9, Alg. 10, Fig. 2) and compute_dtype, the gradient, the torch.func
oracles and the engine-backed facades, at the tolerances of
tests/test_chessfad_api.py."""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core import testfns as jtestfns  # noqa: E402
from repro_torch.core import api, ref, testfns  # noqa: E402

FNS = ("rosenbrock", "ackley", "fletcher_powell")

# the reference's raw schedule, compiled once per static signature (eager
# op-by-op dispatch of the vmapped schedules is several times slower)
j_batched_hvp_impl = jax.jit(japi.batched_hvp_impl,
                             static_argnums=(0, 3, 4, 5))


def _fns(fname, n):
    return testfns.FUNCTIONS[fname](n), jtestfns.FUNCTIONS[fname](n)


def _data(tag, m, n):
    rng = np.random.RandomState(zlib.crc32(tag.encode()))
    A = rng.uniform(-2, 2, (m, n)).astype(np.float32)
    V = rng.randn(m, n).astype(np.float32)
    return A, V


def _close(got, want, rtol=2e-3, atol=2e-3):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("level,symmetric", [("L0", False), ("L1", False),
                                              ("L2", False), ("L2", True)])
@pytest.mark.parametrize("fname", FNS)
def test_batched_hvp_impl_matches_jax(fname, level, symmetric):
    for n, csize in [(12, 3), (6, 8)]:
        f, jf = _fns(fname, n)
        A, V = _data(f"{fname}{level}{n}", 5, n)
        tA, tV = torch.from_numpy(A), torch.from_numpy(V)
        got = api.batched_hvp_impl(f, tA, tV, csize, level, symmetric)
        want = j_batched_hvp_impl(jf, jnp.asarray(A), jnp.asarray(V),
                                  csize, level, symmetric)
        assert got.shape == (5, n) and got.dtype == torch.float32
        _close(got, want)
        if level != "L2":
            # as in the reference, L0/L1 always sweep the full chunk grid
            assert torch.equal(
                api.batched_hvp_impl(f, tA, tV, csize, level, True), got)


@pytest.mark.parametrize("fname", FNS)
def test_compute_dtype_float64_matches_jax(fname):
    """Sweeps widened to float64, accumulation in the input dtype: still the
    reference's HVP at its tolerance."""
    n, csize = 8, 4
    f, jf = _fns(fname, n)
    A, V = _data(f"{fname}f64", 3, n)
    got = api.batched_hvp_impl(f, torch.from_numpy(A), torch.from_numpy(V),
                               csize, "L2", True, compute_dtype=torch.float64)
    assert got.dtype == torch.float32
    _close(got, j_batched_hvp_impl(jf, jnp.asarray(A), jnp.asarray(V),
                                   csize, "L2", True))


def test_gradient_matches_jax_grad():
    n = 10
    f, jf = _fns("ackley", n)
    a = np.asarray(jtestfns.sample_point(n, seed=3))
    g = api.gradient(f, torch.from_numpy(a), csize=4)
    _close(g, jax.grad(jf)(jnp.asarray(a)), rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(testfns.sample_point(n, seed=3),
                               torch.from_numpy(a))


@pytest.mark.parametrize("fname", FNS)
def test_oracles_agree(fname):
    n = 7
    f, jf = _fns(fname, n)
    A, V = _data(f"{fname}oracle", 1, n)
    a, v = torch.from_numpy(A[0]), torch.from_numpy(V[0])
    H = np.asarray(jax.hessian(jf)(jnp.asarray(A[0])))
    tol = dict(rtol=2e-3, atol=2e-3 * (1 + np.abs(H).max()))
    for oracle in (ref.hessian_rev, ref.hessian_fwdfwd, ref.hessian_fwdrev):
        _close(oracle(f, a), H, **tol)
    for oracle in (ref.hvp_fwdrev, ref.hvp_fwdfwd):
        _close(oracle(f, a, v), H @ V[0], **tol)


def test_facades_on_cpu_tensors_match_jax():
    n, csize = 8, 2
    f, jf = _fns("rosenbrock", n)
    A, V = _data("facades", 4, n)
    tA, tV = torch.from_numpy(A), torch.from_numpy(V)
    _close(api.hessian(f, tA[0], csize=csize),
           japi.hessian(jf, jnp.asarray(A[0]), csize=csize))
    _close(api.hvp(f, tA[0], tV[0], csize=csize),
           japi.hvp(jf, jnp.asarray(A[0]), jnp.asarray(V[0]), csize=csize))
    for level in ("L0", "L1", "L2"):
        _close(api.batched_hvp(f, tA, tV, csize=csize, level=level),
               japi.batched_hvp(jf, jnp.asarray(A), jnp.asarray(V),
                                csize=csize, level=level))
    _close(api.batched_hessian(f, tA, csize=csize),
           japi.batched_hessian(jf, jnp.asarray(A), csize=csize))
