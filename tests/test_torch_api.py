"""core.api / engine.opmodel / core.testfns port vs the JAX reference: the
static chunk enumerations and the §5 op model to integer equality, the
single-instance schedules (Alg. 5-8) at the tolerances of
tests/test_chessfad_api.py, and the Fletcher-Powell coefficients bit for
bit.  The batched schedules are in tests/test_torch_schedules.py."""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core import testfns as jtestfns  # noqa: E402
from repro.engine import opmodel as jopmodel  # noqa: E402
from repro_torch.core import api, testfns  # noqa: E402
from repro_torch.engine import opmodel  # noqa: E402

FNS = ("rosenbrock", "ackley", "fletcher_powell")

# the reference's raw schedules, compiled once per static signature (eager
# op-by-op dispatch of the vmapped schedules is several times slower)
j_hessian_impl = jax.jit(japi.hessian_impl, static_argnums=(0, 2, 3))
j_hvp_impl = jax.jit(japi.hvp_impl, static_argnums=(0, 3, 4))

SHAPES = [(8, 2), (12, 3), (6, 8), (8, 8)]      # ragged (12, 3); csize > n


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


@pytest.mark.parametrize("symmetric", [False, True])
def test_chunk_enumeration_matches_reference(symmetric):
    for n in range(1, 41):
        for csize in range(1, 21):
            got = api.chunk_pairs(n, csize, symmetric)
            want = japi.chunk_pairs(n, csize, symmetric)
            assert got.dtype == want.dtype and np.array_equal(got, want)
            assert (api.num_chunk_evals(n, csize, symmetric)
                    == japi.num_chunk_evals(n, csize, symmetric))


@pytest.mark.parametrize("symmetric", [False, True])
def test_op_model_matches_reference(symmetric):
    for n in list(range(1, 41)) + [48, 64, 100, 128, 200]:
        assert opmodel.csize_candidates(n) == jopmodel.csize_candidates(n)
        assert (opmodel.model_csize(n, symmetric)
                == jopmodel.model_csize(n, symmetric))
        assert (opmodel.pruned_csize_candidates(n, symmetric)
                == jopmodel.pruned_csize_candidates(n, symmetric))
        for c in opmodel.csize_candidates(n):
            assert (opmodel.exact_mults(n, c, symmetric)
                    == jopmodel.exact_mults(n, c, symmetric))
            assert (opmodel.mults_chunk_hess(n, c, 3)
                    == jopmodel.mults_chunk_hess(n, c, 3))
            assert (opmodel.mults_schunk_hess(n, c, 3)
                    == jopmodel.mults_schunk_hess(n, c, 3))


def test_optimal_csize_matches_reference():
    for n in list(range(1, 41)) + [64, 128]:
        assert api.optimal_csize(n) == japi.optimal_csize(n)
    # the main path's n: c=4 symmetric, c=8 full
    assert opmodel.model_csize(64, True) == 4
    assert opmodel.model_csize(64, False) == 8


@pytest.mark.parametrize("n", [2, 7, 12, 64])
def test_fp_coeffs_bit_identical(n):
    for got, want in zip(testfns._fp_coeffs(n), jtestfns._fp_coeffs(n)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    f = testfns.make_fletcher_powell(n)
    for got, want in zip(f.kernel_consts, jtestfns._fp_coeffs(n)):
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("fname", FNS)
def test_function_values_match_reference(fname):
    n = 9
    f, jf = _fns(fname, n)
    A, _ = _data(fname, 5, n)
    got = f(torch.from_numpy(A.T))                # trailing batch axis
    want = np.stack([np.asarray(jf(jnp.asarray(a))) for a in A])
    _close(got, want, rtol=1e-5, atol=1e-5 * (1 + np.abs(want).max()))


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("n,csize", SHAPES)
@pytest.mark.parametrize("fname", FNS)
def test_hessian_and_hvp_impl_match_jax(fname, n, csize, symmetric):
    f, jf = _fns(fname, n)
    A, V = _data(f"{fname}{n}{csize}", 1, n)
    a, v = A[0], V[0]
    _close(api.hessian_impl(f, torch.from_numpy(a), csize, symmetric),
           j_hessian_impl(jf, jnp.asarray(a), csize, symmetric))
    _close(api.hvp_impl(f, torch.from_numpy(a), torch.from_numpy(v), csize,
                        symmetric),
           j_hvp_impl(jf, jnp.asarray(a), jnp.asarray(v), csize, symmetric))
