"""hDual / hmath port vs the JAX reference: every op of ``hmath.__all__`` and
every HDual operator, at the same seeded point, component by component
(val, di, dj, dij; tolerances of tests/test_hdual.py), and each op's
chunked Hessian against ``torch.func.hessian`` (tolerance of
tests/test_hmath_second_derivs.py)."""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.hmath as jhm  # noqa: E402
from repro.core.api import eval_chunk as j_eval_chunk  # noqa: E402
from repro_torch.core import hmath as thm  # noqa: E402
from repro_torch.core.api import chunk_pairs, eval_chunk  # noqa: E402
from repro_torch.core.hdual import HDual, lift, seed_point  # noqa: E402

N = 4
W = np.asarray([0.3, -0.2, 0.5, 0.4], np.float32)
M = np.asarray([[0.5, -0.3, 0.2, 0.1], [0.2, 0.4, -0.6, 0.3],
                [-0.1, 0.2, 0.3, 0.7]], np.float32)

# name -> (f(hm, x, C), point range); C turns a numpy constant into the
# framework's array, so one definition runs on both packages.
CASES = {
    "sin": (lambda hm, x, C: hm.sin(x[0] * x[1]) + hm.sin(x).sum(0), 1.5),
    "cos": (lambda hm, x, C: hm.cos(x * 0.7).sum(0) * x[2], 1.5),
    "tan": (lambda hm, x, C: hm.tan(x * 0.3).sum(0) + hm.tan(x[0] * x[1] * 0.2),
            1.5),
    "exp": (lambda hm, x, C: hm.exp(x * 0.3).sum(0) * x[1], 1.5),
    "log": (lambda hm, x, C: hm.log(x * x + 2.0).sum(0)
            + hm.log(x[0] * x[1] + 5.0), 1.5),
    "sqrt": (lambda hm, x, C: hm.sqrt(x * x + 1.0).sum(0) * x[3], 1.5),
    "tanh": (lambda hm, x, C: hm.tanh(x[0] * x[1]) + hm.tanh(x).sum(0), 1.5),
    "sigmoid": (lambda hm, x, C: hm.sigmoid(x * 0.5).sum(0)
                * hm.sigmoid(x[1]), 1.5),
    "abs": (lambda hm, x, C: hm.abs(x - 3.0).sum(0) * x[1]
            + hm.abs(x[0] * x[2] + 4.0), 1.5),
    "where": (lambda hm, x, C: hm.where(x > 0.0, x * x, hm.sin(x)).sum(0)
              + hm.where(x[0] > 5.0, 1.0, x[0] * x[1]), 1.5),
    "maximum": (lambda hm, x, C: hm.maximum(x * x, x + 0.5).sum(0)
                + hm.maximum(x[0] * x[1], 0.1), 1.5),
    "minimum": (lambda hm, x, C: hm.minimum(hm.exp(x), x * x + 1.0).sum(0),
                1.5),
    "sum": (lambda hm, x, C: hm.sum(x * x * x) + hm.sum(x[0] * x, 0), 1.5),
    "dot_const": (lambda hm, x, C: hm.dot_const(x * x, C(W)) * x[0], 1.5),
    "matvec_const": (lambda hm, x, C: hm.sum(
        hm.square(hm.matvec_const(C(M), hm.sin(x)))), 1.5),
    "square": (lambda hm, x, C: hm.square(x[0] * x[1] + x[2])
               + hm.square(x).sum(0), 1.5),
    "pow": (lambda hm, x, C: hm.pow(x * x + 1.0, 2.5).sum(0)
            + hm.pow(x[1], 3), 1.5),
    "asin": (lambda hm, x, C: hm.asin(x[0] * 0.4)
             + hm.asin(x * 0.3).sum(0) * x[1], 1.2),
    "acos": (lambda hm, x, C: hm.acos(x * 0.4).sum(0) * x[2], 1.2),
    "atan": (lambda hm, x, C: hm.atan(x).sum(0) * hm.atan(x[0] * x[1]), 1.5),
    "sinh": (lambda hm, x, C: hm.sinh(x * 0.7).sum(0) * x[0], 1.5),
    "cosh": (lambda hm, x, C: hm.cosh(x[0] * x[1]) + hm.cosh(x).sum(0), 1.5),
    "erf": (lambda hm, x, C: hm.erf(x[0]) + hm.erf(x * 0.5).sum(0) * x[3],
            1.5),
    "log1p": (lambda hm, x, C: hm.log1p(x * x).sum(0) + x[0] * x[1], 1.5),
    "expm1": (lambda hm, x, C: hm.expm1(x * 0.3).sum(0) * x[2], 1.5),
    # HDual operators
    "add_sub": (lambda hm, x, C: (x[0] + x[1]) * (x[2] - x[3])
                + (2.0 - x[0]) * (x[1] + 3.0) + (x - 1.0).sum(0) * x[2], 1.5),
    "mul": (lambda hm, x, C: x[0] * x[1] * x[2] + (x * x).sum(0) * x[3]
            + (2.0 * x).sum(0) * x[1], 1.5),
    "div": (lambda hm, x, C: x[0] / (x[1] + 10.0) + (1.0 / (x * x + 3.0)).sum(0)
            + x[2] / 4.0, 1.5),
    "neg": (lambda hm, x, C: -(x[0] * x[1]) + (-x).sum(0) * x[2], 1.5),
    "pow_int": (lambda hm, x, C: (x ** 4).sum(0) + x[1] ** 3
                + x[0] * x[2] ** 1, 1.5),
    "const_array": (lambda hm, x, C: (x * C(W)).sum(0) * x[0]
                    + (C(W) - x * x).sum(0) * x[1] + (C(W) * x).sum(0)
                    + (C(W) + x).sum(0) * x[3], 1.5),
}

# (row i, chunk start, csize); the last has lanes past n (ragged tail)
CELLS = [(0, 0, 1), (2, 0, 4), (3, 2, 3)]


def _point(name):
    f, r = CASES[name]
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    return rng.uniform(-r, r, size=(N,)).astype(np.float32)


def _torch_f(name):
    f = CASES[name][0]
    return lambda x: f(thm, x, torch.from_numpy)


def _jax_f(name):
    f = CASES[name][0]
    return lambda x: f(jhm, x, jnp.asarray)


@pytest.mark.parametrize("i,cstart,csize", CELLS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_ops_match_jax(name, i, cstart, csize):
    a = _point(name)
    got = eval_chunk(_torch_f(name), torch.from_numpy(a), i, cstart, csize)
    want = j_eval_chunk(_jax_f(name), jnp.asarray(a), i, cstart, csize)
    for what in ("val", "di", "dj", "dij"):
        np.testing.assert_allclose(
            getattr(got, what).numpy(), np.asarray(getattr(want, what)),
            rtol=2e-4, atol=2e-4, err_msg=f"{name}/{what}")


def _cell_hessian(f, a, csize):
    """Dense Hessian from one single-cell pass per (row, chunk) pair."""
    n = a.shape[0]
    H = torch.zeros(n, n, dtype=a.dtype)
    for i, cstart in chunk_pairs(n, csize, symmetric=False):
        dij = eval_chunk(f, a, int(i), int(cstart), csize).dij
        width = min(csize, n - int(cstart))
        H[i, cstart:cstart + width] = dij[:width]
    return H


@pytest.mark.parametrize("csize", [1, 3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_ops_match_torch_func_hessian(name, csize):
    a = torch.from_numpy(_point(name))
    H = _cell_hessian(_torch_f(name), a, csize)
    H_ref = torch.func.hessian(_torch_f(name))(a)
    np.testing.assert_allclose(
        H.numpy(), H_ref.numpy(), rtol=2e-3,
        atol=2e-3 * (1.0 + float(H_ref.abs().max())), err_msg=name)


def test_every_hmath_export_is_covered():
    import repro.core.hmath as ref_hm
    assert sorted(thm.__all__) == sorted(ref_hm.__all__)
    assert set(thm.__all__) <= set(CASES)


def test_seed_point_matches_jax():
    from repro.core.hdual import seed_point as j_seed_point
    a = np.arange(5, dtype=np.float32) - 2.0
    got = seed_point(torch.from_numpy(a), 3, 2, 4)
    want = j_seed_point(jnp.asarray(a), 3, 2, 4)
    for what in ("val", "di", "dj", "dij"):
        np.testing.assert_array_equal(getattr(got, what).numpy(),
                                      np.asarray(getattr(want, what)))


def test_seed_point_batched_cells():
    """Cells as a trailing batch axis: element b of a batched seed equals
    the single-cell seed of (i[b], cstart[b])."""
    a = torch.arange(6, dtype=torch.float32)
    rows = torch.tensor([0, 2, 5])
    starts = torch.tensor([0, 2, 4])
    y = seed_point(a, rows, starts, 2)
    assert y.shape == (6, 3)
    for b in range(3):
        one = seed_point(a, int(rows[b]), int(starts[b]), 2)
        for what in ("val", "di", "dj", "dij"):
            torch.testing.assert_close(getattr(y, what)[:, b],
                                       getattr(one, what))


def test_integer_power_bitwise_stable():
    y = seed_point(torch.tensor([1.5, -0.5]), 0, 0, 2)
    assert torch.equal((y ** 2).val, (y * y).val)
    assert torch.equal((y ** 3).dij, (y * y * y).dij)
    z = y ** 0
    assert torch.equal(z.val, torch.ones(2)) and not z.dij.any()


def test_comparisons_reshape_and_lift():
    y = seed_point(torch.tensor([2.0, -3.0, 1.0, 0.5, 4.0, 1.5]), 1, 0, 2)
    assert bool(y[0] > y[1]) and bool(y[1] <= 0.0)
    z = y.reshape(2, 3).sum(axis=(0, 1))
    torch.testing.assert_close(z.val, y.val.sum())
    torch.testing.assert_close(z.dj, y.dj.sum(0))
    c = lift(np.ones(3, np.float32), 4)
    assert isinstance(c, HDual) and c.csize == 4 and not c.dij.any()
    assert (y + np.float32(1.0)).val[0] == 3.0
