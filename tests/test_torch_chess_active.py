"""chess_hvp's device forms, redone in plain PyTorch: a cell carries hDuals
only for its active coordinates S = {i} u {its columns below n}, the other
coordinates enter as primal sums hoisted per instance, and every derivative
lane comes from the port's HDual/hmath operators on seeded hDuals.

The rendering below follows csrc/chess_hvp.cu form by form (slots, hoisted
tables, sub-cells of 64 lanes, the chunk-granular mirror) and is held to the
port's dense plain version (``chess_hvp_plain``) and to the JAX oracle
(``repro.kernels.ref.chess_hvp_ref`` with the kernel form) at the
reference's kernel tolerance, rtol 5e-3, atol 5e-3 * (1 + max|want|).  The
bound the kernel is held to (``needed_cell_operations``, ``needed_work``) is
checked at fixed values."""

import math
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ops import _fn_and_consts  # noqa: E402
from repro.kernels.ref import chess_hvp_ref as _j_chess_hvp_ref  # noqa: E402
from repro_torch.core import hmath  # noqa: E402
from repro_torch.core import testfns  # noqa: E402
from repro_torch.core.api import chunk_pairs  # noqa: E402
from repro_torch.core.hdual import HDual  # noqa: E402
from repro_torch.kernels import chess_hvp as ck  # noqa: E402
from repro_torch.kernels.ops import kernel_form  # noqa: E402

FNS = ("rosenbrock", "ackley", "fletcher_powell")
j_chess_hvp_ref = jax.jit(_j_chess_hvp_ref, static_argnums=(0, 3))
# (m, n, csize): i inside and outside the chunk everywhere; ragged tails
# (10 % 4, 9 % 2, 7 % 3, csize > n); sub-cells past 64 lanes (70 = 64 + 6,
# a ragged second sub-cell)
SHAPES = [(3, 8, 2), (3, 10, 4), (2, 9, 2), (3, 7, 3), (2, 6, 16),
          (2, 70, 66)]


def _data(tag, m, n):
    rng = np.random.RandomState(zlib.crc32(tag.encode()))
    return (rng.uniform(-2, 2, (m, n)).astype(np.float32),
            rng.randn(m, n).astype(np.float32))


def _tol(want):
    return dict(rtol=5e-3, atol=5e-3 * (1 + np.abs(want).max()))


def _active(n, i, sub, width):
    """The slots of S as the kernel orders them (``active``): the carried
    columns sub.. below n, then i when it is not one of them."""
    cols = [k for k in range(sub, sub + width) if k < n]
    return cols + ([] if i in cols else [i])


def _seed(a, k, i, sub, width):
    """Coordinate k of the cell's seeding, value shape (m,), width lanes."""
    m = a.shape[0]
    dj = torch.zeros(m, width)
    if sub <= k < sub + width:
        dj[:, k - sub] = 1.0
    return HDual(a[:, k], torch.full((m,), float(k == i)), dj,
                 torch.zeros(m, width))


def _tangent(u):
    return HDual(torch.zeros_like(u.val), u.di, u.dj, u.dij)


def _rosenbrock(a, i, sub, width, consts):
    n = a.shape[1]
    c0, c1 = sub, min(sub + width, n)
    ks = set(range(max(c0 - 1, 0), min(c1 - 1, n - 2) + 1))
    ks |= {k for k in (i - 1, i) if 0 <= k <= n - 2}
    acc = HDual.constant(torch.zeros(a.shape[0]), width)
    for k in sorted(ks):
        yk, yk1 = _seed(a, k, i, sub, width), _seed(a, k + 1, i, sub, width)
        t1 = yk1 - yk * yk
        t2 = 1.0 - yk
        acc = acc + t1 * t1 * 100.0 + t2 * t2
    return acc


def _ackley(a, i, sub, width, consts):
    n = a.shape[1]
    cz = torch.cos(a * (2.0 * math.pi))
    s1_all, s2_all = (a * a).sum(1), cz.sum(1)    # hoisted per instance
    q1 = q2 = HDual.constant(torch.zeros(a.shape[0]), width)
    p1 = p2 = 0.0
    for k in _active(n, i, sub, width):
        yk = _seed(a, k, i, sub, width)
        q1 = q1 + yk * yk
        q2 = q2 + hmath.cos(yk * (2.0 * math.pi))
        p1, p2 = p1 + a[:, k] * a[:, k], p2 + cz[:, k]
    s1 = (q1 + (s1_all - p1)) * (1.0 / n)
    s2 = (q2 + (s2_all - p2)) * (1.0 / n)
    return ((hmath.exp(hmath.sqrt(s1) * -0.2) * -20.0) - hmath.exp(s2)
            + (20.0 + math.e))


def _fletcher_powell(a, i, sub, width, consts):
    A, B, E = consts
    n = a.shape[1]
    p = torch.sin(a) @ A.T + torch.cos(a) @ B.T - E     # (m, n), per instance
    # res_r for every row at once: value shape (n, m)
    res = HDual.constant(p.T.contiguous(), width)
    for k in _active(n, i, sub, width):
        yk = _seed(a, k, i, sub, width)
        ts, tc = _tangent(hmath.sin(yk)), _tangent(hmath.cos(yk))
        res = res + ts * A[:, k:k + 1] + tc * B[:, k:k + 1]
    return (res * res).sum(0)


FORMS = {"rosenbrock": _rosenbrock, "ackley": _ackley,
         "fletcher_powell": _fletcher_powell}


def active_hvp(function, A, V, csize, consts, symmetric):
    """The batched HVP over the kernel's sub-cells, each evaluated by the
    active-coordinate form, scattered as the kernel scatters."""
    m, n = A.shape
    out = torch.zeros(m, n)
    rows, starts = ck.sub_cells(n, csize, symmetric)
    for i, sub in zip(rows.tolist(), starts.tolist()):
        cstart = (sub // csize) * csize
        width = min(ck.LANES[-1], cstart + csize - sub)
        r = FORMS[function](A, i, sub, width, consts)
        cols = [sub + l for l in range(width) if sub + l < n]
        dij = r.dij[:, :len(cols)]
        out[:, i] += (dij * V[:, cols]).sum(1)
        if symmetric and cstart > (i // csize) * csize:
            out[:, cols] += dij * V[:, i:i + 1]
    return out


@pytest.mark.parametrize("m,n,csize", SHAPES)
@pytest.mark.parametrize("function", FNS)
def test_active_forms_match_plain_and_jax(function, m, n, csize):
    A, V = _data(f"active{function}{n}{csize}", m, n)
    kf, consts, _ = kernel_form(testfns.FUNCTIONS[function](n))
    jkf, jconsts = _fn_and_consts(function, n)
    jax_want = np.asarray(j_chess_hvp_ref(jkf, jnp.asarray(A), jnp.asarray(V),
                                          csize, jconsts))
    At, Vt = torch.from_numpy(A), torch.from_numpy(V)
    for symmetric in (False, True):
        got = active_hvp(function, At, Vt, csize, consts, symmetric).numpy()
        plain = ck.chess_hvp_plain(kf, At, Vt, csize, consts,
                                   symmetric).numpy()
        np.testing.assert_allclose(got, plain, **_tol(plain),
                                   err_msg=f"symmetric={symmetric} vs plain")
        np.testing.assert_allclose(got, jax_want, **_tol(jax_want),
                                   err_msg=f"symmetric={symmetric} vs jax")


@pytest.mark.parametrize("function", FNS)
def test_active_set_is_the_counted_one(function):
    """The coordinates the rendering carries are the S of the count: the
    count's s (or, for Rosenbrock, its terms) follows from them."""
    n, csize = 10, 4
    for i, c in chunk_pairs(n, csize, True).tolist():
        S = _active(n, i, c, csize)
        assert len(set(S)) == len(S) and i in S
        C = csize
        base = ck.needed_cell_operations(function, n, C, i, c) - 3 * C
        if function == "fletcher_powell":
            s = len(S)
            assert base == s * 2 * (4 * C + 2) + n * (
                s * 2 * (4 * C + 4) + 12 * C + 6)
        elif function == "ackley":
            assert base == len(S) * (20 * C + 12) + 24 * C + 20
        else:
            terms = {k for k in range(n - 1) if k in S or k + 1 in S}
            assert base == len(terms) * (38 * C + 21)


def test_needed_cell_operations_fixed_values():
    # Fletcher-Powell at n = 64, C = 4: i outside the chunk (s = 5) and
    # inside it (s = 4)
    assert ck.needed_cell_operations("fletcher_powell", 64, 4, 0, 8) == 16448
    assert ck.needed_cell_operations("fletcher_powell", 64, 4, 9, 8) == 13852
    # the ragged tail counts only the columns below n
    assert (ck.needed_cell_operations("ackley", 10, 4, 0, 8)
            == 3 * (20 * 4 + 12) + 24 * 4 + 20 + 3 * 4)
    # Rosenbrock: i = 0 beside the chunk 1..4 touches terms 0..4
    assert (ck.needed_cell_operations("rosenbrock", 64, 4, 0, 1)
            == 5 * (38 * 4 + 21) + 12)


# the main path (m = 524,288, n = 64, csize 4 symmetric / 8 full) and the
# wide chunks, counted per 64-lane sub-cell: (function, m, n, csize,
# symmetric, needed ms, dense ms) at 67 TFLOP/s, to two decimals
BOUNDS = [
    ("fletcher_powell", 524288, 64, 4, True, 68.85, 725.02),
    ("fletcher_powell", 524288, 64, 8, False, 192.65, 1230.12),
    ("ackley", 524288, 64, 4, True, 2.46, 25.61),
    ("ackley", 524288, 64, 8, False, 7.06, 45.05),
    ("rosenbrock", 524288, 64, 4, True, 4.90, 46.45),
    ("rosenbrock", 524288, 64, 8, False, 13.70, 82.13),
    ("fletcher_powell", 65536, 100, 96, True, 443.10, 1528.52),
    ("rosenbrock", 65536, 128, 128, False, 39.96, 77.72),
]


@pytest.mark.parametrize("function,m,n,csize,symmetric,needed,dense", BOUNDS)
def test_needed_work_bounds(function, m, n, csize, symmetric, needed, dense):
    ops, nbytes = ck.needed_work(function, m, n, csize, symmetric)
    dense_ops, dense_bytes = ck.work(function, m, n, csize, symmetric)
    assert round(ops / 67e12 * 1e3, 2) == needed
    assert round(dense_ops / 67e12 * 1e3, 2) == dense
    assert nbytes == dense_bytes and ops <= dense_ops


@pytest.mark.parametrize("function", FNS)
@pytest.mark.parametrize("n,csize,symmetric", [(100, 96, True),
                                               (128, 128, False),
                                               (70, 65, True)])
def test_needed_work_counts_wide_chunks_per_sub_cell(function, n, csize,
                                                     symmetric):
    """A chunk wider than 64 lanes is counted as the kernel runs it: one
    count per sub-cell (``sub_cells``), at the width of its own columns,
    which is less than the same chunk counted whole."""
    rows, starts = ck.sub_cells(n, csize, symmetric)
    per_instance = {"fletcher_powell": 4 * n * n + n, "ackley": 4 * n,
                    "rosenbrock": 0}[function]
    want = per_instance + sum(
        ck.needed_cell_operations(function, n, min(64, csize - s % csize),
                                  i, s)
        for i, s in zip(rows.tolist(), starts.tolist()))
    whole = per_instance + sum(
        ck.needed_cell_operations(function, n, csize, i, c)
        for i, c in chunk_pairs(n, csize, symmetric).tolist())
    ops = ck.needed_work(function, 3, n, csize, symmetric)[0]
    assert ops == 3 * want and want < whole
