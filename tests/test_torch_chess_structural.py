"""chess_hvp's generated forms as the structural evaluation of the traced
graph (``kernels/codegen.py``: an instance pass into the shared slot, then
each cell over its seeds' support only).  On the CPU:

(a) every live node's support (``Lowering.support_mask``) contains the mask
    of where the seeds' structural zeros let it be nonzero
    (``codegen.structural_masks``, what ``needed_operations`` counts), at
    every cell of csize 1, 3 and 4 on both schedules at n = 5 and 10, and
    of a 65-column chunk (64-lane sub-cells) at n = 66;
(b) the generated source, compiled as host C++ with g++ (the instance pass
    then every cell), matches the plain version at rtol 1e-5, atol 1e-5 *
    (1 + max|want|) on those cases, and on the three test functions the
    reference's Pallas kernel in interpret mode at that tolerance;
(c) the form's own count of a launch (``work``: what its code runs)
    equals ``needed_work`` on a sum of squares, where the supports are
    exact;
(d) a structural zero is exactly 0: sum(sqrt(x)) at a point with one
    coordinate 0, where the dense evaluation (the plain version, the
    Pallas body) computes 0 * inf = NaN in every row, leaves every other
    row finite and equal to the exact Hessian product (ROADMAP §C's
    by-design difference).

The functions: quickstart's my_function, the three test functions wrapped
so that they have no hand-written form, the all-ops function of
tests/test_torch_chess_traced.py, and a slice-heavy one (shifts of +-1 and
+-2, a step-2 slice, a sum over a window of a product).
"""

import ctypes
import shutil
import subprocess
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.chess_hvp import chess_hvp_pallas  # noqa: E402
from repro.kernels.ops import _fn_and_consts  # noqa: E402
from repro_torch.core import hmath as hm  # noqa: E402
from repro_torch.core import testfns  # noqa: E402
from repro_torch.kernels import build, codegen, trace  # noqa: E402
from repro_torch.kernels import chess_hvp as ck  # noqa: E402
from repro_torch.kernels.ops import kernel_form  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from tests.test_torch_chess_traced import (  # noqa: E402
    _fake_cuda, make_all_ops, my_function)

RTOL = 1e-5                      # atol = RTOL * (1 + max|want|)
NAMES = ("my_function", "rosenbrock", "ackley", "fletcher_powell", "all_ops",
         "slices")
SIZES = (5, 10)
CSIZES = (1, 3, 4)


def slices(x):
    """Shifted and strided slices: supports shift by the slice's start."""
    n = x.val.shape[0]
    d = x[1:] - x[:-1]
    e = x[2:] * hm.sin(x[:-2])
    h = 2 * (n // 2)
    return ((d * d).sum(0) + (e * x[1:-1]).sum(0)
            + (x[0:h:2] * x[1:h:2]).sum(0) + hm.exp(x[n // 2] * 0.5))


def roots(x):
    return hm.sqrt(x).sum(0)


def _function(name, n):
    if name == "my_function":
        return my_function
    if name == "all_ops":
        return make_all_ops(n)
    if name == "slices":
        return slices
    if name == "roots":
        return roots
    g = testfns.FUNCTIONS[name](n)
    return lambda x: g(x)          # noqa: E731  (no hand-written form)


_FORMS: dict = {}


def _form(name, n):
    """(kf, consts, form) of a function at n, traced once a module."""
    if (name, n) not in _FORMS:
        kf, consts, _ = kernel_form(_function(name, n))
        _FORMS[name, n] = (kf, consts, trace.lower(kf, consts, n))
    return _FORMS[name, n]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(tag, m, n):
    rng = np.random.RandomState(zlib.crc32(tag.encode()))
    return (rng.uniform(-2, 2, (m, n)).astype(np.float32),
            rng.randn(m, n).astype(np.float32))


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * (1 + np.abs(want).max()),
                               err_msg=what)


# (a) -------------------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_support_contains_the_structural_masks(name, n):
    _, _, form = _form(name, n)
    low = form.lowering
    cases = [(c, s) for c in CSIZES for s in (False, True)]
    if n == SIZES[0] and name in ("rosenbrock", "slices"):
        cases.append((65, False))      # at n = 66, below
    for csize, symmetric in cases:
        f = form
        if csize > 64:
            f = _form(name, 66)[2]
            low = f.lowering
        rows, starts, widths = f._cells(f.n, csize, symmetric)
        C = ck.lanes_for(csize)
        for node, mask, _, _ in codegen.structural_masks(
                f.graph, rows, starts, widths, C):
            sup = low.support_mask(node, rows, starts, widths, C)
            outside = mask & ~sup
            assert not outside.any(), (
                f"{name} n={f.n} csize={csize} symmetric={symmetric}: node "
                f"{node.id} ({node.kind} {node.op}{node.spec}) nonzero "
                f"outside its support {low.sup[node.id]} at "
                f"{np.argwhere(outside)[:3].tolist()}")


def test_supports_of_the_seeds_and_a_slice():
    """The rules on small cases: di at i, dj at the carried columns (on its
    lane's diagonal), a slice's shift, a product's meet, a sum's drop."""
    _, _, form = _form("rosenbrock", 10)
    low = form.lowering
    by_op = {nd.op: low.sup[nd.id] for nd in low.nodes if nd.kind == "in"}
    assert by_op["di"].dims == (codegen.Win(iw=(0, 0)),)
    assert by_op["dj"].diag == (0, 0)
    assert by_op["dij"].zero
    slices_ = [nd for nd in low.nodes if nd.kind == "view"
               and nd.spec[0] == "slice" and nd.args[0].op == "di"
               and nd.spec[2] == 1]
    assert low.sup[slices_[0].id].dims == (codegen.Win(iw=(-1, -1)),)
    out = low.sup[form.graph.out.id]
    assert out.dims == (codegen.LANE,) and not out.zero
    # the cell part never loops over all n for a sparse node: every loop
    # over the coordinate axis in eval is a slot loop over a window or a
    # lane loop (Rosenbrock's dense loops would read "< 9" or "< 10")
    src = form.source
    body = src[src.index("eval(const float* s"):src.index("#ifdef __CUDACC__")]
    assert "< 9;" not in body and "< 10;" not in body


# (b) -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """Every (function, n) of (a) and (d), compiled with g++, all at once."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH to compile the generated form as host "
                    "code")
    path = tmp_path_factory.mktemp("structural")
    keys = [(name, n) for name in NAMES for n in SIZES] + [
        ("rosenbrock", 66), ("slices", 66), ("roots", 6)]
    procs = {}
    for name, n in keys:
        src = path / f"{name}{n}.cpp"
        src.write_text(_form(name, n)[2].source)
        procs[name, n] = subprocess.Popen(
            ["g++", "-O0", "-std=c++17", "-shared", "-fPIC", "-I",
             str(build.CSRC), "-o", str(path / f"lib{name}{n}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, proc in procs.items():
        out, _ = proc.communicate(timeout=180)
        assert proc.returncode == 0, out
        libs[key] = ctypes.CDLL(str(path / f"lib{key[0]}{key[1]}.so"))
    return libs


def _host_run(lib, form, consts, A, V, csize, symmetric):
    m, n = A.shape
    rows, starts = (np.ascontiguousarray(a, np.int32)
                    for a in ck.sub_cells(n, csize, symmetric))
    out = torch.zeros(m, n)
    k = form.constants(consts, "cpu")
    p = ctypes.c_void_p
    rc = lib.chess_hvp_traced_host(
        p(A.data_ptr()), p(V.data_ptr()), p(out.data_ptr()),
        rows.ctypes.data_as(p), starts.ctypes.data_as(p), len(rows), m, n,
        csize, ck.lanes_for(csize), int(symmetric), p(k.data_ptr()))
    assert rc == 0
    return out


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_structural_form_on_the_host(name, n, host_libs):
    kf, consts, form = _form(name, n)
    A, V = (torch.from_numpy(a) for a in _data(f"s{name}{n}", 3, n))
    for csize in CSIZES:
        for symmetric in (False, True):
            got = _host_run(host_libs[name, n], form, consts, A, V, csize,
                            symmetric)
            want = ck.chess_hvp_plain(kf, A, V, csize, consts, symmetric)
            _close(got.numpy(), want.numpy(),
                   f"{name} n={n} csize={csize} symmetric={symmetric}")
            if name in testfns.FUNCTIONS and csize == 3 and n == 10:
                jkf, jconsts = _fn_and_consts(name, n)
                ref = np.asarray(chess_hvp_pallas(
                    jkf, jnp.asarray(A.numpy()), jnp.asarray(V.numpy()),
                    csize, consts=jconsts, blk_m=8, symmetric=symmetric,
                    interpret=True), np.float32)
                _close(got.numpy(), ref, f"{name} vs the Pallas kernel "
                       f"symmetric={symmetric}")


@pytest.mark.parametrize("name", ["rosenbrock", "slices"])
def test_structural_form_on_64_lane_sub_cells(name, host_libs):
    kf, consts, form = _form(name, 66)
    A, V = (torch.from_numpy(a) for a in _data(f"w{name}", 2, 66))
    for symmetric in (False, True):
        got = _host_run(host_libs[name, 66], form, consts, A, V, 65,
                        symmetric)
        want = ck.chess_hvp_plain(kf, A, V, 65, consts, symmetric)
        _close(got.numpy(), want.numpy(), f"{name} symmetric={symmetric}")


# (c) -------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 5, 7])
def test_own_count_is_the_bound_on_a_sum_of_squares(n):
    """(x x).sum(0): a cell's dij is nonzero only at the lane of column i,
    and the form computes only there (5 operations), plus its scatter."""
    form = trace.traced_form(lambda x: (x * x).sum(0), (), n)
    for csize in (1, 2, 3):
        for symmetric in (False, True):
            assert (ck.work(form, 2, n, csize, symmetric)[0]
                    == ck.needed_work(form, 2, n, csize, symmetric)[0])
    assert form.rows == 3 and form.scalars == 0    # nothing stored


def test_instance_values_are_stored_once():
    """Fletcher-Powell's residuals p_r and its sin and cos rows come from
    the instance pass (its n^2 work, once an instance); no cell recomputes
    them: a cell's count grows with n, not n^2."""
    counts = {}
    for n in (10, 20):
        _, _, form = _form("fletcher_powell", n)
        assert form.rows >= 3 + 3 and "CHESS_SYNC();" in form.source
        assert codegen.instance_operations(form.graph) >= 4 * n * n
        counts[n] = form.cell_counts(n, 4, False).max()
    assert counts[20] < 2.2 * counts[10]


@pytest.mark.parametrize("draw", ["bernoulli", "normal", "poisson"])
def test_random_draws_fold_apart(draw):
    """Two const-only computations with one op and one operand fold into
    one slice, but two random draws from one operand are two values: each
    folds into its own constants (as two draws from two operands do)."""
    n = 5
    ops_ = {"bernoulli": lambda p: p.bernoulli(),
            "normal": lambda p: torch.normal(p, 1.0),
            "poisson": torch.poisson,
            "sin": lambda p: p.sin()}

    def make(first, second):
        def f(x):
            p = torch.full((n,), 0.5)
            return ((x * x * ops_[first](p)).sum(0)
                    + (x * x * ops_[second](p)).sum(0))
        return f

    def consts(f):
        return sum(nd.kind == "const"
                   for nd in trace.traced_form(f, (), n).graph.nodes)
    twice = consts(make(draw, draw))
    assert twice > 0 and twice == consts(make(draw, "sin")) + consts(
        make("sin", draw))


def test_shared_memory_veto():
    """A form's slot grows with the rows its instance pass stores: the
    all-ops function's 33 rows pass a CTA's shared memory at n = 1800,
    where a 3-row form fits.  The ``cuda`` backend vetoes the plan
    (``vmap_l2``, with the reason) before any launch, and ``max_n`` is 0."""
    n = 1800
    f = make_all_ops(n)
    form = trace.traced_form(f, (), n)
    assert form.rows > 30
    assert (ck.shared_bytes("rosenbrock", n, 1, 4) <= ck.SMEM_MAX
            < ck.shared_bytes(form, n, 1, 4))
    assert not ck.supports(form, n, 4) and ck.max_n(form, 4) == 0
    p = _fake_cuda(f, n)
    assert p.backend_for("batched_hvp") == "vmap_l2"
    assert "shared memory" in ops._cuda_supports(p, "batched_hvp")


def test_instances_per_block_leave_two_ctas_an_sm():
    """A generated form with a large slot (the all-ops function's 33 rows at
    n = 64) takes the instances of which two CTAs fit an SM: ``_fit``'s
    budget, so the wrapper's pick and the tuner's list (``instance_blocks``,
    whose top is ``_fit``'s) stop at the same cap; the hand-written forms'
    choice is the whole budget's."""
    n = 64
    form = trace.traced_form(make_all_ops(n), (), n)
    for csize, symmetric in ((4, True), (8, False)):
        lanes = ck.lanes_for(csize)
        P = len(ck.sub_cells(n, csize, symmetric)[0])
        q = ck._instances_per_block(P, n, form, lanes)
        cap = ck._fit(n, form, lanes)[-1]
        assert q <= cap == ck.instance_blocks(form, n, csize)[-1]
        assert (ck.shared_bytes(form, n, cap, lanes)
                <= ck.SMEM_SM // 2 - 1024
                < ck.shared_bytes(form, n, cap + 1, lanes))
    # phase 4's Fletcher-Powell case (n = 100, csize 96) keeps its 3
    # instances a CTA, past half an SM
    q = ck._instances_per_block(292, 100, "fletcher_powell", 64)
    assert q == 3 and (ck.shared_bytes("fletcher_powell", 100, q, 64)
                       > ck.SMEM_SM // 2 - 1024)


# (d) -------------------------------------------------------------------------

def test_structural_zero_is_exact(host_libs):
    """sqrt at 0 has g' = inf and g'' = -inf: the dense evaluation carries
    0 * inf = NaN through every cell's sum; the structural form computes
    g'' only where di and dj meet, so only row k0 (H[k0, k0] = -inf) is
    not finite, and every other row is -v_i / (4 x_i^1.5)."""
    n, k0 = 6, 2
    kf, consts, form = _form("roots", n)
    x = np.array([[0.5, 1.0, 0.0, 2.0, 1.5, 0.7]], np.float32)
    v = np.array([[1.0, -2.0, 0.5, 3.0, -1.0, 0.25]], np.float32)
    A, V = torch.from_numpy(x), torch.from_numpy(v)
    others = [j for j in range(n) if j != k0]
    exact = -v[0, others] / (4 * x[0, others].astype(np.float64) ** 1.5)
    for csize in (1, 3, 4):
        for symmetric in (False, True):
            plain = ck.chess_hvp_plain(kf, A, V, csize, consts, symmetric)
            assert torch.isnan(plain).all()
            got = _host_run(host_libs["roots", n], form, consts, A, V, csize,
                            symmetric).numpy()[0]
            assert not np.isfinite(got[k0])
            _close(got[others], exact, f"csize={csize} {symmetric}")
