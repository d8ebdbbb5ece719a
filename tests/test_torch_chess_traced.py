"""chess_hvp on any hmath-written f: the generated device form.

The reference's ``chess_hvp_pallas`` traces f into its body, so it takes any
function written against ``repro.core.hmath``; the port's ``cuda`` backend
does the same through ``kernels/trace.py`` (one traced cell of f) and
``kernels/codegen.py`` (that cell as a CUDA C++ device form).  On the CPU:

* the trace is faithful: the traced aten graph, run on other inputs than
  it was traced at, equals ``kf``'s four hDual components (1e-6);
* the plain version on quickstart's ``my_function`` and on an all-ops
  function matches the reference's kernel (interpret mode) at the
  tolerance of tests/test_torch_kernels_pallas.py (rtol 1e-5, atol
  1e-5 * (1 + max|want|));
* the generated source, compiled as host C++ with g++ and run over every
  cell, matches the plain version (rtol 1e-5, atol 1e-5 * (1 + max|want|):
  the same float32 arithmetic in another summation order);
* backend resolution on fake CUDA plans, and the wrapper off the card.

The all-ops function uses every hmath map, where, maximum, minimum, pow,
/, slices, matvec_const and dot_const, with closure constants on the torch
side; the reference's Pallas body refuses closure constants and its
``dot_const`` takes an (n,) vector only, so its twin takes W and w as kernel
constants and writes the dot as the broadcast product it is.
"""

import ctypes
import os
import shutil
import subprocess
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import hmath as jhm  # noqa: E402
from repro.kernels.chess_hvp import chess_hvp_pallas  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core import hmath as hm  # noqa: E402
from repro_torch.core import testfns  # noqa: E402
from repro_torch.core.hdual import HDual  # noqa: E402
from repro_torch.engine import registry  # noqa: E402
from repro_torch.kernels import build, codegen, ops, trace  # noqa: E402
from repro_torch.kernels import chess_hvp as ck  # noqa: E402
from repro_torch.kernels.ops import kernel_form  # noqa: E402

RTOL = 1e-5                      # atol = RTOL * (1 + max|want|)


def my_function(x):
    """examples_torch/quickstart.py's (and examples/quickstart.py's)."""
    return hm.sin(x[0] * x[1]) + hm.exp(x[2] * 0.5) + (x * x).sum(0)


def my_function_jax(x):
    return jhm.sin(x[0] * x[1]) + jhm.exp(x[2] * 0.5) + (x * x).sum(0)


def _all_ops_consts(n, seed=7):
    rng = np.random.RandomState(seed + n)
    W = (rng.randn(n // 2 + 1, n) / np.sqrt(n)).astype(np.float32)
    return W, rng.randn(n).astype(np.float32)


def _all_ops_body(m, x, dot):
    u = x * 0.3
    y = (m.sin(u) * m.cos(u) + m.tan(u) + m.exp(u) + m.log(u * u + 1.0)
         + m.sqrt(u * u + 2.0) + m.tanh(u) + m.sigmoid(u) + m.abs(u)
         + m.asin(u * 0.5) + m.acos(u * 0.5) + m.atan(u) + m.sinh(u)
         + m.cosh(u) + m.erf(u) + m.log1p(u * u) + m.expm1(u)
         + m.square(u) + m.pow(u * u + 1.0, 1.5) + m.pow(u, 3))
    y = (y + m.where(m.sin(u) > 0.0, u * 2.0, u * u)
         + m.maximum(u, u * u) + m.minimum(u, 0.25)
         + 1.0 / (u * u + 1.0) + u / (u * u + 2.0))
    z = dot[0](y)
    return (z * z).sum(0) * 0.1 + dot[1](y) + (y[1:] * y[:-1]).sum(0)


def make_all_ops(n):
    """chip_smoke.py's make_all_ops: W and w captured by the closure."""
    W, w = (torch.from_numpy(a) for a in _all_ops_consts(n))

    def all_ops(x):
        return _all_ops_body(hm, x, (lambda y: hm.matvec_const(W, y),
                                     lambda y: hm.dot_const(y, w)))
    return all_ops


def all_ops_jax(x, W, w):
    wb = w.reshape(w.shape + (1,) * (x.val.ndim - 1))
    return _all_ops_body(jhm, x, (lambda y: jhm.matvec_const(W, y),
                                  lambda y: (y * wb).sum(0)))


def branchy(x):
    """A Python branch on a value: refused, as JAX's tracer refuses it."""
    if float(x.val[0]) > 0:
        return (x * x).sum(0)
    return x.sum(0)


def unlowered(x):
    """An aten op the code generator does not lower (cumsum)."""
    return HDual(x.val.cumsum(0), x.di.cumsum(0), x.dj.cumsum(0),
                 x.dij.cumsum(0)).sum(0)


def _function(name, n):
    if name == "my_function":
        return my_function
    if name == "all_ops":
        return make_all_ops(n)
    return testfns.FUNCTIONS[name](n)


@pytest.fixture(autouse=True)
def _one_thread():
    # small graphs: several test workers' thread pools share the cores
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


@pytest.mark.parametrize("name", ["rosenbrock", "ackley", "fletcher_powell",
                                  "my_function", "all_ops"])
def test_trace_is_faithful(name):
    n, lanes = 7, 3
    kf, consts, _ = kernel_form(_function(name, n))
    gm = trace.trace_cell(kf, consts, n, lanes)
    assert any(nd.op == "call_function" for nd in gm.graph.nodes)
    if name == "all_ops":      # W and w, captured by the closure
        assert sum(nd.op == "get_attr" for nd in gm.graph.nodes) >= 2
    # other inputs than the trace's: a point, seeds at another row and
    # columns, and a nonzero dij
    rng = np.random.RandomState(1)
    val = torch.from_numpy(rng.uniform(-2, 2, n).astype(np.float32))
    k = torch.arange(n)
    di = (k == 4).float()
    dj = (k[:, None] == torch.arange(2, 2 + lanes)[None, :]).float()
    dij = torch.from_numpy(rng.randn(n, lanes).astype(np.float32))
    got = gm(val, di, dj, dij, *consts)
    want = kf(HDual(val, di, dj, dij), *consts)
    for g, w, comp in zip(got, (want.val, want.di, want.dj, want.dij),
                          ("val", "di", "dj", "dij")):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=f"{name} {comp}")


def test_chip_smoke_all_ops_is_this_one():
    """chip_smoke.py runs its own copy of the all-ops function on the card
    (it imports no test file): it computes what this file's does."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_copy", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    n, lanes = 9, 4
    rng = np.random.RandomState(2)
    y = HDual(*(torch.from_numpy(rng.randn(*s).astype(np.float32))
                for s in ((n,), (n,), (n, lanes), (n, lanes))))
    got, want = smoke.make_all_ops(n)(y), make_all_ops(n)(y)
    for g, w in zip((got.val, got.di, got.dj, got.dij),
                    (want.val, want.di, want.dj, want.dij)):
        assert torch.equal(g, w)


# (name, m, n, csize, symmetric): csize 1, 3, 4 and 16, both schedules for
# each function; the all-ops function's 547-op body takes the reference's
# interpret mode ~2.5 s a call to trace and compile
REF_CASES = ([("my_function",) + c for c in [
    (5, 7, 3, True), (4, 6, 1, False), (3, 8, 4, True)]]
    + [("all_ops",) + c for c in [(5, 7, 3, True), (2, 6, 16, False)]])


@pytest.mark.parametrize("name,m,n,csize,symmetric", REF_CASES)
def test_plain_matches_pallas_kernel(name, m, n, csize, symmetric):
    A, V = _data(f"{name}{m}{n}{csize}", m, n)
    got = ck.chess_hvp_plain(_function(name, n), torch.from_numpy(A),
                             torch.from_numpy(V), csize, (), symmetric)
    if name == "my_function":
        jf, jconsts = my_function_jax, ()
    else:
        jf, jconsts = all_ops_jax, tuple(map(jnp.asarray,
                                             _all_ops_consts(n)))
    want = np.asarray(chess_hvp_pallas(
        jf, jnp.asarray(A), jnp.asarray(V), csize, consts=jconsts, blk_m=8,
        symmetric=symmetric, interpret=True), np.float32)
    _close(got.numpy(), want, f"{name} {(m, n, csize, symmetric)}")


def _host_run(lib, form, A, V, csize, symmetric, consts=()):
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


# (function, n, csizes): 65 at n = 66 runs 64-lane sub-cells
HOST_CASES = (("all_ops", 8, (1, 3, 4, 16)),
              ("my_function", 66, (1, 3, 4, 16, 65)))


def test_generated_form_on_the_host(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH to compile the generated form as host "
                    "code")
    builds = []
    for name, n, csizes in HOST_CASES:      # both compile together
        f = _function(name, n)
        form = trace.traced_form(f, (), n)
        src = tmp_path / f"{name}.cpp"
        src.write_text(form.source)
        lib = tmp_path / f"lib{name}.so"
        proc = subprocess.Popen(
            ["g++", "-O0", "-std=c++17", "-shared", "-fPIC", "-I",
             str(build.CSRC), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        builds.append((name, n, csizes, f, form, lib, proc))
    for name, n, csizes, f, form, lib, proc in builds:
        assert proc.wait(timeout=120) == 0, proc.stdout.read()
        lib = ctypes.CDLL(str(lib))
        A, V = (torch.from_numpy(a) for a in _data(f"host{name}{n}", 3, n))
        for csize in csizes:
            for symmetric in (False, True):
                got = _host_run(lib, form, A, V, csize, symmetric)
                want = ck.chess_hvp_plain(f, A, V, csize, (), symmetric)
                _close(got.numpy(), want.numpy(),
                       f"{name} n={n} csize={csize} symmetric={symmetric}")


def _consts_function(n):
    """kf(y, c) = dot(y y, c) + dot(sin y, W): c a kernel constant, W a
    tensor its closure captures; and a function that rebinds W."""
    W = torch.from_numpy(np.linspace(-1, 1, n).astype(np.float32))

    def kf(y, c):
        return hm.dot_const(y * y, c) + hm.dot_const(hm.sin(y), W)

    def rebind(t):
        nonlocal W
        W = t
    return kf, rebind


@pytest.fixture(scope="module")
def consts_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH to compile the generated form as host "
                    "code")
    n = 7
    kf, _ = _consts_function(n)
    form = trace.lower(kf, (torch.ones(n),), n)
    path = tmp_path_factory.mktemp("consts")
    (path / "f.cpp").write_text(form.source)
    subprocess.run(["g++", "-O0", "-std=c++17", "-shared", "-fPIC", "-I",
                    str(build.CSRC), "-o", str(path / "libf.so"),
                    str(path / "f.cpp")], check=True, timeout=120)
    return form.source, ctypes.CDLL(str(path / "libf.so"))


@pytest.mark.parametrize("change", ["kernel_const", "captured", "rebound"])
def test_constants_are_read_at_each_launch(change, consts_lib):
    """A constant changed between two launches -- a kernel constant or a
    captured tensor written in place, a closure variable rebound -- reaches
    the generated form's next launch, as the plain version reads it: the
    form takes them at each launch and is traced anew for a rebound
    closure.  c starts with all its elements equal, which no literal may
    stand for."""
    source, lib = consts_lib
    n, csize = 7, 3
    kf, rebind = _consts_function(n)
    c = torch.full((n,), 0.5)
    A, V = (torch.from_numpy(a) for a in _data(f"consts{change}", 4, n))

    def check(what):
        form = trace.traced_form(kf, (c,), n)
        assert form.source == source          # the values are not in it
        for symmetric in (False, True):
            got = _host_run(lib, form, A, V, csize, symmetric, (c,))
            want = ck.chess_hvp_plain(kf, A, V, csize, (c,), symmetric)
            _close(got.numpy(), want.numpy(), f"{change} {what}")
        return form

    first = check("before")
    if change == "kernel_const":
        c[0] = 3.0
    elif change == "captured":
        kf.__closure__[0].cell_contents.mul_(-2.0)
    else:
        rebind(torch.from_numpy(np.cos(np.arange(n)).astype(np.float32)))
    assert (check("after") is first) == (change != "rebound")


def _fake_cuda(f, n, csize=4, **kw):
    from dataclasses import replace
    p = engine.plan(f, n, csize=csize, device="cpu", **kw)
    return replace(p, device=torch.device("cuda", 0))


def test_traceable_functions_resolve_to_cuda():
    fp = testfns.make_fletcher_powell(12)
    cuda = engine.get_backend("cuda")
    for f in (my_function, make_all_ops(12), lambda x: testfns.rosenbrock(x),
              lambda x: fp(x), lambda x: x.sum(0)):
        p = _fake_cuda(f, 12)
        assert kernel_form(f)[2] is None
        assert cuda.can_run(p, "batched_hvp")
        assert p.backend_for("batched_hvp") == "cuda"
    # quickstart's function at the paper's n, auto and explicit
    p = _fake_cuda(my_function, 64)
    assert p.backend_for("batched_hvp") == "cuda"
    from dataclasses import replace
    assert registry.resolve_backend(replace(p, backend="cuda"),
                                    "batched_hvp") is cuda


@pytest.mark.parametrize("f,reason", [
    (branchy, "reads a traced value on the host"),
    (unlowered, "no lowering for aten.cumsum"),
    (lambda x: x, "not a scalar")])
def test_refused_functions_resolve_to_vmap_l2(f, reason):
    from dataclasses import replace
    p = _fake_cuda(f, 8)
    assert not engine.get_backend("cuda").can_run(p, "batched_hvp")
    assert p.backend_for("batched_hvp") == "vmap_l2"
    with pytest.raises(ValueError, match="cannot run") as err:
        registry.resolve_backend(replace(p, backend="cuda"), "batched_hvp")
    assert reason in str(err.value)
    with pytest.raises(trace.TraceRefused, match=reason):
        trace.traced_form(f, (), 8)


def wide_locals(x):
    """Four sums over two lane-dense windows of the cell (x[1:] - x[:-1]'s
    derivatives, and its sin and exp), each read by two loops: arrays of
    (C + 1) C floats."""
    d = x[1:] - x[:-1]
    e, g = hm.sin(d), hm.exp(d)
    return (e * e).sum(0) + (e * g).sum(0) + (g * d).sum(0) + (d * d).sum(0)


def test_local_memory_refusal():
    """A form whose cell arrays pass ``LOCAL_MAX`` at a lane width is
    refused there and built at the widths that fit: ``wide_locals`` at
    n = 10 fits up to 32 lanes and not at 64.  Fletcher-Powell's form at
    n = 64 (the dense form's refusal from 32 lanes) now fits at every
    width."""
    n = 10
    form = trace.traced_form(wide_locals, (), n)
    assert form.local_bytes(32) <= ck.LOCAL_MAX < form.local_bytes(64)
    assert ck.supports(form, n, 32) and not ck.supports(form, n, 64)
    assert not ck.supports(form, n - 1, 32)           # its own n only
    assert _fake_cuda(wide_locals, n, csize=32).backend_for(
        "batched_hvp") == "cuda"
    p = _fake_cuda(wide_locals, n, csize=64)
    assert p.backend_for("batched_hvp") == "vmap_l2"
    assert "local memory" in ops._cuda_supports(p, "batched_hvp")
    assert codegen.lanes_that_fit(form.graph) == (1, 2, 4, 8, 16, 32)
    assert "kLaneMask = 0x3fu" in form.source
    fp = testfns.make_fletcher_powell(64)
    form = trace.traced_form(lambda x: fp(x), (), 64)
    assert codegen.lanes_that_fit(form.graph) == codegen.LANES
    assert ck.supports(form, 64, 32) and ck.supports(form, 64, 64)


def test_hand_written_form_wins():
    """No longer: the three test functions keep their hand-written forms
    (``device_fn``), and a fake-CUDA plan of each resolves batched_hvp to
    ``cuda`` on the form generated from a trace of its kernel form, as the
    Pallas kernel evaluates every f; its blk_m dial is that form's."""
    for name in ("rosenbrock", "ackley", "fletcher_powell"):
        f = testfns.FUNCTIONS[name](16)
        p = _fake_cuda(f, 16)
        assert kernel_form(p.f)[2] == name
        assert p.backend_for("batched_hvp") == "cuda"
        form = ops.backend_form(f, 16)
        kf, consts, _ = kernel_form(f)
        assert form is trace.traced_form(kf, consts, 16) and form.traced
        assert form.n == 16 and ck.supports(form, 16, 4)
        top = ck.instance_blocks(form, 16, 4)[-1]
        assert _fake_cuda(f, 16, blk_m=top).backend_for(
            "batched_hvp") == "cuda"


def test_wrapper_off_the_card():
    kf = make_all_ops(9)
    A, V = (torch.from_numpy(a) for a in _data("wrap", 3, 9))
    before = (ck.chess_hvp_cuda.launches, ck.chess_hvp_cuda.traced_launches)
    for symmetric in (False, True):
        got = ck.chess_hvp_cuda(kf, A, V, 4, symmetric=symmetric)
        assert torch.equal(got, ck.chess_hvp_plain(kf, A, V, 4, (),
                                                   symmetric))
    assert (ck.chess_hvp_cuda.launches,
            ck.chess_hvp_cuda.traced_launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        ck.chess_hvp_cuda(kf, A.to("meta"), V.to("meta"), 4)
    # the blk_m dial of the generated form: checked (the form traced) on
    # the CPU too, where the plain version does not use it
    form = trace.traced_form(kf, (), 9)
    blocks = ck.instance_blocks(form, 9, 4)
    for ipb in blocks:
        assert torch.equal(ck.chess_hvp_cuda(kf, A, V, 4, ipb=ipb),
                           ck.chess_hvp_plain(kf, A, V, 4))
    for bad in (3, 2 * blocks[-1], True):
        with pytest.raises(ValueError, match="ipb"):
            ck.chess_hvp_cuda(kf, A, V, 4, ipb=bad)


@pytest.mark.parametrize("symmetric,csize,want", [(False, 1, 68),
                                                  (True, 1, 50),
                                                  (True, 2, 56)])
def test_needed_work_of_a_sum_of_squares(symmetric, csize, want):
    """(x x).sum(0) at n = 4: a cell's dij is 2 di dj, nonzero only where
    its row i is one of its columns, at one lane.  Its graph spells dij as
    four sums over dij val, di dj (the di dj product and three adds reach
    the nonzero lane, the dij val terms none) and the sum over n: 5
    operations in each of the 4 cells that hold the diagonal, none in the
    others, and 3 a column for the scatter in every cell: 16 cells of one
    column (full), 10 (symmetric), 6 of two columns (symmetric, csize 2)."""
    form = trace.traced_form(lambda x: (x * x).sum(0), (), 4)
    assert ck.needed_work(form, 1, 4, csize, symmetric)[0] == want
    assert ck.needed_work(form, 3, 4, csize, symmetric)[0] == 3 * want


@pytest.mark.parametrize("name", ["rosenbrock", "ackley", "fletcher_powell"])
def test_needed_work_below_the_active_set_count(name):
    """The count the seeds' structural zeros leave is at most the
    structural form's own count (``work``: what its code runs), which is at
    most the hand-written form's active-set count (``needed_work`` of its
    name)."""
    n = 10
    f = testfns.FUNCTIONS[name](n)
    form = trace.traced_form(lambda x: f(x), (), n)
    for symmetric in (False, True):
        for csize in (1, 3, 4):
            got = ck.needed_work(form, 1, n, csize, symmetric)[0]
            own = ck.work(form, 1, n, csize, symmetric)[0]
            hand = ck.needed_work(name, 1, n, csize, symmetric)[0]
            assert 0 < got <= own <= hand, (symmetric, csize)


def test_form_accounting():
    """The traced form's launch numbers: its instance slot (a, v, out and
    the rows its instance pass stores), the wrapper's instances per CTA in
    that slot, the code's own count in ``work`` (each sub-cell past 64
    lanes, and the instance pass once an instance), the constants' bytes,
    and a deterministic source named by its hash under
    ``build.BUILD_DIR``."""
    n = 10
    f = make_all_ops(n)
    form = trace.traced_form(f, (), n)
    assert trace.traced_form(f, (), n) is form           # cached
    slot = (form.rows * (n | 1) + form.scalars) | 1
    assert form.rows > 3 and f"kRows = {form.rows}" in form.source
    for q in (1, 3, 32):
        assert ck.shared_bytes(form, n, q, 4) == 4 * ((q * slot + 3) & ~3)
    assert ck.instance_blocks(form, n, 4) == [
        q for q in (1, 2, 4, 8, 16, 32)
        if ck.shared_bytes(form, n, q, 4) <= ck.SMEM_MAX]
    assert ck.max_n(form, 4) == n
    P = ck.num_chunk_evals(n, 3, True)
    once = codegen.instance_operations(form.graph)
    ops_, nbytes = ck.work(form, 5, n, 3, True)
    assert ops_ == 5 * (int(form.cell_counts(n, 3, True).sum()) + once)
    assert once > 0 and len(form.cell_counts(n, 3, True)) == P
    assert nbytes == 4 * 3 * 5 * n + 4 * (form.graph.consts.size + 2 * P)
    wide = form.cell_counts(n, 96, False)          # one sub-cell a row
    assert len(wide) == n
    assert ck.work(form, 1, n, 96, False)[0] == int(wide.sum()) + once
    # another trace of the same function: the same text, the same library
    again = trace.lower(my_function, (), n)
    assert again.source == trace.traced_form(my_function, (), n).source
    cu, so, log = build.generated_paths(form.source)
    assert cu.parent == so.parent == log.parent == build.BUILD_DIR
    assert os.path.basename(so).startswith("libchess_hvp_traced-")
