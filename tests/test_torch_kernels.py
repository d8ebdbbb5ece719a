"""chess_hvp port: the plain version against the JAX oracle
(``repro.kernels.ref.chess_hvp_ref`` called with the kernel form, at the
tolerance of tests/test_kernels.py), the launch shape, the wrapper's checks
and its CPU dispatch.  The kernel itself is held against the plain version
on the card by tests/test_torch_kernels_cuda.py."""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core import testfns as jtestfns  # noqa: E402
from repro.kernels.ops import _fn_and_consts  # noqa: E402
from repro.kernels.ref import chess_hvp_ref as _j_chess_hvp_ref  # noqa: E402
from repro_torch.core import testfns  # noqa: E402
from repro_torch.core.api import chunk_pairs, num_chunk_evals  # noqa: E402
from repro_torch.kernels import chess_hvp as ck  # noqa: E402
from repro_torch.kernels.ops import chess_hvp, kernel_form  # noqa: E402
from repro_torch.kernels.ref import chess_hvp_ref  # noqa: E402

FNS = ("rosenbrock", "ackley", "fletcher_powell")
# the JAX oracle compiled once per signature (its eager vmap is slow)
j_chess_hvp_ref = jax.jit(_j_chess_hvp_ref, static_argnums=(0, 3))
j_batched_hvp = jax.jit(japi.batched_hvp_impl, static_argnums=(0, 3, 4, 5))
# the shapes of tests/test_kernels.py: divisible, ragged n, ragged m
# (m % blk_m there), both, and csize > n
SHAPES = [(16, 8, 2), (8, 16, 4), (8, 8, 8), (24, 12, 3),
          (8, 10, 4), (8, 9, 2), (5, 8, 2), (13, 7, 3), (4, 6, 16)]


def _data(tag, m, n):
    rng = np.random.RandomState(zlib.crc32(tag.encode()))
    return (rng.uniform(-2, 2, (m, n)).astype(np.float32),
            rng.randn(m, n).astype(np.float32))


def _kernel_args(function, n, device="cpu"):
    kf, consts, device_fn = kernel_form(testfns.FUNCTIONS[function](n))
    return kf, tuple(c.to(device) for c in consts), device_fn


def _kernel_tol(want):
    return dict(rtol=5e-3, atol=5e-3 * (1 + np.abs(want).max()))


@pytest.mark.parametrize("m,n,csize", SHAPES)
@pytest.mark.parametrize("function", FNS)
def test_plain_matches_jax_oracle(function, m, n, csize):
    A, V = _data(f"{function}{m}{n}{csize}", m, n)
    kf, consts, _ = _kernel_args(function, n)
    jkf, jconsts = _fn_and_consts(function, n)
    want = np.asarray(j_chess_hvp_ref(jkf, jnp.asarray(A), jnp.asarray(V),
                                      csize, jconsts))
    for symmetric in (False, True):
        got = ck.chess_hvp_plain(kf, torch.from_numpy(A), torch.from_numpy(V),
                                 csize, consts, symmetric)
        np.testing.assert_allclose(got.numpy(), want, **_kernel_tol(want),
                                   err_msg=f"symmetric={symmetric}")


@pytest.mark.parametrize("function", FNS)
def test_port_oracle_takes_kernel_form(function):
    """The port's oracle always gets (kf, consts), the way the kernel gets f,
    and agrees with the plain version on both schedules."""
    m, n, csize = 6, 10, 4
    A, V = (torch.from_numpy(x) for x in _data(function, m, n))
    kf, consts, _ = _kernel_args(function, n)
    want = chess_hvp_ref(kf, A, V, csize, consts)
    for symmetric in (False, True):
        got = ck.chess_hvp_plain(kf, A, V, csize, consts, symmetric)
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   **_kernel_tol(want.numpy()))


@pytest.mark.parametrize("device_fn", FNS)
@pytest.mark.parametrize("symmetric", [False, True])
def test_kernel_grid_is_the_sweep_count(symmetric, device_fn):
    for m, n, csize in SHAPES + [(524288, 64, 4), (524288, 64, 8), (1, 1, 1)]:
        ctas, cells = ck.kernel_grid(m, n, csize, symmetric, device_fn)
        assert cells == num_chunk_evals(n, csize, symmetric)
        ipb = ck._instances_per_block(cells, n, device_fn,
                                      ck.lanes_for(csize))
        assert ctas == -(-m // ipb) and 1 <= ipb <= 32


@pytest.mark.parametrize("device_fn", FNS)
def test_main_path_launch_shape(device_fn):
    """n=64 at the op model's csize: 544 cells (symmetric, c=4) and 512
    cells (full, c=8), with no idle worker (a thread, or Fletcher-Powell's
    group of lanes) in a CTA's last stride; where a thread runs a cell,
    32 instances sit on a warp's lanes, and Fletcher-Powell's half-warp
    cells (8 lanes) stage its matrices for 4."""
    for csize, symmetric, cells in ((4, True, 544), (8, False, 512)):
        ctas, P = ck.kernel_grid(524288, 64, csize, symmetric, device_fn)
        ipb = ck._instances_per_block(P, 64, device_fn, csize)
        workers = ck._workers(device_fn, csize, 64)
        assert P == cells and (ipb * P) % workers == 0
        assert ctas * ipb == 524288
        grouped = device_fn == "fletcher_powell" and csize == 8
        assert ipb == (4 if grouped else 32)


def test_lanes_and_operation_counts():
    # past 64 lanes the widest instantiation serves the chunk as sub-cells
    assert [ck.lanes_for(c) for c in (1, 3, 4, 5, 33, 64, 65, 128)] == [
        1, 4, 4, 8, 64, 64, 64, 64]
    # one cell of fletcher_powell at n=64, 4 lanes, each coordinate's sin and
    # cos map counted once: 2n(4C+2) + n^2(8C+8) + n(14C+9) + 3C
    assert ck.cell_operations("fletcher_powell", 64, 4) == 170316
    ops, nbytes = ck.work("rosenbrock", 10, 8, 2, True)
    assert ops == 10 * num_chunk_evals(8, 2, True) * (7 * 97 + 6)
    assert nbytes == 4 * (3 * 10 * 8 + 2 * num_chunk_evals(8, 2, True))
    # csize 96 at n = 100, symmetric: 196 cells (rows 0-95 take chunks 0 and
    # 96, rows 96-99 chunk 96), charged at the 96 lanes the schedule needs;
    # 292 sub-cells in the work list (chunk 0 splits at 64, chunk 96 does
    # not reach 160); 16-bit A, V and output
    ops, nbytes = ck.work("rosenbrock", 10, 100, 96, True, itemsize=2)
    assert ops == 10 * 196 * (99 * (38 * 96 + 21) + 3 * 96)
    assert nbytes == 2 * 3 * 10 * 100 + 4 * 2 * 292


@pytest.mark.parametrize("n,csize,symmetric", [
    (100, 96, True), (100, 96, False), (128, 128, False), (130, 65, True),
    (64, 8, True)])
def test_sub_cells(n, csize, symmetric):
    """The kernel's work list: every schedule cell split at 64 columns,
    sub-cells past n dropped; exactly the schedule's cells for csize <= 64.
    The launch grid's cell count stays the schedule's."""
    rows, starts = ck.sub_cells(n, csize, symmetric)
    pairs = [tuple(p) for p in chunk_pairs(n, csize, symmetric)]
    want = [(i, c + o) for i, c in pairs for o in range(0, csize, 64)
            if c + o < n]
    assert list(zip(rows.tolist(), starts.tolist())) == want
    assert rows.dtype == starts.dtype == np.int32
    if csize <= 64:
        assert len(rows) == len(pairs)
    for device_fn in FNS:
        assert ck.kernel_grid(1000, n, csize, symmetric,
                              device_fn)[1] == len(pairs)


@pytest.mark.parametrize("function", FNS)
def test_wrapper_on_cpu_is_the_plain_version(function):
    m, n, csize = 5, 9, 4
    A, V = (torch.from_numpy(x) for x in _data(function, m, n))
    kf, consts, device_fn = _kernel_args(function, n)
    before = ck.chess_hvp_cuda.launches
    for symmetric in (False, True):
        want = ck.chess_hvp_plain(kf, A, V, csize, consts, symmetric)
        got = ck.chess_hvp_cuda(kf, A, V, csize, consts=consts,
                                device_fn=device_fn, symmetric=symmetric)
        assert torch.equal(got, want)
        named = chess_hvp(A, V, function=function, csize=csize,
                          symmetric=symmetric)
        assert torch.equal(named, want)
    assert ck.chess_hvp_cuda.launches == before     # CPU runs launch nothing


def test_wrapper_checks():
    kf, consts, device_fn = _kernel_args("rosenbrock", 4)
    A = torch.zeros(3, 4)
    bad = [(A.double(), A.double(), TypeError),
           (A.bfloat16(), A, TypeError),
           (A, torch.zeros(3, 5), ValueError),
           (A[0], A[0], ValueError),
           (torch.zeros(0, 4), torch.zeros(0, 4), ValueError),
           (A.to("meta"), A.to("meta"), ValueError)]
    for a, v, err in bad:
        with pytest.raises(err):
            ck.chess_hvp_cuda(kf, a, v, 2, device_fn=device_fn)
    with pytest.raises(ValueError):
        ck.chess_hvp_cuda(kf, A, A, 0, device_fn=device_fn)


def test_kernel_forms():
    for function in FNS:
        f = testfns.FUNCTIONS[function](6)
        kf, consts, device_fn = kernel_form(f)
        assert device_fn == function and device_fn in ck.DEVICE_FNS
        assert len(consts) == (3 if function == "fletcher_powell" else 0)
    assert kernel_form(lambda x: x.sum(0))[2] is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("function", FNS)
def test_plain_16bit_computes_in_float32(function, dtype):
    """16-bit A and V are widened to float32, computed, and the result
    rounded once to A.dtype; on CPU tensors the wrapper is that plain
    version."""
    m, n, csize = 4, 9, 4
    A, V = (torch.from_numpy(x).to(dtype) for x in _data(function, m, n))
    kf, consts, device_fn = _kernel_args(function, n)
    for symmetric in (False, True):
        want = ck.chess_hvp_plain(kf, A.float(), V.float(), csize, consts,
                                  symmetric).to(dtype)
        got = ck.chess_hvp_cuda(kf, A, V, csize, consts=consts,
                                device_fn=device_fn, symmetric=symmetric)
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("function", FNS)
def test_plain_wider_than_64_lanes_matches_jax_schedule(function, symmetric):
    """csize = 96 > 64 at n = 100 (ragged: the second chunk has 4 columns)
    against the JAX package's L2 schedule on the same schedule, at the
    reference's kernel tolerance."""
    m, n, csize = 3, 100, 96
    A, V = _data(f"{function}wide", m, n)
    want = np.asarray(j_batched_hvp(jtestfns.FUNCTIONS[function](n),
                                    jnp.asarray(A), jnp.asarray(V), csize,
                                    "L2", symmetric))
    kf, consts, _ = _kernel_args(function, n)
    got = ck.chess_hvp_plain(kf, torch.from_numpy(A), torch.from_numpy(V),
                             csize, consts, symmetric)
    np.testing.assert_allclose(got.numpy(), want, **_kernel_tol(want))
