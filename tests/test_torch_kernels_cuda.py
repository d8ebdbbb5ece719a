"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  chess_hvp: rtol 5e-3, atol 5e-3 * (1 + max|want|), the
reference's kernel tolerance, in every input type (a 16-bit output is one
rounding of a float32 result on both sides, so the two differ by at most
one unit in the last place, 2^-8 of the value in bfloat16, inside it).
hdual_linear: the reference's sweep tolerances, float32 rtol 1e-5, atol
1e-5 * din (TF32 off for the plain version), bfloat16 1e-1, 1e-1 * din.
Needs a CUDA card and nvcc; skips without a card.  Imports nothing of JAX,
so it runs where only the port is installed:

    PYTHONPATH=src python3 -m pytest -q --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import engine  # noqa: E402
from repro_torch.core import testfns  # noqa: E402
from repro_torch.core.hdual import HDual  # noqa: E402
from repro_torch.kernels import chess_hvp as ck  # noqa: E402
from repro_torch.kernels import hdual_linear as hl  # noqa: E402
from repro_torch.kernels.ops import (  # noqa: E402
    hdual_linear, hdual_linear_apply, kernel_form)

# the CPU sweep's shapes (ragged n, ragged m, csize > n) and the main
# path's width at both auto chunk sizes, plus csize = 64, the widest
SHAPES = [(16, 8, 2), (8, 16, 4), (8, 8, 8), (24, 12, 3), (8, 10, 4),
          (8, 9, 2), (5, 8, 2), (13, 7, 3), (4, 6, 16), (256, 64, 4),
          (256, 64, 8), (3, 64, 64)]


# chunks wider than the 64-lane instantiation, as sub-cells: ragged n
# (100 = 65 + 35, 96 + 4; csize 128 > n), exact (128), ragged m
WIDE_SHAPES = [(37, 100, 65), (37, 100, 96), (37, 100, 128), (9, 128, 128),
               (5, 130, 65)]
# the reference's test_hdual_linear_sweep shapes and tiles, and one with no
# dimension a multiple of the kernel's tiles
LINEAR_SWEEP = [(6, 32, 16, 24, 32, 8, 16), (10, 128, 128, 128, 64, 128, 32),
                (4, 64, 32, 128, 16, 64, 32), (18, 8, 8, 8, 8, 8, 8),
                (3, 130, 7, 9, 130, 9, 7)]
FNS = ["rosenbrock", "ackley", "fletcher_powell"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ for sm_90a "
                    "and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version: IEEE
    return torch.device("cuda")


def _check_chess(cuda, function, m, n, csize, symmetric, dtype=torch.float32):
    rng = np.random.RandomState(zlib.crc32(f"{function}{m}{n}".encode()))
    A = torch.from_numpy(rng.uniform(-2, 2, (m, n)).astype(np.float32))
    V = torch.from_numpy(rng.randn(m, n).astype(np.float32))
    A, V = A.to(cuda, dtype), V.to(cuda, dtype)
    kf, consts, device_fn = kernel_form(testfns.FUNCTIONS[function](n))
    consts = tuple(c.to(cuda) for c in consts)
    before = ck.chess_hvp_cuda.launches
    got = ck.chess_hvp_cuda(kf, A, V, csize, consts=consts,
                            device_fn=device_fn, symmetric=symmetric)
    torch.cuda.synchronize()
    assert ck.chess_hvp_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    want = ck.chess_hvp_plain(kf, A, V, csize, consts,
                              symmetric).float().cpu().numpy()
    np.testing.assert_allclose(
        got.float().cpu().numpy(), want, rtol=5e-3,
        atol=5e-3 * (1 + np.abs(want).max()),
        err_msg=f"m={m} n={n} csize={csize} {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("function", FNS)
def test_cuda_kernel_matches_plain(cuda, function, symmetric):
    for m, n, csize in SHAPES:
        _check_chess(cuda, function, m, n, csize, symmetric)


@pytest.mark.cuda
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("function,dtype", [
    (f, torch.bfloat16) for f in FNS] + [
    (f, torch.float16) for f in ("rosenbrock", "ackley")])
def test_cuda_kernel_16bit_inputs(cuda, function, dtype, symmetric):
    """A and V read in their own type, computed in float32, written in
    A.dtype.  Fletcher-Powell's Hessian-vector products (about 1e5-1e6 here)
    overflow float16, so it runs in bfloat16 only."""
    for m, n, csize in SHAPES:
        _check_chess(cuda, function, m, n, csize, symmetric, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("function", FNS)
def test_cuda_kernel_wider_than_64_lanes(cuda, function, symmetric):
    for m, n, csize in WIDE_SHAPES:
        _check_chess(cuda, function, m, n, csize, symmetric)


@pytest.mark.cuda
@pytest.mark.parametrize("n,csize,symmetric", [(128, 128, False),
                                               (100, 96, True)])
def test_cuda_engine_resolves_wide_chunks_to_the_kernel(cuda, n, csize,
                                                        symmetric):
    f = testfns.rosenbrock if n == 128 else testfns.make_fletcher_powell(n)
    p = engine.plan(f, n, m=16, csize=csize, symmetric=symmetric)
    assert p.backend_for("batched_hvp") == "cuda"
    rng = np.random.RandomState(n)
    A = torch.from_numpy(rng.uniform(-2, 2, (16, n)).astype(np.float32))
    V = torch.from_numpy(rng.randn(16, n).astype(np.float32))
    before = ck.chess_hvp_cuda.launches
    got = p.batched_hvp(A.to(cuda), V.to(cuda))
    torch.cuda.synchronize()
    assert ck.chess_hvp_cuda.launches == before + 1
    kf, consts, _ = kernel_form(f)
    want = ck.chess_hvp_plain(kf, A, V, csize, consts, symmetric).numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=5e-3,
                               atol=5e-3 * (1 + np.abs(want).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-1),
                                       (torch.float16, 1e-1)])
def test_cuda_hdual_linear_matches_plain(cuda, dtype, tol):
    for K2, T, din, dout, bt, bo, bk in LINEAR_SWEEP:
        rng = np.random.RandomState(K2)
        x = torch.from_numpy(rng.randn(K2, T, din).astype(np.float32))
        w = torch.from_numpy(rng.randn(din, dout).astype(np.float32))
        x, w = x.to(cuda, dtype), w.to(cuda, dtype)
        before = hl.hdual_linear_cuda.launches
        got = hdual_linear(x, w, bt=bt, bo=bo, bk=bk)
        torch.cuda.synchronize()
        assert hl.hdual_linear_cuda.launches == before + 1
        assert got.dtype == dtype and got.shape == (K2, T, dout)
        want = hl.hdual_linear_plain(x, w)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), rtol=tol,
                                   atol=tol * din,
                                   err_msg=f"{(K2, T, din, dout)}")


@pytest.mark.cuda
@pytest.mark.parametrize("value_shape", [(16,), (8, 16)])
def test_cuda_hdual_linear_apply(cuda, value_shape):
    """One launch per apply; the same components as on the CPU."""
    c = 4
    rng = np.random.RandomState(5)
    comps = [torch.from_numpy(rng.randn(*shape).astype(np.float32))
             for shape in (value_shape, value_shape, value_shape + (c,),
                           value_shape + (c,))]
    w = torch.from_numpy(rng.randn(value_shape[-1], 8).astype(np.float32))
    want = hdual_linear_apply(HDual(*comps), w)
    before = hl.hdual_linear_cuda.launches
    got = hdual_linear_apply(HDual(*(t.to(cuda) for t in comps)), w.to(cuda))
    torch.cuda.synchronize()
    assert hl.hdual_linear_cuda.launches == before + 1
    for name in ("val", "di", "dj", "dij"):
        np.testing.assert_allclose(getattr(got, name).cpu().numpy(),
                                   getattr(want, name).numpy(), rtol=1e-5,
                                   atol=1e-5 * value_shape[-1])


@pytest.mark.cuda
def test_cuda_wrapper_refusals(cuda):
    A = torch.zeros(2, 8, device=cuda)
    kf, consts, device_fn = kernel_form(testfns.rosenbrock)
    with pytest.raises(ValueError, match="device form"):
        ck.chess_hvp_cuda(kf, A, A, 2, device_fn=None)
    with pytest.raises(ValueError, match="contiguous"):
        At = torch.zeros(8, 2, device=cuda).T
        ck.chess_hvp_cuda(kf, At, At, 2, device_fn=device_fn)
    with pytest.raises(TypeError):
        ck.chess_hvp_cuda(kf, A.double(), A.double(), 2, device_fn=device_fn)
    with pytest.raises(TypeError):
        ck.chess_hvp_cuda(kf, A.half(), A, 2, device_fn=device_fn)
    # served now: a chunk wider than 64 lanes, and float16 inputs
    for csize, dtype in ((65, torch.float32), (2, torch.float16)):
        before = ck.chess_hvp_cuda.launches
        out = ck.chess_hvp_cuda(kf, A.to(dtype), A.to(dtype), csize,
                                device_fn=device_fn)
        torch.cuda.synchronize()
        assert ck.chess_hvp_cuda.launches == before + 1
        want = ck.chess_hvp_plain(kf, A.to(dtype), A.to(dtype), csize)
        assert out.dtype == dtype and torch.allclose(out, want, atol=1e-2)
    x = torch.zeros(2, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="divide"):
        hl.hdual_linear_cuda(x, torch.zeros(8, 8, device=cuda), bt=3)
    with pytest.raises(ValueError, match="x on"):
        hl.hdual_linear_cuda(x, torch.zeros(8, 8))
