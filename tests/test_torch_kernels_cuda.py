"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  chess_hvp: rtol 5e-3, atol 5e-3 * (1 + max|want|), the
reference's kernel tolerance, in every input type (a 16-bit output is one
rounding of a float32 result on both sides, so the two differ by at most
one unit in the last place, 2^-8 of the value in bfloat16, inside it).
hdual_linear: the reference's sweep tolerances, float32 rtol 1e-5, atol
1e-5 * din (TF32 off for the plain version), bfloat16 1e-1, 1e-1 * din,
on both variants (wgmma: tensor cores, 3xTF32 in float32; simt: FFMA) and
both entry points; float32 is also held at the full-width bound of
chip_smoke.py, rtol 1e-5, atol 1e-5 * (1 + max|want|), which a plain TF32
product fails.  chess_hvp's instances per CTA (the tuner's blk_m): every
listed one against the kernel's own pick, at the kernel tolerance.
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
# shapes the wgmma variant takes in every type (din a multiple of 128 bytes,
# dout of 8): ragged T, several column tiles (BN 64, 128 and 256), T = 1
TC_SHAPES = [(2, 64, 64, 64), (3, 200, 64, 64), (10, 300, 128, 200),
             (4, 100, 256, 136), (1, 1, 64, 8), (18, 40, 128, 320)]
LINEAR_DTYPES = [(torch.float32, 1e-5), (torch.bfloat16, 1e-1),
                 (torch.float16, 1e-1)]
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


# n on both sides of the largest n whose A^T and B^T Fletcher-Powell stages
# in shared memory (168 at 4 lanes, 159 at 8, 55 at 64); each form runs all
@pytest.mark.cuda
@pytest.mark.parametrize("m,n,csize", [(3, 168, 4), (3, 169, 4),
                                       (3, 159, 8), (3, 160, 8),
                                       (5, 55, 40), (5, 56, 40)])
@pytest.mark.parametrize("function", FNS)
def test_cuda_kernel_around_the_staging_size(cuda, function, m, n, csize):
    lanes = ck.lanes_for(csize)
    staged = ck.launch_config("fletcher_powell", n, lanes)[1]
    assert staged == (n in (168, 159, 55))
    for symmetric in (False, True):
        _check_chess(cuda, function, m, n, csize, symmetric)


def _one_cell(cuda, function, n, i, cstart, csize):
    """Run the kernel on the single cell (i, cstart) of one instance at n,
    through the wrapper's launch configuration; returns (out, a, v, f)."""
    rng = np.random.RandomState(n)
    a = torch.from_numpy(rng.uniform(-2, 2, (1, n)).astype(np.float32))
    v = torch.from_numpy(rng.randn(1, n).astype(np.float32))
    f = testfns.FUNCTIONS[function](n)
    kf, consts, device_fn = kernel_form(f)
    mats = [c.to(cuda) for c in consts]
    if mats:
        mats = [mats[0].t().contiguous(), mats[1].t().contiguous(), mats[2]]
    rows = torch.tensor([i], dtype=torch.int32, device=cuda)
    starts = torch.tensor([cstart], dtype=torch.int32, device=cuda)
    A, V = a.to(cuda), v.to(cuda)
    out = torch.empty_like(A)
    err = ck._launch(A, V, out, rows, starts, csize, False, device_fn,
                     [t.data_ptr() for t in mats] or [None] * 3)
    torch.cuda.synchronize()
    assert err == 0
    return out.cpu()[0].double(), a[0].double(), v[0].double(), f


@pytest.mark.cuda
@pytest.mark.parametrize("function", FNS)
def test_cuda_kernel_at_its_shared_memory_cap(cuda, function):
    """At the largest n one CTA takes, the kernel launches (shared-memory
    opt-in, the layout's byte count agreed) and one cell's terms equal a
    float64 Hessian row's; one past it, the engine resolves to vmap_l2, the
    wrapper refuses, and so does the C entry point."""
    from repro_torch.core import ref
    csize = 64
    cap = ck.max_n(function, csize)
    i, cstart = cap // 2, 64
    out, a, v, f = _one_cell(cuda, function, cap, i, cstart, csize)
    e = torch.zeros(cap, dtype=torch.float64)
    e[i] = 1.0
    row = ref.hvp_fwdrev(f, a, e)                  # H[:, i] = H[i, :]
    cols = slice(cstart, cstart + csize)
    want = float((row[cols] * v[cols]).sum())
    assert abs(float(out[i]) - want) <= 5e-3 * (1 + abs(want))
    out[i] = 0.0
    assert float(out.abs().max()) == 0.0           # the only term is out[i]

    f1 = testfns.FUNCTIONS[function](cap + 1)
    p = engine.plan(f1, cap + 1, m=1, csize=csize)
    assert p.backend_for("batched_hvp") == "vmap_l2"
    kf, consts, device_fn = kernel_form(f1)
    A = torch.zeros(1, cap + 1, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ck.chess_hvp_cuda(kf, A, A, csize, consts=[c.to(cuda) for c in consts],
                          device_fn=device_fn)
    lanes = ck.lanes_for(csize)
    warps, staged = ck.launch_config(function, cap + 1, lanes)
    cell = torch.zeros(1, dtype=torch.int32, device=cuda)
    err = ck._launcher()(
        A.data_ptr(), A.data_ptr(), A.data_ptr(), 0, cell.data_ptr(),
        cell.data_ptr(), 1, 1, cap + 1, csize, lanes, 0,
        ck.DEVICE_FNS[function], 1, max(warps, 1), int(staged),
        ck.shared_bytes(function, cap + 1, 1, lanes), None, None, None,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0                                # refused, nothing launched


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


def _held(got, want, dtype, tol, din):
    """The reference's tolerance, and for float32 the full-width bound."""
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * din)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * (1 + np.abs(want).max()))


def _counts():
    return dict(hl.hdual_linear_cuda.launches_by_variant)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["wgmma", "simt"])
@pytest.mark.parametrize("dtype,tol", LINEAR_DTYPES)
def test_cuda_hdual_linear_variants(cuda, variant, dtype, tol):
    """The stacked entry point on each variant, one launch of it a call."""
    for K2, T, din, dout in TC_SHAPES:
        rng = np.random.RandomState(K2 * T)
        x = torch.from_numpy(rng.randn(K2, T, din).astype(np.float32))
        w = torch.from_numpy(rng.randn(din, dout).astype(np.float32))
        x, w = x.to(cuda, dtype), w.to(cuda, dtype)
        before = _counts()
        got = hl.hdual_linear_cuda(x, w, bt=1, bo=8, bk=64, variant=variant)
        torch.cuda.synchronize()
        want = dict(before, **{variant: before[variant] + 1})
        assert _counts() == want
        assert got.dtype == dtype and got.shape == (K2, T, dout)
        _held(got, hl.hdual_linear_plain(x, w), dtype, tol, din)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 4, 8])
@pytest.mark.parametrize("variant", ["wgmma", "simt"])
@pytest.mark.parametrize("dtype,tol", LINEAR_DTYPES)
def test_cuda_hdual_linear_apply_variants(cuda, variant, dtype, tol, c):
    """hdual_linear_apply on each variant: one launch, no stacking, the
    result's four components contiguous and equal to the CPU's."""
    for value_shape, dout in (((300, 64), 64), ((64,), 64),
                              ((50, 128), 136)):
        rng = np.random.RandomState(c * dout + len(value_shape))
        comps = [torch.from_numpy(rng.randn(*shape).astype(np.float32))
                 .to(dtype) for shape in (value_shape, value_shape,
                                          value_shape + (c,),
                                          value_shape + (c,))]
        w = torch.from_numpy(
            rng.randn(value_shape[-1], dout).astype(np.float32)).to(dtype)
        want = hdual_linear_apply(HDual(*comps), w, bt=1, bo=8, bk=64)
        before = _counts()
        got = hdual_linear_apply(HDual(*(t.to(cuda) for t in comps)),
                                 w.to(cuda), bt=1, bo=8, bk=64,
                                 variant=variant)
        torch.cuda.synchronize()
        assert _counts() == dict(before, **{variant: before[variant] + 1})
        for name in ("val", "di", "dj", "dij"):
            t = getattr(got, name)
            assert t.is_contiguous() and t.dtype == dtype
            _held(t, getattr(want, name), dtype, tol, value_shape[-1])


@pytest.mark.cuda
def test_cuda_hdual_linear_views_take_simt(cuda):
    """A view TMA cannot read (a pointer off 16 bytes, strided components)
    runs on the simt variant, read where it lies; forcing wgmma raises."""
    rng = np.random.RandomState(9)
    flat = torch.from_numpy(rng.randn(1 + 4 * 32 * 64).astype(np.float32))
    flat = flat.to(cuda)
    x = flat[1:].view(4, 32, 64)
    w = torch.from_numpy(rng.randn(64, 16).astype(np.float32)).to(cuda)
    before = _counts()
    got = hdual_linear(x, w, bt=32)
    torch.cuda.synchronize()
    assert _counts() == dict(before, simt=before["simt"] + 1)
    _held(got, hl.hdual_linear_plain(x, w), torch.float32, 1e-5, 64)
    with pytest.raises(ValueError, match="wgmma"):
        hl.hdual_linear_cuda(x, w, variant="wgmma")
    T, din, c = 40, 64, 4
    comps = [torch.from_numpy(rng.randn(*shape).astype(np.float32))
             for shape in ((din, T), (din, T), (c, din, T), (c, din, T))]
    hd = HDual(comps[0].T, comps[1].T, comps[2].permute(2, 1, 0),
               comps[3].permute(2, 1, 0))
    want = hdual_linear_apply(hd, w.cpu(), bt=8)
    before = _counts()
    got = hdual_linear_apply(
        HDual(*(t.to(cuda).T if t.dim() == 2 else t.to(cuda).permute(2, 1, 0)
                for t in comps)), w, bt=8)
    torch.cuda.synchronize()
    assert _counts() == dict(before, simt=before["simt"] + 1)
    for name in ("val", "di", "dj", "dij"):
        _held(getattr(got, name), getattr(want, name), torch.float32, 1e-5,
              din)


@pytest.mark.cuda
def test_cuda_service_serves_dense_buckets_on_the_kernel(cuda):
    """A service on the card: 300 Rosenbrock HVPs at n = 64 from a family
    plan coalesce into dense buckets, every bucket launches chess_hvp once
    (telemetry: backend cuda), and every row matches the plain version."""
    from repro_torch.engine.service import CurvatureService
    engine.clear_telemetry()
    fam = testfns.ragged_family("rosenbrock")
    p = engine.plan(fam, 64, symmetric=False, device="cuda")
    assert p.backend_for("batched_hvp") == "cuda"
    rng = np.random.RandomState(7)
    A = rng.uniform(-2, 2, (300, 64)).astype(np.float32)
    V = rng.randn(300, 64).astype(np.float32)
    before = ck.chess_hvp_cuda.launches
    with CurvatureService(max_batch=64, max_wait_us=500.0) as svc:
        futs = [svc.submit(p, A[i], V[i]) for i in range(300)]
        got = np.stack([f.result(timeout=120) for f in futs])
        batches = svc.stats()["batches"]
    (rec,) = engine.execution_stats()
    assert rec["backend"] == "cuda" and rec["workload"] == "batched_hvp"
    assert sum(b["count"] for b in rec["by_bucket"].values()) == batches
    assert ck.chess_hvp_cuda.launches - before == batches > 0
    kf, consts, _ = kernel_form(testfns.rosenbrock)
    want = ck.chess_hvp_plain(kf, torch.from_numpy(A), torch.from_numpy(V),
                              p.csize, consts, False).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-3,
                               atol=5e-3 * (1 + np.abs(want).max()))


def _chess_inputs(cuda, function, m, n):
    rng = np.random.RandomState(zlib.crc32(f"ipb{function}{m}{n}".encode()))
    A = torch.from_numpy(rng.uniform(-2, 2, (m, n)).astype(np.float32))
    V = torch.from_numpy(rng.randn(m, n).astype(np.float32))
    kf, consts, device_fn = kernel_form(testfns.FUNCTIONS[function](n))
    return (A.to(cuda), V.to(cuda), kf, tuple(c.to(cuda) for c in consts),
            device_fn)


@pytest.mark.cuda
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("function", FNS)
def test_cuda_every_instance_block_matches_the_default(cuda, function,
                                                       symmetric):
    """Every instances-per-CTA the tuner may pick (instance_blocks), and
    the kernel's own pick, against the plain version at the kernel
    tolerance, one launch each; ragged m (not a multiple of any block) and
    both auto chunk sizes."""
    m, n = 203, 64
    A, V, kf, consts, device_fn = _chess_inputs(cuda, function, m, n)
    for csize in (4, 8):
        kw = dict(consts=consts, device_fn=device_fn, symmetric=symmetric)
        want = ck.chess_hvp_plain(kf, A, V, csize, consts,
                                  symmetric).cpu().numpy()
        blocks = ck.instance_blocks(function, n, csize)
        assert blocks and blocks[0] == 1
        for ipb in [None] + blocks:
            before = ck.chess_hvp_cuda.launches
            got = ck.chess_hvp_cuda(kf, A, V, csize, ipb=ipb, **kw)
            torch.cuda.synchronize()
            assert ck.chess_hvp_cuda.launches == before + 1
            np.testing.assert_allclose(
                got.cpu().numpy(), want, rtol=5e-3,
                atol=5e-3 * (1 + np.abs(want).max()),
                err_msg=f"{function} csize={csize} ipb={ipb}")


@pytest.mark.cuda
@pytest.mark.parametrize("function", FNS)
def test_cuda_instance_block_past_the_fit_raises_before_launch(cuda,
                                                               function):
    m, n, csize = 16, 64, 8
    A, V, kf, consts, device_fn = _chess_inputs(cuda, function, m, n)
    top = ck.instance_blocks(function, n, csize)[-1]
    before = ck.chess_hvp_cuda.launches
    for bad in (0, 3, top + 1, 2 * top):
        with pytest.raises(ValueError, match="ipb"):
            ck.chess_hvp_cuda(kf, A, V, csize, consts=consts,
                              device_fn=device_fn, ipb=bad)
    assert ck.chess_hvp_cuda.launches == before
    # plan() refuses the same blk_m on the card
    f = testfns.FUNCTIONS[function](n)
    for bad in (3, 2 * top):
        with pytest.raises(ValueError, match="blk_m"):
            engine.plan(f, n, m=m, csize=csize, blk_m=bad, device="cuda")


@pytest.mark.cuda
def test_cuda_autotuned_plan_runs_the_kernel(cuda, monkeypatch, tmp_path):
    """plan(csize="autotune") on the card: a cuda winner (no candidate
    raised), its blk_m in the plan, one launch per batched_hvp, the plain
    version's result."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    engine.clear_autotune_cache()
    try:
        f = testfns.FUNCTIONS["rosenbrock"](32)
        p = engine.plan(f, 32, m=4096, csize="autotune", symmetric=False,
                        device="cuda")
        cfg = engine.lookup_tuned(p, "batched_hvp")
        assert cfg.backend == "cuda" and not cfg.failures
        assert p.opt("blk_m") == cfg.blk_m
        assert p.backend_for("batched_hvp") == "cuda"
        A, V, kf, consts, _ = _chess_inputs(cuda, "rosenbrock", 4096, 32)
        before = ck.chess_hvp_cuda.launches
        got = p.batched_hvp(A, V)
        torch.cuda.synchronize()
        assert ck.chess_hvp_cuda.launches == before + 1
        want = ck.chess_hvp_plain(kf, A, V, p.csize, consts, False)
        np.testing.assert_allclose(
            got.cpu().numpy(), want.cpu().numpy(), rtol=5e-3,
            atol=5e-3 * (1 + want.abs().max().item()))
    finally:
        engine.clear_autotune_cache()


@pytest.mark.cuda
def test_cuda_a_raising_kernel_raises_both_sweeps(cuda, monkeypatch,
                                                  tmp_path):
    """A cuda candidate that raises on the card is a kernel fault: the
    offline sweep and the bucket sweep raise it rather than hand back a
    vmap winner."""
    from repro_torch.kernels import ops
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))

    def broken(*args, **kw):
        raise RuntimeError("chess_hvp: launch failed")

    monkeypatch.setattr(ops, "chess_hvp_cuda", broken)
    engine.clear_autotune_cache()
    try:
        f = testfns.FUNCTIONS["rosenbrock"](32)
        with pytest.raises(RuntimeError, match="cuda candidate"):
            engine.autotune(f, 32, m=64, reps=1, device="cuda")
        with pytest.raises(RuntimeError, match="cuda candidate"):
            engine.autotune_buckets(f, 32, [16], reps=1, use_store=False,
                                    dtype_policies=("fp32",), device="cuda")
    finally:
        engine.clear_autotune_cache()


# ---------------------------------------------------------------------------
# pytree curvature on the card (no kernel: torch.func on the LM loss)
# ---------------------------------------------------------------------------

def _curvature_run(device, cfg, params, batch, v, w, probes):
    """The five workloads of one plan on ``device``, results on the CPU."""
    from repro_torch.core import curvature as tc
    from repro_torch.models.targets import lm_curvature_targets

    def on(tree):
        return torch.utils._pytree.tree_map(lambda t: t.to(device), tree)

    p, vv, ww = on(params), on(v), on(w)
    tgt = lm_curvature_targets(cfg, on(batch))
    plan = engine.plan(tgt.loss, None, csize=2, device=device,
                       options={"n_probes": 4, **tgt.plan_options()})
    out = {"hvp": plan.hvp(p, vv), "quadform": plan.quadform(p, vv, ww),
           "ggn": plan.ggn(p, vv), "fisher": plan.fisher(p, vv),
           "diag": tc._diag_from_probes(tc._hvp_map(tgt.loss, p),
                                        on(probes), 2)}
    return {k: torch.utils._pytree.tree_map(lambda t: t.cpu(), o)
            for k, o in out.items()}


@pytest.mark.cuda
def test_cuda_reduced_danube_curvature_matches_the_cpu(cuda):
    """The reduced h2o-danube-1.8b at float32 compute (TF32 off): the same
    params, v, w and probes through hvp, quadform, ggn, fisher and diag on
    the card and on the CPU, normalized error 1e-4."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import curvature as tc
    from repro_torch.models.model import make_batch
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b", reduced=True),
                              compute_dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    batch = make_batch(cfg, 2, 48, 0, device="cpu")
    v, w = tc.rademacher_like(1, params), tc.rademacher_like(2, params)
    gen = torch.Generator().manual_seed(3)
    probes = tc._stack([tc.rademacher_like(gen, params) for _ in range(4)])
    want = _curvature_run(torch.device("cpu"), cfg, params, batch, v, w,
                          probes)
    got = _curvature_run(cuda, cfg, params, batch, v, w, probes)
    for k in want:
        g = torch.cat([t.double().ravel() for t in
                       torch.utils._pytree.tree_leaves(got[k])])
        r = torch.cat([t.double().ravel() for t in
                       torch.utils._pytree.tree_leaves(want[k])])
        assert float((g - r).norm() / r.norm()) <= 1e-4, k


@pytest.mark.cuda
def test_cuda_full_width_danube_hvp(cuda):
    """One HVP of the full-width h2o-danube-1.8b loss (1.83B float32
    params, bfloat16 compute, 2 x 512 tokens) on the card: finite, in the
    params' dtype; prints its peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.core import curvature as tc
    from repro_torch.models.model import make_batch
    from repro_torch.models.params import init_params
    from repro_torch.models.targets import lm_curvature_targets
    cfg = get_config("h2o-danube-1.8b")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_params(cfg, gen, device=cuda)
    tgt = lm_curvature_targets(cfg, make_batch(cfg, 2, 512, gen,
                                               device=cuda))
    plan = engine.plan(tgt.loss, None, device=cuda)
    v = tc.rademacher_like(1, params)
    torch.cuda.reset_peak_memory_stats()
    hv = plan.hvp(params, v)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"full-width h2o-danube-1.8b hvp: peak {peak / 1e9:.2f} GB")
    for leaf in torch.utils._pytree.tree_leaves(hv):
        assert leaf.dtype == torch.float32
        assert bool(torch.isfinite(leaf).all())
    assert peak < torch.cuda.get_device_properties(cuda).total_memory
