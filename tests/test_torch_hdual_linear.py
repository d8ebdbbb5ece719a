"""hdual_linear port: the plain version and the entry points
(``repro_torch.kernels.ops.hdual_linear``/``hdual_linear_apply``) on CPU
tensors against the JAX package's entry points, which run the Pallas kernel
in interpret mode here.  Tolerances are the reference's own
(tests/test_kernels.py): float32 rtol 1e-5, atol 1e-5 * din; bfloat16 1e-1,
1e-1 * din; the hDual identities at 1e-5 and the network's Hessian chunk at
rtol 1e-3, atol 1e-4.  The kernel itself is held against the plain version
on the card by tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.hmath as jhm  # noqa: E402
from repro.core.hdual import HDual as JHDual  # noqa: E402
from repro.core.hdual import seed_point as j_seed_point  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import hmath  # noqa: E402
from repro_torch.core.hdual import seed_point  # noqa: E402
from repro_torch.kernels import hdual_linear as hl  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import hdual_linear_ref  # noqa: E402

# the shapes and tiles of tests/test_kernels.py::test_hdual_linear_sweep
SWEEP = [(6, 32, 16, 24, 32, 8, 16), (10, 128, 128, 128, 64, 128, 32),
         (4, 64, 32, 128, 16, 64, 32), (18, 8, 8, 8, 8, 8, 8)]
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 1e-1)}
_COMPONENTS = ("val", "di", "dj", "dij")


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _same_hdual(got, want, **tol):
    for name in _COMPONENTS:
        np.testing.assert_allclose(_f32(getattr(got, name)),
                                   _f32(getattr(want, name)), **tol,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("K2,T,din,dout,bt,bo,bk", SWEEP)
def test_matches_jax_entry_point(dtype, K2, T, din, dout, bt, bo, bk):
    tdt, jdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(K2)
    x = rng.randn(K2, T, din).astype(np.float32)
    w = rng.randn(din, dout).astype(np.float32)
    want = _f32(jops.hdual_linear(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                  bt=bt, bo=bo, bk=bk))
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    before = hl.hdual_linear_cuda.launches
    for got in (hl.hdual_linear_plain(tx, tw), hdual_linear_ref(tx, tw),
                ops.hdual_linear(tx, tw, bt=bt, bo=bo, bk=bk)):
        assert got.dtype == tdt and got.shape == (K2, T, dout)
        np.testing.assert_allclose(_f32(got), want, rtol=tol, atol=tol * din)
    assert hl.hdual_linear_cuda.launches == before  # CPU runs launch nothing


@pytest.mark.parametrize("value_shape", [(16,), (8, 16)])
def test_apply_matches_jax_apply(value_shape):
    """Both packages' hdual_linear_apply on the same hDual components; the
    last value axis is din in both."""
    c, dout = 3, 8
    rng = np.random.RandomState(len(value_shape))
    comps = [rng.randn(*value_shape).astype(np.float32) for _ in range(2)]
    comps += [rng.randn(*value_shape, c).astype(np.float32)
              for _ in range(2)]
    w = rng.randn(value_shape[-1], dout).astype(np.float32)
    want = jops.hdual_linear_apply(JHDual(*map(jnp.asarray, comps)),
                                   jnp.asarray(w), bo=4, bk=8)
    got = ops.hdual_linear_apply(convert.hdual_from_numpy(*comps),
                                 torch.from_numpy(w), bo=4, bk=8)
    assert got.shape == value_shape[:-1] + (dout,) and got.csize == c
    _same_hdual(got, want, rtol=1e-5, atol=1e-5 * value_shape[-1])


def test_apply_equals_matvec_const():
    rng = np.random.RandomState(3)
    a = torch.from_numpy(rng.randn(16).astype(np.float32))
    W = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    y = seed_point(a, 3, 4, 4)
    want = hmath.matvec_const(W.T, y)
    got = ops.hdual_linear_apply(y, W, bt=16, bo=8, bk=16)
    _same_hdual(got, want, rtol=1e-5, atol=1e-5)


def test_network_hessian_chunk():
    """sin(x W1) then . W2 with hdual_linear_apply for both maps, as
    tests/test_kernels.py does it: the Hessian chunk H[2, :4] against the
    JAX package's own computation and a float64 torch.func.hessian."""
    rng = np.random.RandomState(11)
    n, h, csize = 8, 16, 4
    W1 = (rng.randn(n, h) / np.sqrt(n)).astype(np.float32)
    W2 = (rng.randn(h, 1) / np.sqrt(h)).astype(np.float32)
    a = rng.randn(n).astype(np.float32)

    jy = j_seed_point(jnp.asarray(a), 2, 0, csize)
    jhidden = jhm.sin(jops.hdual_linear_apply(jy, jnp.asarray(W1), bt=8,
                                              bo=8, bk=8))
    jout = jhidden.sum(0) + jops.hdual_linear_apply(
        jhidden, jnp.asarray(W2), bt=8, bo=1, bk=8)[0]

    tW1, tW2 = torch.from_numpy(W1), torch.from_numpy(W2)
    y = seed_point(torch.from_numpy(a), 2, 0, csize)
    hidden = hmath.sin(ops.hdual_linear_apply(y, tW1, bt=8, bo=8, bk=8))
    out = hidden.sum(0) + ops.hdual_linear_apply(hidden, tW2, bt=8, bo=1,
                                                 bk=8)[0]

    def net(x):
        z = torch.sin(x @ tW1.double())
        return z.sum() + (z @ tW2.double())[0]

    H = torch.func.hessian(net)(torch.from_numpy(a).double())
    for want in (np.asarray(jout.dij), H[2, :csize].numpy()):
        np.testing.assert_allclose(out.dij.numpy(), want, rtol=1e-3,
                                   atol=1e-4)


@pytest.mark.parametrize("T,din,dout,bt,bo,bk", [
    (6, 8, 8, 4, 8, 8),       # bt does not divide T
    (8, 8, 12, 8, 8, 8),      # bo does not divide dout
    (8, 12, 8, 8, 8, 8),      # bk does not divide din
])
def test_tile_refusals_match_reference(T, din, dout, bt, bo, bk):
    x = np.zeros((4, T, din), np.float32)
    w = np.zeros((din, dout), np.float32)
    with pytest.raises(AssertionError):
        jax.block_until_ready(jops.hdual_linear(
            jnp.asarray(x), jnp.asarray(w), bt=bt, bo=bo, bk=bk))
    with pytest.raises(ValueError, match="divide"):
        ops.hdual_linear(torch.from_numpy(x), torch.from_numpy(w), bt=bt,
                         bo=bo, bk=bk)
    # the clamp: tiles larger than the dims are cut to them and accepted
    ops.hdual_linear(torch.from_numpy(x), torch.from_numpy(w), bt=512,
                     bo=512, bk=512)


def test_wrapper_checks():
    x = torch.zeros(2, 4, 8)
    w = torch.zeros(8, 4)
    bad = [(x.double(), w, TypeError),
           (x.to("meta"), w.to("meta"), ValueError),
           (x, w.to("meta"), ValueError),
           (x[0], w, ValueError),
           (x, torch.zeros(6, 4), ValueError),
           (x.transpose(1, 2).contiguous().transpose(1, 2), w, ValueError),
           (x, torch.zeros(4, 8).T, ValueError)]
    for xx, ww, err in bad:
        with pytest.raises(err):
            hl.hdual_linear_cuda(xx, ww)
    # w is cast to x.dtype, as the reference's oracle does
    y = hl.hdual_linear_cuda(x.bfloat16(), w)
    assert y.dtype == torch.bfloat16 and y.shape == (2, 4, 4)


def test_work_counts():
    # 2 K2 T din dout operations; x, w and y once, at 2 bytes an element
    assert hl.work(10, 4, 3, 5, 2) == (1200, 2 * (120 + 15 + 200))
    # the paper-scale case of chip_smoke.py: 2.68 GB of float32 traffic
    ops_, nbytes = hl.work(10, 524288, 64, 64, 4)
    assert ops_ == 42949672960 and nbytes == 2684370944
