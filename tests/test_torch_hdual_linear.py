"""hdual_linear port: the plain version and the entry points
(``repro_torch.kernels.ops.hdual_linear``/``hdual_linear_apply``) on CPU
tensors against the JAX package's entry points, which run the Pallas kernel
in interpret mode here.  Tolerances are the reference's own
(tests/test_kernels.py): float32 rtol 1e-5, atol 1e-5 * din; bfloat16 1e-1,
1e-1 * din; the hDual identities at 1e-5 and the network's Hessian chunk at
rtol 1e-3, atol 1e-4.  The operand-group plain version (the descriptors the
kernel reads), the 3xTF32 split and the kernel variant choice are checked
here too; the kernel itself is held against the plain version on the card by
tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.hmath as jhm  # noqa: E402
from repro.core.hdual import HDual as JHDual  # noqa: E402
from repro.core.hdual import seed_point as j_seed_point  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.hdual_linear import hdual_linear_pallas  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import hmath  # noqa: E402
from repro_torch.core.hdual import HDual, seed_point  # noqa: E402
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


def _hdual(rng, value_shape, c, dtype=torch.float32):
    """numpy components (val, di, dj, dij) and the port's HDual of them."""
    comps = [rng.randn(*value_shape).astype(np.float32) for _ in range(2)]
    comps += [rng.randn(*value_shape, c).astype(np.float32)
              for _ in range(2)]
    return comps, HDual(*(torch.from_numpy(x).to(dtype) for x in comps))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("value_shape", [(64,), (24, 64)])
@pytest.mark.parametrize("c", [1, 4, 8])
def test_groups_plain_matches_reference_apply(c, value_shape, dtype):
    """The operand-group plain version, on the groups the apply hands the
    kernel and on the same groups as the wgmma variant reads them, against
    hdual_linear_plain on the stacked components and the reference's
    hdual_linear_apply (Pallas in interpret mode), at the reference's
    tolerances."""
    tdt, jdt, tol = DTYPES[dtype]
    din, dout = value_shape[-1], 16
    rng = np.random.RandomState(100 * c + len(value_shape))
    comps, hd = _hdual(rng, value_shape, c, tdt)
    w = rng.randn(din, dout).astype(np.float32)
    tw = torch.from_numpy(w).to(tdt)
    want = jops.hdual_linear_apply(
        JHDual(*(jnp.asarray(x, jdt) for x in comps)), jnp.asarray(w, jdt))
    stacked = torch.cat([hd.val[None], hd.di[None], hd.dj.movedim(-1, 0),
                         hd.dij.movedim(-1, 0)]).reshape(2 * c + 2, -1, din)
    plain = hl.hdual_linear_plain(stacked, tw)
    before = hl.hdual_linear_cuda.launches
    got = ops.hdual_linear_apply(hd, tw)
    assert hl.hdual_linear_cuda.launches == before
    assert got.csize == c and got.shape == value_shape[:-1] + (dout,)
    assert all(getattr(got, n).is_contiguous() for n in _COMPONENTS)
    _same_hdual(got, want, rtol=tol, atol=tol * din)
    T = 1 if len(value_shape) == 1 else value_shape[0]
    for form in ("given", "tc"):
        outs = [torch.full((T, dout) + extra, float("nan"), dtype=tdt)
                for extra in ((), (), (c,), (c,))]
        groups = [hl._component_group(t.reshape(T, *t.shape[-1 - (i > 1):]),
                                      o)
                  for i, (t, o) in enumerate(zip(
                      (hd.val, hd.di, hd.dj, hd.dij), outs))]
        if form == "tc":
            groups = [hl.tc_form(g, din, dout) for g in groups]
            assert [g.ncomp for g in groups] == [1, 1, c, c]
        hl.groups_plain(groups, tw)
        ys = [outs[0][None], outs[1][None], outs[2].movedim(-1, 0),
              outs[3].movedim(-1, 0)]
        np.testing.assert_allclose(_f32(torch.cat(ys)), _f32(plain),
                                   rtol=tol, atol=tol * din, err_msg=form)


def test_groups_plain_reads_strided_views():
    """Descriptors of transposed and offset views, read and written where
    they lie: the group arithmetic the simt variant uses."""
    rng = np.random.RandomState(7)
    K2, T, din, dout = 3, 5, 8, 6
    base = torch.from_numpy(rng.randn(1 + K2 * T * din).astype(np.float32))
    x = base[1:].view(din, T, K2).permute(2, 1, 0)       # (K2, T, din) view
    w = torch.from_numpy(rng.randn(din, dout).astype(np.float32))
    out = torch.zeros(dout, K2, T + 2)[:, :, 1:T + 1].permute(1, 2, 0)
    g = hl.Group(x, out, K2, T, tuple(x.stride()), tuple(out.stride()))
    hl.groups_plain([g], w)
    np.testing.assert_allclose(out.numpy(), (x @ w).numpy(), rtol=1e-6,
                               atol=1e-6)
    assert hl.tc_form(g, din, dout) is None
    assert hl.choose_variant([g], din, dout, torch.float32) == "simt"


# the full-width bound of chip_smoke.py (FULL_RTOL, FULL_ATOL) for float32:
# rtol 1e-5, atol 1e-5 * (1 + max|want|)
FULL_RTOL, FULL_ATOL = 1e-5, 1e-5


def _rna_numpy(x):
    """TF32 rounding to nearest, ties away from zero, by frexp: an
    independent way to the bits split_tf32 makes."""
    m, e = np.frexp(np.abs(x.astype(np.float64)))
    q = np.floor(m * 2.0 ** 11 + 0.5) / 2.0 ** 11
    return (np.sign(x) * np.ldexp(q, e)).astype(np.float32)


@pytest.mark.parametrize("din", [64, 2560])
def test_split_tf32_three_products_meet_full_width_bound(din):
    """3xTF32 (small*W_big + big*W_small + big*W_big, each product of TF32
    values exact in float32, summed in float32) meets the full-width
    float32 bound against a float64 product; one TF32 product (big*W_big)
    does not.  The split matches an independent frexp rounding bit for
    bit, and both parts have TF32's 13 low bits zero."""
    rng = np.random.RandomState(din)
    x = rng.randn(32, din).astype(np.float32)
    w = (rng.randn(din, 64) / np.sqrt(din)).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    xb, xs = hl.split_tf32(tx)
    wb, ws = hl.split_tf32(tw)
    for big, small, v in ((xb, xs, tx), (wb, ws, tw)):
        np.testing.assert_array_equal(big.numpy(), _rna_numpy(v.numpy()))
        np.testing.assert_array_equal(small.numpy(),
                                      _rna_numpy((v - big).numpy()))
        for part in (big, small):
            assert not bool((part.view(torch.int32) & 0x1FFF).any())
    exact = x.astype(np.float64) @ w.astype(np.float64)
    atol = FULL_ATOL * (1 + np.abs(exact).max())

    def within(y):
        return bool((np.abs(y.numpy() - exact)
                     <= atol + FULL_RTOL * np.abs(exact)).all())

    three = xs @ wb + xb @ ws + xb @ wb
    assert within(three)
    assert not within(xb @ wb)


def test_variant_choice():
    """choose_variant: wgmma for aligned shapes and layouts, simt for a din
    not a multiple of 128 bytes (din * itemsize not a multiple of 16
    among them), dout not a multiple of 8, a misaligned or strided view, or
    more than 128 components a point; a forced wgmma on those raises on any
    device."""
    f32, bf16 = torch.float32, torch.bfloat16

    def stacked(K2, T, din, dout, dtype=f32):
        x = torch.zeros(K2, T, din, dtype=dtype)
        return [hl.stacked_group(x, torch.zeros(K2, T, dout, dtype=dtype))]

    def apply_groups(c, T, din, dout, dtype=f32, views=False):
        comps = [torch.zeros(T, din, dtype=dtype) for _ in range(2)]
        comps += [torch.zeros(T, din, c, dtype=dtype) for _ in range(2)]
        if views:
            comps[2] = torch.zeros(T, c, din, dtype=dtype).transpose(1, 2)
        outs = [torch.zeros(T, dout, dtype=dtype) for _ in range(2)]
        outs += [torch.zeros(T, dout, c, dtype=dtype) for _ in range(2)]
        return [hl._component_group(t, o) for t, o in zip(comps, outs)]

    cases = [
        (stacked(10, 8, 64, 16), 64, 16, f32, "wgmma"),
        (stacked(10, 8, 2560, 2560), 2560, 2560, f32, "wgmma"),
        (stacked(10, 8, 64, 64, bf16), 64, 64, bf16, "wgmma"),
        (stacked(10, 8, 32, 64, bf16), 32, 64, bf16, "simt"),   # 64 bytes
        (stacked(10, 8, 6, 16), 6, 16, f32, "simt"),            # 24 bytes
        (stacked(10, 8, 16, 16), 16, 16, f32, "simt"),          # 64 bytes
        (stacked(10, 8, 64, 12), 64, 12, f32, "simt"),          # dout % 8
        (apply_groups(4, 8, 64, 64), 64, 64, f32, "wgmma"),
        (apply_groups(3, 8, 64, 64, bf16), 64, 64, bf16, "wgmma"),
        (apply_groups(4, 8, 64, 64, views=True), 64, 64, f32, "simt"),
        (apply_groups(129, 2, 64, 8), 64, 8, f32, "simt"),      # cc > 128
        (apply_groups(128, 2, 64, 8), 64, 8, f32, "wgmma"),
    ]
    for groups, din, dout, dtype, want in cases:
        assert hl.choose_variant(groups, din, dout, dtype) == want, \
            ([tuple(g.inp.shape) for g in groups], din, dout, dtype)
    # a view one element off a 16-byte boundary
    buf = torch.zeros(1 + 4 * 8 * 64)
    x = buf[1:].view(4, 8, 64)
    y = torch.zeros(4, 8, 16)
    assert hl.choose_variant([hl.stacked_group(x, y)], 64, 16, f32) == "simt"
    assert hl.choose_variant([hl.stacked_group(buf[:-1].view(4, 8, 64), y)],
                             64, 16, f32) == "wgmma"
    # the normal forms the wgmma variant reads
    g = hl.tc_form(stacked(10, 8, 64, 16)[0], 64, 16)
    assert (g.ncomp, g.npoints) == (1, 80)
    g = hl.tc_form(apply_groups(4, 8, 64, 64)[2], 64, 64)
    assert (g.ncomp, g.npoints, g.in_strides) == (4, 8, (1, 256, 4))
    # forcing a variant
    xs, ws = torch.zeros(2, 4, 16), torch.zeros(16, 8)
    with pytest.raises(ValueError, match="wgmma"):
        hl.hdual_linear_cuda(xs, ws, variant="wgmma")
    with pytest.raises(ValueError, match="variant"):
        hl.hdual_linear_cuda(xs, ws, variant="tensor")
    assert hl.hdual_linear_cuda(xs, ws, variant="simt").shape == (2, 4, 8)


def test_apply_checks():
    rng = np.random.RandomState(2)
    _, hd = _hdual(rng, (8, 16), 2)
    w = torch.zeros(16, 4)
    bad = [(HDual(hd.val, hd.di[:4], hd.dj, hd.dij), w, ValueError),
           (HDual(hd.val, hd.di, hd.dj, hd.dij[..., :1]), w, ValueError),
           (HDual(hd.val.double(), hd.di, hd.dj, hd.dij), w, TypeError),
           (hd, torch.zeros(12, 4), ValueError),
           (hd, w.to("meta"), ValueError),
           (HDual(*(t[None] for t in (hd.val, hd.di, hd.dj, hd.dij))), w,
            ValueError)]
    for h, ww, err in bad:
        with pytest.raises(err):
            ops.hdual_linear_apply(h, ww)
    with pytest.raises(ValueError, match="divide"):
        ops.hdual_linear_apply(hd, w, bt=3)


def test_bf16_rounding_gap_to_pallas_bounded():
    """With bfloat16 x the Pallas kernel rounds its output block to bfloat16
    after every bk step (din = 256, bk = 64: four roundings of partial
    sums), the port once at the end.  Each rounding errs by at most half a
    bfloat16 unit, 2**-9 of the partial sum, so four of them stay within
    4 * 2**-9 of the largest partial sum; partial sums of these random
    products stay within twice the largest output, which gives
    8 * 2**-9 * (1 + max|want|) = 1.6e-2 * (1 + max|want|)."""
    rng = np.random.RandomState(256)
    x = rng.randn(4, 64, 256).astype(np.float32)
    w = (rng.randn(256, 64) / 16).astype(np.float32)
    want = _f32(hdual_linear_pallas(jnp.asarray(x, jnp.bfloat16),
                                    jnp.asarray(w, jnp.bfloat16), bt=64,
                                    bo=64, bk=64, interpret=True))
    got = _f32(ops.hdual_linear(torch.from_numpy(x).bfloat16(),
                                torch.from_numpy(w).bfloat16(), bt=64,
                                bo=64, bk=64))
    gap = np.abs(got - want).max()
    assert gap <= 8 * 2.0 ** -9 * (1 + np.abs(want).max()), gap
    assert gap > 0    # the two do round differently
