"""The port's Mamba-2 SSD block (repro_torch.models.ssm) against the JAX
package's on the same numpy inputs, float32.

  * ``_conv1d_causal`` with and without a streaming state: outputs and the
    new state at 1e-5;
  * ``ssd_chunked`` at 1e-5 of the reference's, and (the reference's own
    test, tests/test_models.py) at 2e-3 of the token-by-token
    ``ssd_scan_ref``, with the state handed off at S/2; lengths that are
    not a multiple of the chunk are refused;
  * ``_segsum`` masks to -inf before the exp, so a second derivative
    through the block is finite;
  * ``ssm_forward`` (with a prefill state handed in) and
    ``ssm_decode_step`` on a layer of the reduced mamba2-2.7b at 1e-5,
    outputs and every state leaf.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = 1e-5
REF_TOL = 2e-3


def _nerr(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _t(a):
    return torch.as_tensor(np.array(a))


def _ssd_inputs(seed, B, S, H, P, N):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, S, H, P).astype(np.float32),
            rs.uniform(0.001, 0.1, (B, S, H)).astype(np.float32),
            -rs.uniform(0.5, 2.0, (H,)).astype(np.float32),
            rs.randn(B, S, N).astype(np.float32),
            rs.randn(B, S, N).astype(np.float32))


@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_causal_matches_reference(with_state):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 7, 12).astype(np.float32)
    kern = rs.randn(4, 12).astype(np.float32)
    st = rs.randn(2, 3, 12).astype(np.float32) if with_state else None
    jy, jst = jssm._conv1d_causal(jnp.asarray(x), jnp.asarray(kern),
                                  None if st is None else jnp.asarray(st))
    y, new = ssm._conv1d_causal(_t(x), _t(kern),
                                None if st is None else _t(st))
    assert _nerr(y, jy) <= TOL
    np.testing.assert_array_equal(new.numpy(), np.asarray(jst))


@pytest.mark.parametrize("S", [64, 256])
def test_ssd_chunked_matches_reference_and_recurrence(S):
    xh, dt, A, Bm, Cm = _ssd_inputs(1, 2, S, 4, 8, 16)
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bm, Cm)))
    y, h = ssm.ssd_chunked(*map(_t, (xh, dt, A, Bm, Cm)))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert _nerr(y, jy) <= TOL and _nerr(h, jh) <= TOL
    ry, rh = ssm.ssd_scan_ref(*map(_t, (xh, dt, A, Bm, Cm)))
    jry, jrh = jssm.ssd_scan_ref(*map(jnp.asarray, (xh, dt, A, Bm, Cm)))
    assert _nerr(ry, jry) <= TOL and _nerr(rh, jrh) <= TOL
    np.testing.assert_allclose(y.numpy(), ry.numpy(), rtol=REF_TOL,
                               atol=REF_TOL)
    np.testing.assert_allclose(h.numpy(), rh.numpy(), rtol=REF_TOL,
                               atol=REF_TOL)


def test_ssd_chunked_initial_state_handoff():
    xh, dt, A, Bm, Cm = map(_t, _ssd_inputs(2, 1, 256, 2, 4, 8))
    y_full, h_full = ssm.ssd_chunked(xh, dt, A, Bm, Cm)
    mid = 128
    y1, h1 = ssm.ssd_chunked(xh[:, :mid], dt[:, :mid], A, Bm[:, :mid],
                             Cm[:, :mid])
    y2, h2 = ssm.ssd_chunked(xh[:, mid:], dt[:, mid:], A, Bm[:, mid:],
                             Cm[:, mid:], init_state=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), rtol=REF_TOL, atol=REF_TOL)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), rtol=REF_TOL,
                               atol=REF_TOL)
    jy, jh = jssm.ssd_chunked(*(jnp.asarray(a[:, mid:].numpy())
                                for a in (xh, dt)), jnp.asarray(A.numpy()),
                              *(jnp.asarray(a[:, mid:].numpy())
                                for a in (Bm, Cm)),
                              init_state=jnp.asarray(h1.numpy()))
    assert _nerr(y2, jy) <= TOL and _nerr(h2, jh) <= TOL


def test_ssd_refuses_a_length_off_the_chunk():
    xh, dt, A, Bm, Cm = map(_t, _ssd_inputs(3, 1, 200, 2, 4, 8))
    with pytest.raises(ValueError, match="chunk"):
        ssm.ssd_chunked(xh, dt, A, Bm, Cm)


def test_segsum_masks_before_exp_so_the_hvp_is_finite():
    dA = -torch.rand(2, 8, dtype=torch.float64)
    L = ssm._segsum(dA)
    upper = torch.triu(torch.ones(8, 8, dtype=torch.bool), 1)
    assert torch.isneginf(L[:, upper]).all()
    assert torch.isfinite(L[:, ~upper]).all()

    def f(a):
        return torch.exp(ssm._segsum(a)).sum()

    v = torch.randn_like(dA)
    hv = torch.func.jvp(torch.func.grad(f), (dA,), (v,))[1]
    assert torch.isfinite(hv).all()


def _layer(cfg, jp):
    """Layer 0 of the reference's stacked ssm params, in both packages."""
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["ssm"])
    return jl, {k: _t(v) for k, v in jl.items()}


@pytest.fixture(scope="module")
def mamba():
    name = "mamba2-2.7b"
    jcfg = dataclasses.replace(jbase.get_config(name, reduced=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(base.get_config(name, reduced=True),
                              compute_dtype="float32")
    jp = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, _layer(cfg, jp)


def _leafwise(got, want):
    assert list(got) == sorted(want)
    for k in want:
        assert got[k].shape == tuple(np.shape(want[k])), k
        assert _nerr(got[k], want[k]) <= TOL, k


def test_ssm_forward_and_decode_step_match_reference(mamba):
    jcfg, cfg, (jl, tl) = mamba
    rs = np.random.RandomState(4)
    x = rs.randn(2, 16, cfg.d_model).astype(np.float32)
    # a prefill from a non-zero state: SSM and conv states handed in
    st = {"conv_B": rs.randn(2, 3, cfg.ssm_state),
          "conv_C": rs.randn(2, 3, cfg.ssm_state),
          "conv_x": rs.randn(2, 3, cfg.d_inner),
          "ssm": rs.randn(2, cfg.ssm_heads, cfg.ssm_head_dim,
                          cfg.ssm_state)}
    st = {k: v.astype(np.float32) for k, v in st.items()}
    conv = {"x": "conv_x", "B": "conv_B", "C": "conv_C"}
    jy, (jh, jcs) = jssm.ssm_forward(
        jnp.asarray(x), jl, jcfg, jnp.asarray(st["ssm"]),
        {k: jnp.asarray(st[v]) for k, v in conv.items()})
    y, (h, cs) = ssm.ssm_forward(_t(x), tl, cfg, _t(st["ssm"]),
                                 {k: _t(st[v]) for k, v in conv.items()})
    assert _nerr(y, jy) <= TOL and _nerr(h, jh) <= TOL
    for k in conv:
        np.testing.assert_allclose(cs[k].numpy(), np.asarray(jcs[k]),
                                   rtol=1e-6, atol=1e-6)

    state = ssm.init_ssm_state(cfg, 2, torch.float32, device="cpu")
    jstate = jssm.init_ssm_state(jcfg, 2, jnp.float32)
    assert list(state) == sorted(jstate)
    for k in jstate:
        assert state[k].shape == jstate[k].shape, k
        assert str(state[k].dtype)[6:] == str(jstate[k].dtype), k
    state = {k: _t(v) for k, v in st.items()}
    jstate = {k: jnp.asarray(v) for k, v in st.items()}
    for t in range(3):
        x1 = rs.randn(2, 1, cfg.d_model).astype(np.float32)
        jy, jstate = jssm.ssm_decode_step(jnp.asarray(x1), jl, jcfg, jstate)
        y, state = ssm.ssm_decode_step(_t(x1), tl, cfg, state)
        assert _nerr(y, jy) <= TOL, t
        _leafwise(state, {k: np.asarray(v) for k, v in jstate.items()})
