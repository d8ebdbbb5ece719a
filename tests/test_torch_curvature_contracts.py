"""repro_torch.core.curvature's own contracts, and the reference's
curvature tests ported as templates (tests/test_curvature.py,
tests/test_ggn_property.py, tests/test_optim.py:22-34):

  * block_hessian on both of its paths -- the hDual engine for an
    hmath-native f, the chunked forward-over-forward fallback otherwise --
    against the reference's block_hessian and torch.func.hessian
    (normalized error 1e-5; the LM case is the reference's, the reduced
    qwen1.5-4b's final_norm at float32 compute);
  * a seed draws one probe sequence, whatever the chunk size, and a probe
    budget p averages its first p probes;
  * GGN PSD, exact for linear models, Fisher == GGN at unit residuals,
    Hutchinson converging and exact for diagonal Hessians.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.hmath as jhm  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import curvature as jc  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.models.targets import lm_curvature_targets as jtargets  # noqa
import repro_torch.core.hmath as hm  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.convert import (batch_from_numpy,  # noqa: E402
                                 lm_params_from_numpy)
from repro_torch.core import curvature as tc  # noqa: E402
from repro_torch.models.targets import lm_curvature_targets  # noqa: E402

tree_leaves = torch.utils._pytree.tree_leaves
tree_map = torch.utils._pytree.tree_map
TOL = 1e-5


def _nerr(got, want):
    g = np.asarray(got, np.float64).ravel()
    w = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _torch_tree(jtree):
    return lm_params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")


def test_block_hessian_on_lm_norm_scale_both_paths():
    """The reference's own LM case (qwen1.5-4b, final_norm): its fallback
    against the port's, and the port's against torch.func.hessian."""
    jcfg = dataclasses.replace(jbase.get_config("qwen1.5-4b", reduced=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(base.get_config("qwen1.5-4b", reduced=True),
                              compute_dtype="float32")
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.RandomState(2).randint(0, 256, (1, 8)).astype(
        np.int32)
    jt = jtargets(jcfg, {"tokens": jnp.asarray(tokens)})
    tt = lm_curvature_targets(cfg, batch_from_numpy({"tokens": tokens},
                                                    "cpu"))
    tp = _torch_tree(jp)
    want = jc.block_hessian(jt.loss, jp, "final_norm", csize=32,
                            symmetric=True)
    assert not tc._hmath_native(lambda b: tt.loss(
        {**tp, "final_norm": b}), tp["final_norm"])
    got = tc.block_hessian(tt.loss, tp, "final_norm", csize=32,
                           symmetric=True)
    assert got.shape == (64, 64)
    assert _nerr(got, want) <= TOL
    oracle = torch.func.hessian(
        lambda b: tt.loss({**tp, "final_norm": b}))(tp["final_norm"])
    assert _nerr(got, oracle) <= TOL
    full = tc.block_hessian(tt.loss, tp, "final_norm", csize=32,
                            symmetric=False, hdual=False)
    assert _nerr(full, oracle) <= TOL


# ---------------------------------------------------------------------------
# the port's probe contract
# ---------------------------------------------------------------------------

def _quad():
    torch.manual_seed(0)
    R = torch.randn(6, 6, dtype=torch.float64).float()
    Q = R @ R.T + torch.eye(6)
    params = {"b": torch.linspace(-1.0, 1.0, 3), "x": torch.ones(6)}

    def f(t):
        return (0.5 * t["x"] @ Q @ t["x"] + (t["b"] ** 4).sum()
                + (t["x"][:3] * t["b"]).sum())

    return f, params


def test_seed_draws_one_sequence_and_budgets_take_its_prefix():
    f, params = _quad()
    r1 = tc.rademacher_like(7, params)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(r1), tree_leaves(tc.rademacher_like(7, params))))
    assert all(set(l.unique().tolist()) <= {-1.0, 1.0}
               for l in tree_leaves(r1))
    # the sequence: one generator, probe by probe, whatever the chunking
    gen = torch.Generator().manual_seed(11)
    seq = tc._stack([tc.rademacher_like(gen, params) for _ in range(8)])
    hvp_map = tc._hvp_map(f, params)
    for csize in (1, 2, 4, 8):
        got = tc.hutchinson_diag(f, params, 11, n_probes=8, csize=csize)
        want = tc._diag_from_probes(hvp_map, seq, csize)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    for p in (1, 3, 5, 8):
        got = tc.hutchinson_diag_budgeted(f, params, 11, p, n_probes=8,
                                          csize=4)
        prefix = tree_map(lambda l: l[:p], seq)
        want = tree_map(lambda v, hv: (v * hv).mean(0), prefix,
                        torch.func.vmap(hvp_map)(prefix))
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the reference's curvature tests, ported
# ---------------------------------------------------------------------------

def test_block_hessian_hmath_native():
    """An hmath-native objective runs the hDual engine (variables first,
    as core.api's schedules evaluate it)."""
    params = {"block": torch.tensor([0.3, -0.5, 1.2, 0.1]),
              "other": torch.tensor([2.0])}

    def f(p):
        x = p["block"]
        return hm.sum(hm.sin(x * p["other"][0]) * x, axis=0)

    assert tc._hmath_native(lambda b: f({**params, "block": b}),
                            params["block"])
    H = tc.block_hessian(f, params, "block", csize=2)
    H_hd = tc.block_hessian(f, params, "block", csize=2, hdual=True)
    H_ff = tc.block_hessian(f, params, "block", csize=2, hdual=False)
    H_ref = torch.func.hessian(
        lambda b: f({"block": b, "other": params["other"]}))(params["block"])
    jf = (lambda p: jhm.sum(jhm.sin(p["block"] * p["other"][0])
                            * p["block"]))
    jH = jc.block_hessian(jf, {"block": jnp.asarray([0.3, -0.5, 1.2, 0.1]),
                               "other": jnp.asarray([2.0])}, "block",
                          csize=2)
    for got in (H, H_hd, H_ff):
        torch.testing.assert_close(got, H_ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(jH), rtol=1e-5,
                                   atol=1e-6)
    assert torch.equal(H, H_hd)


def test_block_hessian_generic_fallback():
    """A torch-native objective (softmax xent head) takes the chunked
    forward-over-forward path with the same (row, chunk) schedule."""
    rng = np.random.RandomState(0)
    W, x = rng.randn(4, 3).astype(np.float32), rng.randn(4).astype(
        np.float32)
    params = {"W": torch.from_numpy(W), "logits_bias": torch.zeros(3)}

    def f(p):
        logits = torch.from_numpy(x) @ p["W"] + p["logits_bias"]
        return -torch.log_softmax(logits, -1)[1]

    assert not tc._hmath_native(
        lambda b: f({**params, "logits_bias": b}), params["logits_bias"])
    H = tc.block_hessian(f, params, "logits_bias", csize=2, symmetric=True)
    want = jc.block_hessian(
        lambda p: -jax.nn.log_softmax(x @ p["W"] + p["logits_bias"])[1],
        {"W": jnp.asarray(W), "logits_bias": jnp.zeros((3,))},
        "logits_bias", csize=2, symmetric=True)
    np.testing.assert_allclose(H.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # a 2-D block is flattened row-major
    HW = tc.block_hessian(f, params, "W", csize=4, symmetric=False)
    oracle = torch.func.hessian(lambda w: f({**params, "W": w}))(
        params["W"]).reshape(12, 12)
    torch.testing.assert_close(HW, oracle, rtol=1e-5, atol=1e-6)


def test_pytree_hvp_on_lm_loss_is_symmetric():
    """v^T (H w) == w^T (H v) on the reduced minitron-4b's loss at its own
    bfloat16 compute, on the reference test's inputs (its params, batch
    and directions), at its tolerance."""
    from repro.models.model import make_batch as jmake_batch
    jcfg = jbase.get_config("minitron-4b", reduced=True)
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    batch = jax.tree.map(np.asarray, jmake_batch(jcfg, 1, 8))
    tt = lm_curvature_targets(base.get_config("minitron-4b", reduced=True),
                              batch_from_numpy(batch, "cpu"))
    tp = _torch_tree(jp)
    tv = _torch_tree(jc.rademacher_like(jax.random.PRNGKey(1), jp))
    tw = _torch_tree(jc.rademacher_like(jax.random.PRNGKey(2), jp))
    hv = tc.pytree_hvp(tt.loss, tp, tv)
    hw = tc.pytree_hvp(tt.loss, tp, tw)
    assert all(torch.isfinite(l).all() for l in tree_leaves(hv))
    a = sum((x * y).sum() for x, y in zip(tree_leaves(tv), tree_leaves(hw)))
    b = sum((x * y).sum() for x, y in zip(tree_leaves(tw), tree_leaves(hv)))
    # the reference's tolerance for this bfloat16-compute case
    assert float(a) == pytest.approx(float(b), rel=2e-2, abs=2e-3)


def _net(seed, Bn=6, D=3, C=4):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn(Bn, D, generator=g)
    y = torch.randint(0, C, (Bn,), generator=g)
    params = {"u": 0.3 * torch.randn(C, C, generator=g),
              "w": 0.3 * torch.randn(D, C, generator=g)}

    def model_fn(t):
        return torch.tanh(X @ t["w"]) @ t["u"]

    def head(z):
        lf = z.float()
        return (torch.logsumexp(lf, -1)
                - torch.gather(lf, -1, y[:, None])[:, 0]).mean()

    return params, model_fn, head, X, y


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ggn_is_psd_and_exact_for_linear_models(seed):
    params, model_fn, head, X, y = _net(seed)
    v = tree_map(lambda l: torch.randn(l.shape, generator=torch.Generator()
                                       .manual_seed(seed + 100)), params)
    gv = tc.ggn_hvp(model_fn, head, params, v)
    vGv = sum(float((a * b).sum()) for a, b in zip(tree_leaves(v),
                                                   tree_leaves(gv)))
    vnorm = sum(float((a * a).sum()) for a in tree_leaves(v))
    assert vGv >= -1e-5 * vnorm
    lin = {"b": 0.1 * torch.ones(4), "w": params["w"]}

    def linear(t):
        return X @ t["w"] + t["b"]

    ones = tree_map(torch.ones_like, lin)
    g = tc.ggn_hvp(linear, head, lin, ones)
    h = tc.pytree_hvp(lambda t: head(linear(t)), lin, ones)
    for a, b in zip(tree_leaves(g), tree_leaves(h)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_fisher_equals_ggn_at_unit_residuals():
    g = torch.Generator().manual_seed(0)
    X = torch.randn(6, 3, generator=g)
    params0 = {"w": torch.randn(3, generator=g)}

    def z_of(t):
        return torch.tanh(X @ t["w"])

    y = z_of(params0) - 1.0                           # unit residuals

    def per_example(t):
        return 0.5 * (z_of(t) - y) ** 2

    def head(z):
        return (0.5 * (z - y) ** 2).mean()

    v = {"w": torch.linspace(-1.0, 1.0, 3)}
    torch.testing.assert_close(
        tc.empirical_fisher_vp(per_example, params0, v)["w"],
        tc.ggn_hvp(z_of, head, params0, v)["w"], rtol=1e-6, atol=1e-7)


def test_hutchinson_converges_and_is_exact_for_diagonal_hessians():
    torch.manual_seed(0)
    R = torch.randn(6, 6)
    Q = R @ R.T + torch.eye(6)
    exact = torch.diagonal(Q)
    errs = {}
    for P in (4, 16, 64):
        est = tc.hutchinson_diag(lambda x: 0.5 * x @ Q @ x, torch.zeros(6),
                                 1, n_probes=P, csize=4)
        errs[P] = float((est - exact).norm() / exact.norm())
    assert errs[64] < errs[4], errs
    c = 1.0 + torch.rand(5)
    for n_probes in (1, 2, 4):
        est = tc.hutchinson_diag(lambda x: 0.5 * (c * x * x).sum(),
                                 torch.ones(5), n_probes, n_probes=n_probes,
                                 csize=1)
        torch.testing.assert_close(est, c, rtol=1e-5, atol=1e-6)


def _quad_loss(params):
    x, y = params["x"], params["y"]
    return (2.0 * (x ** 2).sum() + 0.5 * (y ** 2).sum()
            + (x * torch.roll(x, 1)).sum() * 0.1)


def test_pytree_hvp_fwd_equals_fwdrev_and_diag_converges():
    params = {"x": torch.arange(4.0), "y": torch.ones(3)}
    v = {"x": torch.tensor([1.0, 0.0, 2.0, -1.0]),
         "y": torch.tensor([0.5, 0.0, 1.0])}
    hv = tc.pytree_hvp(_quad_loss, params, v)
    vhv = sum((a * b).sum() for a, b in zip(tree_leaves(v),
                                            tree_leaves(hv)))
    assert float(tc.pytree_hvp_fwd(_quad_loss, params, v)) == \
        pytest.approx(float(vhv), rel=1e-5)
    est = tc.hutchinson_diag(_quad_loss, {"x": torch.ones(4) * 0.3,
                                          "y": torch.ones(3) * -0.2},
                             0, n_probes=256, csize=8)
    np.testing.assert_allclose(est["x"].numpy(), 4.0, rtol=0.3)
    np.testing.assert_allclose(est["y"].numpy(), 1.0, rtol=0.3)


# the bfloat16 bound of two independent AD routes to one number, in units
# of the Cauchy-Schwarz scale ||x|| ||H y||: measured 6.8e-6 to 7.4e-5 on
# the three reduced dense configs (seeds 0-2); chip_smoke.py holds the
# full-width h2o-danube-1.8b to the same bound
BF16_ROUTES = 1e-3


def _dot(a, b):
    return sum(float((x.double() * y.double()).sum())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "qwen1.5-4b",
                                  "minitron-4b"])
def test_bfloat16_routes_agree_and_gauss_newton_is_psd(name):
    """At the configs' own bfloat16 compute: v.Hv from pytree_hvp against
    quadform's pure-forward v^T H v, w.Hv against v.Hw, and v.Gv, v.Fv
    non-negative."""
    from repro_torch.models.model import make_batch
    from repro_torch.models.params import init_params
    cfg = base.get_config(name, reduced=True)
    assert cfg.compute_dtype == "bfloat16"
    for seed in (0, 2):
        params = init_params(cfg, seed, device="cpu")
        tgt = lm_curvature_targets(cfg, make_batch(cfg, 2, 48, seed,
                                                   device="cpu"))
        v = tc.rademacher_like(10 + seed, params)
        w = tc.rademacher_like(20 + seed, params)
        hv = tc.pytree_hvp(tgt.loss, params, v)
        hw = tc.pytree_hvp(tgt.loss, params, w)
        scale = _dot(v, v) ** 0.5 * _dot(hv, hv) ** 0.5
        quad = float(tc.pytree_hvp_fwd(tgt.loss, params, v))
        assert abs(quad - _dot(v, hv)) <= BF16_ROUTES * scale
        assert abs(_dot(w, hv) - _dot(v, hw)) <= BF16_ROUTES * scale
        assert _dot(v, tc.ggn_hvp(tgt.model_fn, tgt.head_loss, params,
                                  v)) >= 0.0
        assert _dot(v, tc.empirical_fisher_vp(tgt.per_example_fn, params,
                                              v)) >= 0.0
