"""repro_torch.core.curvature against repro.core.curvature on the same
numpy inputs: JAX's params of the reduced h2o-danube-1.8b (window 32, run
at S = 48 so the window bites), qwen1.5-4b and minitron-4b, converted with
``lm_params_from_numpy``, tokens from a numpy seed, float32 compute.

Every product is held at normalized error 1e-5 (measured: about 4e-7);
the Hutchinson / GGN diagonals take JAX's own Rademacher draws, reproduced
from the reference's key splits, through ``_diag_from_probes``.  Then the
port's own contracts: a seed draws one probe sequence on one device, a
budget averages its first p probes, and at p == n_probes the budgeted
estimate is bitwise the unbudgeted one.  block_hessian, the probe
sequence and the reference's own curvature tests are in
tests/test_torch_curvature_contracts.py.
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
N_PROBES, CSIZE = 4, 2
_CASES: dict = {}


def _flat(tree):
    if isinstance(tree, (dict, torch.Tensor)) and all(
            isinstance(l, torch.Tensor) for l in tree_leaves(tree)):
        return np.concatenate([l.detach().double().numpy().ravel()
                               for l in tree_leaves(tree)])
    return np.concatenate([np.asarray(l, np.float64).ravel()
                           for l in jax.tree.leaves(tree)])


def _nerr(got, want):
    g, w = _flat(got), _flat(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _torch_tree(jtree):
    return lm_params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")


def _case(name="h2o-danube-1.8b", S=48):
    """Both packages' targets and JAX's params (float32 compute), and two
    Rademacher directions v, w drawn with numpy from a seed."""
    if name not in _CASES:
        jcfg = dataclasses.replace(jbase.get_config(name, reduced=True),
                                   compute_dtype="float32")
        cfg = dataclasses.replace(base.get_config(name, reduced=True),
                                  compute_dtype="float32")
        jp = jinit(jcfg, jax.random.PRNGKey(0))
        tokens = np.random.RandomState(1).randint(
            0, jcfg.vocab_size, (2, S)).astype(np.int32)
        jt = jtargets(jcfg, {"tokens": jnp.asarray(tokens)})
        tt = lm_curvature_targets(cfg, batch_from_numpy({"tokens": tokens},
                                                        "cpu"))
        rs = np.random.RandomState(2)
        jv, jw = (jax.tree.map(lambda l: jnp.asarray(
            rs.choice([-1.0, 1.0], size=l.shape).astype(np.float32)), jp)
            for _ in range(2))
        _CASES[name] = (jt, jp, jv, jw, tt, _torch_tree(jp),
                        _torch_tree(jv), _torch_tree(jw))
    return _CASES[name]


def _jax_probes(key, params, n_probes, csize):
    """The reference's probe sequence for ``key``, stacked (n_probes, ...):
    the chunk keys split from key, the probe keys from each chunk key
    (src/repro/core/curvature.py:68-95)."""
    probes = [jc.rademacher_like(k, params)
              for kc in jax.random.split(key, n_probes // csize)
              for k in jax.random.split(kc, csize)]
    return jax.tree.map(lambda *l: np.stack([np.asarray(x) for x in l]),
                        *probes)


# ---------------------------------------------------------------------------
# the products against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,S", [("h2o-danube-1.8b", 48),
                                    ("qwen1.5-4b", 16),
                                    ("minitron-4b", 16)])
def test_pytree_hvp_matches_reference(name, S):
    jt, jp, jv, _, tt, tp, tv, _ = _case(name, S)
    want = jax.jit(lambda a, v: jc.pytree_hvp(jt.loss, a, v))(jp, jv)
    got = tc.pytree_hvp(tt.loss, tp, tv)
    assert list(got) == sorted(got)
    assert _nerr(got, want) <= TOL


def test_quadform_ggn_and_fisher_match_reference():
    jt, jp, jv, jw, tt, tp, tv, tw = _case()
    want = float(jax.jit(lambda a, v, w: jc.pytree_hvp_fwd(
        jt.loss, a, v, w))(jp, jv, jw))
    got = float(tc.pytree_hvp_fwd(tt.loss, tp, tv, tw))
    assert abs(got - want) <= TOL * abs(want)
    assert float(tc.pytree_hvp_fwd(tt.loss, tp, tv)) == pytest.approx(
        float(tc.pytree_hvp_fwd(tt.loss, tp, tv, tv)), rel=1e-6)
    want = jax.jit(lambda a, v: jc.ggn_hvp(jt.model_fn, jt.head_loss, a,
                                           v))(jp, jv)
    assert _nerr(tc.ggn_hvp(tt.model_fn, tt.head_loss, tp, tv),
                 want) <= TOL
    want = jax.jit(lambda a, v: jc.empirical_fisher_vp(
        jt.per_example_fn, a, v))(jp, jv)
    assert _nerr(tc.empirical_fisher_vp(tt.per_example_fn, tp, tv),
                 want) <= TOL


def test_diagonals_on_the_reference_probes():
    """hutchinson_diag, ggn_diag and both budgeted forms at every budget,
    on JAX's own draws for the same key.  The reference's budgeted form at
    p == n_probes is its unbudgeted estimate bitwise (its own contract), so
    one compiled program per estimator serves both comparisons."""
    jt, jp, _, _, tt, tp, _, _ = _case()
    key = jax.random.PRNGKey(5)
    probes = _torch_tree(_jax_probes(key, jp, N_PROBES, CSIZE))
    hvp_map = tc._hvp_map(tt.loss, tp)
    gvp_map = tc._gvp_map(tt.model_fn, tt.head_loss, tp)
    hb = jax.jit(lambda a, p: jc.hutchinson_diag_budgeted(
        jt.loss, a, key, p, N_PROBES, CSIZE))
    gb = jax.jit(lambda a, p: jc.ggn_diag_budgeted(
        jt.model_fn, jt.head_loss, a, key, p, N_PROBES, CSIZE))
    assert _nerr(tc._diag_from_probes(hvp_map, probes, CSIZE),
                 hb(jp, N_PROBES)) <= TOL
    assert _nerr(tc._diag_from_probes(gvp_map, probes, CSIZE),
                 gb(jp, N_PROBES)) <= TOL
    for p in range(1, N_PROBES + 1):
        assert _nerr(tc._diag_from_probes(hvp_map, probes, CSIZE, p),
                     hb(jp, p)) <= TOL
        assert _nerr(tc._diag_from_probes(gvp_map, probes, CSIZE, p),
                     gb(jp, p)) <= TOL


def test_budget_at_n_probes_is_bitwise_the_diag():
    _, _, _, _, tt, tp, _, _ = _case()
    for csize in (1, 2):
        d = tc.hutchinson_diag(tt.loss, tp, 3, N_PROBES, csize)
        b = tc.hutchinson_diag_budgeted(tt.loss, tp, 3, N_PROBES,
                                        N_PROBES, csize)
        bt = tc.hutchinson_diag_budgeted(tt.loss, tp, 3,
                                         torch.tensor(N_PROBES),
                                         N_PROBES, csize)
        for x, y, z in zip(tree_leaves(d), tree_leaves(b), tree_leaves(bt)):
            assert torch.equal(x, y) and torch.equal(x, z)
    g = tc.ggn_diag(tt.model_fn, tt.head_loss, tp, 4, N_PROBES, CSIZE)
    gb = tc.ggn_diag_budgeted(tt.model_fn, tt.head_loss, tp, 4, N_PROBES,
                              N_PROBES, CSIZE)
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(g), tree_leaves(gb)))
    with pytest.raises(ValueError, match="csize"):
        tc.hutchinson_diag(tt.loss, tp, 3, n_probes=4, csize=3)
