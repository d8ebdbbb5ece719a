"""The port's MoE block (repro_torch.models.moe) against the JAX package's
on the same numpy inputs, float32.

Cases: the reduced granite-moe-1b-a400m (E = 4, top-2) with T = 64
tokens, at the config's capacity factor 1.25 with a router scaled up so
that some experts overflow (drops happen, and the count is checked) and
at capacity factor 4.0 (no drops).  The router's gates, ids and aux loss,
the block's output and aux, and the gradients of <y, r> + aux with respect
to the tokens and every weight are held at normalized error 1e-5.  Then
the capacity expression against the reference's, and the block under
``torch.func``'s vmap of jvp of grad against JAX's HVP of the same
function (the curvature engine's composition).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = 1e-5
T = 64
NAMES = ("router", "w_down", "w_gate", "w_up")


def _nerr(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _cfgs(cf, name="granite-moe-1b-a400m"):
    return (dataclasses.replace(jbase.get_config(name, reduced=True),
                                capacity_factor=cf),
            dataclasses.replace(base.get_config(name, reduced=True),
                                capacity_factor=cf))


def _inputs(cfg, seed, router_scale=1.0):
    rs = np.random.RandomState(seed)
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {"router": rs.randn(d, E) * router_scale / np.sqrt(d),
         "w_down": rs.randn(E, ff, d) / np.sqrt(ff),
         "w_gate": rs.randn(E, d, ff) / np.sqrt(d),
         "w_up": rs.randn(E, d, ff) / np.sqrt(d)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return (rs.randn(T, d).astype(np.float32), p,
            rs.randn(T, d).astype(np.float32))


def test_router_topk_matches_reference():
    jcfg, _ = _cfgs(1.25)
    x, p, _ = _inputs(jcfg, 0)
    jg, ji, ja = jmoe.router_topk(jnp.asarray(x), jnp.asarray(p["router"]),
                                  jcfg.experts_per_token)
    g, i, a = moe.router_topk(torch.as_tensor(x),
                              torch.as_tensor(p["router"]),
                              jcfg.experts_per_token)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert g.dtype == torch.float32
    assert _nerr(g, jg) <= TOL and abs(float(a) - float(ja)) <= TOL


@pytest.mark.parametrize("cf,router_scale,drops", [(1.25, 8.0, True),
                                                   (4.0, 1.0, False)])
def test_moe_block_outputs_and_grads_match_reference(cf, router_scale,
                                                     drops):
    jcfg, cfg = _cfgs(cf)
    x, p, r = _inputs(cfg, 1, router_scale)

    def jobj(xx, pp):
        y, aux = jmoe.moe_block(xx, pp, jcfg)
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (jy, jaux)), (jgx, jgp) = jax.value_and_grad(
        jobj, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})

    tx = torch.as_tensor(x).requires_grad_()
    tp = {k: torch.as_tensor(v).requires_grad_() for k, v in p.items()}
    with moe.record_drops() as seen:
        y, aux = moe.moe_block(tx, tp, cfg)
    (torch.sum(y * torch.as_tensor(r)) + aux).backward()

    dropped = sum(int(n) for n, _ in seen)
    assert len(seen) == 1 and seen[0][1] == T * cfg.experts_per_token
    assert (dropped > 0) == drops, dropped
    assert _nerr(y.detach(), jy) <= TOL
    assert abs(aux.item() - float(jaux)) <= TOL * abs(float(jaux))
    assert _nerr(tx.grad, jgx) <= TOL
    for k in NAMES:
        assert _nerr(tp[k].grad, jgp[k]) <= TOL, k


def test_capacity_equals_reference_expression():
    for cf in (1.0, 1.25, 4.0, 0.3):
        for E, k in ((4, 2), (32, 8), (40, 8), (5, 2)):
            cfg = dataclasses.replace(base.get_config(
                "granite-moe-1b-a400m", reduced=True), capacity_factor=cf,
                num_experts=E, experts_per_token=k)
            for t in (1, 8, 17, 1024, 8320):
                C = int(t * k / E * cf)
                assert moe.capacity(t, cfg) == max(8, -(-C // 8) * 8)


def test_moe_block_hvp_under_torch_func_matches_reference():
    """vmap over two tangents of jvp of grad (the curvature engine's
    composition) through the dispatch's out-of-place scatters, against
    JAX's forward-over-reverse HVP, with drops."""
    jcfg, cfg = _cfgs(1.25)
    x, p, r = _inputs(cfg, 2, 8.0)
    rs = np.random.RandomState(3)
    vs = [{k: rs.randn(*v.shape).astype(np.float32) for k, v in p.items()}
          for _ in range(2)]

    def jloss(pp):
        y, aux = jmoe.moe_block(jnp.asarray(x), pp, jcfg)
        return jnp.sum(y * r) + aux

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want = [jax.jvp(jax.grad(jloss), (jp,), (
        {k: jnp.asarray(a) for k, a in v.items()},))[1] for v in vs]

    def loss(pp):
        y, aux = moe.moe_block(torch.as_tensor(x), pp, cfg)
        return torch.sum(y * torch.as_tensor(r)) + aux

    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    tv = {k: torch.stack([torch.as_tensor(v[k]) for v in vs]) for k in p}
    got = torch.func.vmap(lambda v: torch.func.jvp(
        torch.func.grad(loss), (tp,), (v,))[1])(tv)
    for i in range(2):
        for k in NAMES:
            assert _nerr(got[k][i], want[i][k]) <= TOL, (i, k)
