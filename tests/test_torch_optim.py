"""repro_torch.optim against the JAX reference (tests/test_optim.py is the
template): schedules and clipping within 1e-7, AdamW over 3 steps within
1e-6, SophiaH on a loss with a diagonal Hessian (Rademacher Hutchinson is
exact there, so the whole update matches whatever the probes) within
1e-6, the hess_every gate and the hess_batch_frac slice, and the
reference's descent tests."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import clip_by_global_norm as jclip  # noqa: E402
from repro.optim import sophia_h as jsophia  # noqa: E402
from repro.optim.schedule import constant as jconstant  # noqa: E402
from repro.optim.schedule import warmup_cosine as jwarmup  # noqa: E402
from repro_torch.optim import (adamw, clip_by_global_norm,  # noqa: E402
                               global_norm, sophia_h)
from repro_torch.optim.optimizers import probe_seed  # noqa: E402
from repro_torch.optim.schedule import constant, warmup_cosine  # noqa: E402

tree_map = torch.utils._pytree.tree_map
TOL = dict(rtol=1e-6, atol=1e-6)


def _np_tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {"x": (rng.randn(4) * scale).astype(np.float32),
            "y": (rng.randn(3) * scale).astype(np.float32)}


def _t(tree):
    return tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, **tol):
    for k in want:
        if isinstance(want[k], dict):
            _close(got[k], want[k], **tol)
        else:
            np.testing.assert_allclose(np.asarray(got[k]),
                                       np.asarray(want[k]), **(tol or TOL))


def quad_loss(params):
    """Convex quadratic with a known Hessian diagonal (x stiffer than y)."""
    x, y = params["x"], params["y"]
    return (2.0 * (x ** 2).sum() + 0.5 * (y ** 2).sum()
            + (x * torch.roll(x, 1)).sum() * 0.1)


def sep_loss(params):
    """Separable, so its Hessian is diagonal: 2 * 1.5 on x, 3 y^2 on y."""
    return 1.5 * (params["x"] ** 2).sum() + 0.25 * (params["y"] ** 4).sum()


def jsep_loss(params):
    return 1.5 * (params["x"] ** 2).sum() + 0.25 * (params["y"] ** 4).sum()


# ---------------------------------------------------------------------------
# schedules and clipping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(1.0, 10, 100), (3e-4, 1, 4),
                                  (2.5, 7, 50, 0.2)])
def test_warmup_cosine_equals_reference(args):
    """Within 1e-7 of base_lr: one float32 rounding of the cosine."""
    got = warmup_cosine(*args)
    want = jwarmup(*args)
    for step in range(0, 120):
        lr = got(step)
        assert lr.dtype == torch.float32 and lr.dim() == 0
        assert abs(float(lr) - float(want(step))) <= 1e-7 * args[0]
    # a 0-d int64 step tensor gives the same value
    assert float(got(torch.tensor(5))) == float(got(5))


def test_constant_equals_reference():
    for step in (0, 3, torch.tensor(7)):
        lr = constant(0.05)(step)
        assert lr.dtype == torch.float32 and lr.dim() == 0
        assert float(lr) == float(jconstant(0.05)(int(step)))


@pytest.mark.parametrize("scale,max_norm", [(3.0, 1.0), (0.01, 1.0)])
def test_clip_by_global_norm_equals_reference(scale, max_norm):
    tree = _np_tree(0, scale)
    got, gnorm = clip_by_global_norm(_t(tree), max_norm)
    want, wnorm = jclip(_j(tree), max_norm)
    np.testing.assert_allclose(float(gnorm), float(wnorm), rtol=1e-7)
    _close(got, want, rtol=1e-7, atol=1e-7)


def test_clip_by_global_norm():
    tree = {"a": torch.ones(10) * 3.0}
    clipped, norm = clip_by_global_norm(tree, 1.0)
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)
    np.testing.assert_allclose(float(norm), np.sqrt(90.0), rtol=1e-5)
    assert float(tree["a"][0]) == 3.0          # the input is not changed


def test_warmup_cosine_shape():
    lr = warmup_cosine(1.0, 10, 100, min_ratio=0.1)
    assert float(lr(0)) == 0.0
    np.testing.assert_allclose(float(lr(10)), 1.0, rtol=1e-5)
    assert float(lr(100)) == pytest.approx(0.1, rel=1e-3)
    assert float(lr(55)) < float(lr(20))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_adamw_three_steps_equal_reference():
    """The same params and the same gradients, 3 steps, clipping on."""
    params = _np_tree(1)
    grads = [_np_tree(10 + k, scale=2.0 - k) for k in range(3)]
    lr = (warmup_cosine(0.1, 1, 3), jwarmup(0.1, 1, 3))
    opt, jopt = adamw(lr[0]), jadamw(lr[1])
    p, jp = _t(params), _j(params)
    s, js = opt.init(p), jopt.init(jp)
    for k in range(3):
        p_in = p
        p, s, st = opt.update(_t(grads[k]), s, p, torch.tensor(k))
        jp, js, jst = jopt.update(_j(grads[k]), js, jp, jnp.asarray(k))
        assert p is p_in                         # written in place
        np.testing.assert_allclose(float(st["grad_norm"]),
                                   float(jst["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(st["lr"]), float(jst["lr"]),
                                   rtol=1e-7)
        _close(p, jp)
        _close(s, js)


def test_adamw_descends():
    opt = adamw(constant(0.05), weight_decay=0.0)
    params = {"x": torch.ones(4) * 2.0, "y": torch.ones(3)}
    state = opt.init(params)
    loss0 = float(quad_loss(params))
    for step in range(50):
        g = torch.func.grad(quad_loss)(params)
        params, state, _ = opt.update(g, state, params, torch.tensor(step))
    assert float(quad_loss(params)) < 0.05 * loss0


# ---------------------------------------------------------------------------
# SophiaH
# ---------------------------------------------------------------------------

def _sophia_pair(**kw):
    lr = (constant(0.05), jconstant(0.05))
    return sophia_h(lr[0], **kw), jsophia(lr[1], **kw)


def test_sophia_diagonal_hessian_update_equals_reference():
    """Rademacher Hutchinson is exact on a diagonal Hessian (v * Hv =
    diag(H) v^2 = diag(H)), so 3 steps with two estimates match the
    reference's whatever the probes."""
    opt, jopt = _sophia_pair(hess_every=2, n_probes=4, csize=2, rho=0.1)
    params = _np_tree(2)
    p, jp = _t(params), _j(params)
    s, js = opt.init(p), jopt.init(jp)
    for k in range(3):
        g = torch.func.grad(sep_loss)(p)
        jg = jax.grad(jsep_loss)(jp)
        p, s, st = opt.update(g, s, p, torch.tensor(k),
                              loss_fn=lambda q, b: sep_loss(q), batch=None,
                              rng=7)
        jp, js, jst = jopt.update(jg, js, jp, jnp.asarray(k),
                                  loss_fn=lambda q, b: jsep_loss(q),
                                  batch=None, rng=jax.random.PRNGKey(k))
        np.testing.assert_allclose(float(st["grad_norm"]),
                                   float(jst["grad_norm"]), rtol=1e-6)
        _close(p, jp)
        _close(s, js)
    # the gradients were consumed: their storage is released
    assert all(t.numel() == 0 for t in torch.utils._pytree.tree_leaves(g))


def test_sophia_hess_every_gates_the_estimate():
    opt, jopt = _sophia_pair(hess_every=2, n_probes=2, csize=1)
    p, jp = _t(_np_tree(3)), _j(_np_tree(3))
    s, js = opt.init(p), jopt.init(jp)
    hs = []
    for k in range(3):
        g = torch.func.grad(sep_loss)(p)
        p, s, _ = opt.update(g, s, p, k, loss_fn=lambda q, b: sep_loss(q),
                             rng=0)
        jp, js, _ = jopt.update(jax.grad(jsep_loss)(jp), js, jp,
                                jnp.asarray(k),
                                loss_fn=lambda q, b: jsep_loss(q),
                                rng=jax.random.PRNGKey(k))
        hs.append({k2: v.clone() for k2, v in s["h"].items()})
        _close(s["h"], js["h"])
    # estimated at steps 0 and 2 only
    for k2 in hs[0]:
        assert torch.equal(hs[1][k2], hs[0][k2])
        assert not torch.equal(hs[2][k2], hs[0][k2])


@pytest.mark.parametrize("B,frac,rows", [(4, 0.5, 2), (3, 0.5, 1),
                                         (1, 0.25, 1), (4, 1.0, 4)])
def test_sophia_hess_batch_frac_slices_the_batch(B, frac, rows):
    """The estimate sees the leading max(1, int(B * frac)) rows: on
    loss(p, b) = sum(b.sum(0) * x^2) the diag is exactly 2 * b.sum(0)."""
    rng = np.random.RandomState(B)
    batch = np.abs(rng.randn(B, 4)).astype(np.float32) + 0.5
    seen = []

    def loss(q, b):
        seen.append(b.shape[0])
        return (b.sum(0) * q["x"] ** 2).sum()

    def jloss(q, b):
        return (b.sum(0) * q["x"] ** 2).sum()

    opt, jopt = _sophia_pair(hess_every=1, n_probes=2, csize=2,
                             hess_batch_frac=frac, b2=0.5)
    p = {"x": torch.ones(4)}
    jp = {"x": jnp.ones(4)}
    s, js = opt.init(p), jopt.init(jp)
    g = {"x": torch.zeros(4)}
    _, s, _ = opt.update(g, s, p, 0, loss_fn=loss, batch=torch.tensor(batch),
                         rng=1)
    _, js, _ = jopt.update({"x": jnp.zeros(4)}, js, jp, jnp.asarray(0),
                           loss_fn=jloss, batch=jnp.asarray(batch),
                           rng=jax.random.PRNGKey(0))
    assert set(seen) == {rows}
    np.testing.assert_allclose(s["h"]["x"].numpy(),
                               0.5 * 2 * batch[:rows].sum(0), rtol=1e-6)
    _close(s, js)


def test_sophia_probe_seed_is_a_function_of_seed_and_step():
    assert probe_seed(5, 7) == probe_seed(5, torch.tensor(7))
    assert probe_seed(5, 7) != probe_seed(5, 8)
    assert probe_seed(5, 7) != probe_seed(6, 7)
    assert 0 <= probe_seed(2 ** 62, 3) < 2 ** 63
    with pytest.raises(ValueError, match="csize"):
        opt = sophia_h(constant(0.1), hess_every=1, n_probes=4, csize=3)
        p = {"x": torch.ones(2)}
        opt.update({"x": torch.ones(2)}, opt.init(p), p, 0,
                   loss_fn=lambda q, b: (q["x"] ** 2).sum(), rng=0)


def test_sophia_descends_and_scales_by_curvature():
    opt = sophia_h(constant(0.05), weight_decay=0.0, hess_every=1,
                   n_probes=4, csize=2, rho=0.1)
    params = {"x": torch.ones(4) * 2.0, "y": torch.ones(3)}
    state = opt.init(params)
    loss0 = float(quad_loss(params))
    for step in range(50):
        g = torch.func.grad(quad_loss)(params)
        params, state, _ = opt.update(
            g, state, params, torch.tensor(step),
            loss_fn=lambda p, b: quad_loss(p), batch=None, rng=step)
    assert float(quad_loss(params)) < 0.1 * loss0
    # curvature state reflects the known diagonal ordering (x stiffer)
    assert float(state["h"]["x"].mean()) > float(state["h"]["y"].mean())
