"""Pytree plans and pytree service queues of the port (ROADMAP A.4), with
the reference's own tests as templates (tests/test_engine.py:318-341,
tests/test_service.py:341-460, tests/test_online_tune.py:316-406) and the
dense rows of tests/test_zoo_conformance.py:

  * ``plan(f, None)`` serves hvp, diag, ggn, fisher and quadform on the
    pytree backends, and matches the JAX engine on the same inputs;
  * a params tree on another device than the plan's raises;
  * pytree HVP submits coalesce per tree structure, diag submits carry a
    seed row and a probe budget each, and mixed budgets share one bucket
    whose full-budget rows are bitwise ``plan.diag``;
  * every dense zoo config plans and executes hvp, diag, ggn and fisher at
    the reference's 1e-6 normalized error against the direct curvature
    functions, with zero rebuilds on re-planning.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro.core import testfns as jtestfns  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import curvature as tc  # noqa: E402
from repro_torch.core import testfns  # noqa: E402
from repro_torch.engine.service import CurvatureService  # noqa: E402
from repro_torch.models.model import make_batch  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.models.targets import (diag_spectrum,  # noqa: E402
                                        lm_curvature_targets)

tree_leaves = torch.utils._pytree.tree_leaves
tree_map = torch.utils._pytree.tree_map
N = 6


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    engine.clear_autotune_cache()
    engine.clear_telemetry()
    yield
    engine.clear_autotune_cache()
    engine.clear_telemetry()


def _tree_obj(t):
    """Generic pytree objective: any dict-of-tensors structure."""
    sq = sum((l ** 2).sum() for l in tree_leaves(t))
    return 0.25 * sq * sq + sum(torch.cos(l).sum() for l in tree_leaves(t))


def _tree_point(i):
    return {"b": np.full((4,), 0.5 + 0.05 * i, np.float32),
            "w": np.arange(6, dtype=np.float32).reshape(3, 2) / 7 + 0.1 * i}


def _ones(tree):
    return tree_map(np.ones_like, tree)


def _close(got, want, rtol=1e-5, atol=1e-5):
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=atol)


def _equal(got, want):
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---------------------------------------------------------------------------
# plans (tests/test_engine.py:318-341)
# ---------------------------------------------------------------------------

def test_pytree_backend_hvp_and_quadform_match_the_jax_engine():
    rs = np.random.RandomState(5)
    a = rs.uniform(-2, 2, N).astype(np.float32)
    v = rs.randn(N).astype(np.float32)
    want = np.asarray(jengine.plan(jtestfns.rosenbrock, None,
                                   backend="pytree_fwdrev").hvp(a, v))
    p = engine.plan(testfns.rosenbrock, None, backend="pytree_fwdrev",
                    device="cpu")
    np.testing.assert_allclose(p.hvp(a, v).numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(p.execute(a, v).numpy(), want, rtol=1e-5,
                               atol=1e-5)
    q = engine.plan(testfns.rosenbrock, None, backend="pytree_fwd",
                    device="cpu")
    assert float(q.quadform(a, v)) == pytest.approx(float(v @ want),
                                                    rel=1e-5)
    assert p.backend_for("hvp") == "pytree_fwdrev"
    auto = engine.plan(testfns.rosenbrock, None, device="cpu")
    assert auto.backend_for("quadform") == "pytree_fwd"
    with pytest.raises(ValueError, match="pytree plans execute"):
        p.execute(a)


def test_pytree_diag_workload_and_plan_errors():
    def loss(p):
        return (p["w"] ** 2).sum() * 0.5 + (p["b"] ** 4).sum()

    params = {"b": torch.tensor([0.5, -0.5]),
              "w": torch.tensor([1.0, 2.0, 3.0])}
    p = engine.plan(loss, None, csize=2, backend="pytree_fwdrev",
                    n_probes=4, device="cpu")
    d = p.diag(params, 0)
    # diag(H) of a separable loss is exact under Rademacher probes
    np.testing.assert_allclose(d["w"].numpy(), np.ones(3), rtol=1e-5)
    np.testing.assert_allclose(d["b"].numpy(),
                               12.0 * params["b"].numpy() ** 2, rtol=1e-4)
    # csize "auto"/"autotune" take the probe-chunk model's argmin
    assert engine.plan(loss, None, n_probes=64, device="cpu").csize == \
        engine.model_csize_probes(64)
    assert engine.plan(loss, None, csize="autotune", n_probes=8,
                       device="cpu").csize == engine.model_csize_probes(8)
    with pytest.raises(ValueError, match="csize"):
        engine.plan(loss, None, csize=3, n_probes=4, device="cpu").diag(
            params, 0)
    with pytest.raises(ValueError, match="diag_of"):
        engine.plan(loss, None, csize=2, diag_of="fisher",
                    device="cpu").diag(params, 0)
    # ggn / fisher without their plan options: no backend serves them
    with pytest.raises(ValueError, match="no registered backend"):
        p2 = engine.plan(loss, None, device="cpu")
        p2.ggn(params, params)
    with pytest.raises(ValueError, match="cannot run"):
        p.fisher(params, params)


def test_params_on_another_device_raise():
    """A tree whose tensors live elsewhere than the plan is never moved in
    silence (the flat plans' rule)."""
    p = engine.plan(_tree_obj, None, device="meta")
    tree = {"b": torch.ones(4), "w": torch.ones(3, 2)}
    for call in (lambda: p.hvp(tree, tree), lambda: p.diag(tree, 0),
                 lambda: p.quadform(tree, tree)):
        with pytest.raises(ValueError, match="passed to a plan on meta"):
            call()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            engine.plan(_tree_obj, None)        # the card by default


# ---------------------------------------------------------------------------
# service queues (tests/test_service.py:341-460)
# ---------------------------------------------------------------------------

def test_pytree_submits_coalesce_and_match_direct():
    p = engine.plan(_tree_obj, None, csize=2, backend="pytree_fwdrev",
                    device="cpu")
    pts = [_tree_point(i) for i in range(5)]
    v = _ones(pts[0])
    svc = CurvatureService(start=False, max_batch=8)
    futs = [svc.submit(p, pts[i], v) for i in range(5)]
    assert svc.flush() == 5
    st = svc.stats()
    assert st["batches"] == 1 and st["dispatched"] == 5
    for i, fut in enumerate(futs):
        got = fut.result(timeout=0)
        assert list(got) == ["b", "w"]
        assert all(isinstance(g, np.ndarray) for g in got.values())
        # rows run one after the other: bitwise the direct call
        _equal(got, p.hvp(pts[i], v))
    svc.shutdown()
    recs = [r for r in engine.execution_stats()
            if r["workload"] == "batched_hvp"]
    assert recs and recs[0]["by_bucket"][8]["executions"] == 1


def test_pytree_mixed_treedefs_use_separate_queues():
    p = engine.plan(_tree_obj, None, csize=2, backend="pytree_fwdrev",
                    device="cpu")
    t_a = _tree_point(0)
    t_b = {"x": np.arange(5, dtype=np.float32) / 3}
    svc = CurvatureService(start=False, max_batch=8)
    f_a = svc.submit(p, t_a, _ones(t_a))
    f_b = svc.submit(p, t_b, _ones(t_b))
    assert svc.flush() == 2
    assert svc.stats()["batches"] == 2       # one bucket per treedef
    _close(f_a.result(timeout=0), p.hvp(t_a, _ones(t_a)))
    _close(f_b.result(timeout=0), p.hvp(t_b, _ones(t_b)))
    svc.shutdown()


def test_pytree_diag_submits_coalesce():
    p = engine.plan(_tree_obj, None, csize=2, backend="pytree_fwdrev",
                    n_probes=2, device="cpu")
    pts = [_tree_point(i) for i in range(3)]
    svc = CurvatureService(start=False, max_batch=8)
    futs = [svc.submit(p, pts[i], s, workload="diag")
            for i, s in enumerate((0, 1, 2))]
    assert svc.flush() == 3
    assert svc.stats()["batches"] == 1
    for i, fut in enumerate(futs):
        _equal(fut.result(timeout=0), p.diag(pts[i], i))
    svc.shutdown()


def test_pytree_submit_validation_and_exceptions():
    p = engine.plan(_tree_obj, None, csize=2, backend="pytree_fwdrev",
                    device="cpu")
    t = _tree_point(0)
    svc = CurvatureService(start=False)
    with pytest.raises(ValueError):
        svc.submit(p, t, {"x": np.ones((5,), np.float32)})
    with pytest.raises(ValueError):
        svc.submit(p, t)                         # no dense pytree Hessians
    flat = engine.plan(testfns.rosenbrock, N, csize=2, device="cpu")
    with pytest.raises(ValueError):
        svc.submit(flat, np.zeros(N, np.float32), np.zeros(N, np.float32),
                   workload="hvp")
    svc.shutdown()

    def bad(tree):
        raise RuntimeError("deliberate pytree failure")

    p_bad = engine.plan(bad, None, backend="pytree_fwdrev", device="cpu")
    svc2 = CurvatureService(start=False)
    futs = [svc2.submit(p_bad, _tree_point(i), _ones(t)) for i in range(2)]
    assert svc2.flush() == 2
    for fut in futs:
        with pytest.raises(RuntimeError, match="deliberate"):
            fut.result(timeout=0)
    svc2.shutdown()


# ---------------------------------------------------------------------------
# probe budgets (tests/test_online_tune.py:316-406)
# ---------------------------------------------------------------------------

def _budget_point(seed=0):
    rs = np.random.RandomState(seed)
    return {"b": torch.tensor(rs.randn(3), dtype=torch.float32),
            "w": torch.tensor(rs.randn(3, 3), dtype=torch.float32)}


def _budget_loss(params):
    w, b = params["w"], params["b"]
    return torch.sum((w @ w.T + b) ** 2) + torch.sum(torch.sin(b))


def test_pytree_queues_are_not_tuned():
    def loss(params):
        return (params["w"] ** 2).sum() * torch.sin(params["b"]).sum()

    params = {"b": np.ones(2, np.float32), "w": np.ones(3, np.float32)}
    p = engine.plan(loss, None, device="cpu")
    now, calls = [0.0], []

    def tuner(*a, **k):
        calls.append(1)
        return {}

    svc = CurvatureService(max_batch=8, max_wait_us=100.0,
                           clock=lambda: now[0], start=False, tuner=tuner,
                           retune_min_points=1)
    for _ in range(8):
        svc.submit(p, params, params)
        svc.flush()
    summary = svc.retune()
    assert summary["queues_examined"] == 0 and not calls
    svc.shutdown()


def test_diag_probe_budgets_coalesce_into_one_bucket():
    """Mixed budgets share one bucket: a full-budget row is bitwise
    plan.diag, a budgeted row the direct budgeted estimate over the same
    seed's probe prefix."""
    p = engine.plan(_budget_loss, None, csize=4, options={"n_probes": 8},
                    device="cpu")
    params = _budget_point()
    with CurvatureService(max_batch=8, max_wait_us=100.0,
                          start=False) as svc:
        f_full = svc.submit(p, params, 1, workload="diag")
        f_two = svc.submit(p, params, 2, workload="diag", n_probes=2)
        f_cap = svc.submit(p, params, 3, workload="diag", n_probes=8)
        svc.flush()
        assert svc.stats()["batches"] == 1
        r_full, r_two, r_cap = (f_full.result(60), f_two.result(60),
                                f_cap.result(60))
    _equal(r_full, p.diag(params, 1))
    _equal(r_cap, p.diag(params, 3))
    _equal(r_two, tc.hutchinson_diag_budgeted(_budget_loss, params, 2, 2,
                                              n_probes=8, csize=4))


def test_ggn_diag_budgeted_submits():
    def model_fn(params):
        return params["w"] @ torch.ones(3) + params["b"]

    def head_loss(z):
        return torch.sum(torch.log1p(z ** 2))

    p = engine.plan(lambda q: head_loss(model_fn(q)), None, csize=4,
                    options={"n_probes": 8, "diag_of": "ggn",
                             "model_fn": model_fn, "head_loss": head_loss},
                    device="cpu")
    params = _budget_point(1)
    with CurvatureService(max_batch=8, max_wait_us=100.0,
                          start=False) as svc:
        f_full = svc.submit(p, params, 7, workload="diag")
        f_half = svc.submit(p, params, 8, workload="diag", n_probes=4)
        svc.flush()
        r_full, r_half = f_full.result(60), f_half.result(60)
    _equal(r_full, p.diag(params, 7))
    _equal(r_half, tc.ggn_diag_budgeted(model_fn, head_loss, params, 8, 4,
                                        n_probes=8, csize=4))


def test_probe_budget_validation():
    p = engine.plan(_budget_loss, None, csize=4, options={"n_probes": 8},
                    device="cpu")
    params = _budget_point()
    flat = engine.plan(testfns.rosenbrock, N, csize=2, device="cpu")
    with CurvatureService(start=False) as svc:
        with pytest.raises(ValueError, match="out of range"):
            svc.submit(p, params, 0, workload="diag", n_probes=9)
        with pytest.raises(ValueError, match="out of range"):
            svc.submit(p, params, 0, workload="diag", n_probes=0)
        with pytest.raises(ValueError, match="probe"):
            svc.submit(p, params, params, n_probes=2)    # hvp submit
        with pytest.raises(ValueError, match="probe"):
            svc.submit(flat, np.zeros(N, np.float32),
                       np.zeros(N, np.float32), n_probes=2)
        svc.flush()


def test_threaded_service_mixes_hvp_and_diag_queues():
    """A started service (worker threads) with HVP and budgeted diag
    submits from four threads: fewer batches than requests, every row the
    direct plan call."""
    import threading
    p = engine.plan(_budget_loss, None, csize=2, options={"n_probes": 4},
                    device="cpu")
    pts = [_budget_point(i) for i in range(4)]
    results = {}

    def client(c, svc):
        for i in range(4):
            k = 4 * c + i
            results[("hvp", k)] = svc.submit(p, pts[c], pts[i])
            results[("diag", k)] = svc.submit(p, pts[c], k,
                                              workload="diag",
                                              n_probes=1 + k % 4)

    with CurvatureService(max_batch=8, max_wait_us=20000.0) as svc:
        threads = [threading.Thread(target=client, args=(c, svc))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        got = {key: fut.result(60) for key, fut in results.items()}
        assert svc.stats()["batches"] < len(results)
    for (kind, k), row in got.items():
        c, i = divmod(k, 4)
        if kind == "hvp":
            _equal(row, p.hvp(pts[c], pts[i]))
        else:
            _equal(row, tc.hutchinson_diag_budgeted(
                _budget_loss, pts[c], k, 1 + k % 4, n_probes=4, csize=2))


# ---------------------------------------------------------------------------
# zoo conformance, dense rows (tests/test_zoo_conformance.py)
# ---------------------------------------------------------------------------

DENSE_ARCHS = [n for n in base.ARCH_NAMES
               if base.get_config(n, reduced=True).family == "dense"]


def _nerr(got, want):
    g = np.concatenate([np.asarray(l, np.float64).ravel()
                        for l in tree_leaves(got)])
    w = np.concatenate([np.asarray(l, np.float64).ravel()
                        for l in tree_leaves(want)])
    return float(np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30))


@pytest.mark.parametrize("name", DENSE_ARCHS)
def test_zoo_hvp_diag_ggn_fisher_parity_and_zero_rebuilds(name):
    assert len(DENSE_ARCHS) == 4
    cfg = base.get_config(name, reduced=True)
    batch = make_batch(cfg, 2, 16, 7, device="cpu")
    tgt = lm_curvature_targets(cfg, batch)
    params = init_params(cfg, 0, device="cpu")
    opts = {"n_probes": 2, **tgt.plan_options()}
    p = engine.plan(tgt.loss, None, csize=2, backend="pytree_fwdrev",
                    options=opts, device="cpu")
    v = tree_map(lambda l: torch.full_like(l, 0.01), params)
    assert _nerr(p.hvp(params, v), tc.pytree_hvp(tgt.loss, params, v)) \
        < 1e-6
    diag = p.diag(params, 3)
    assert _nerr(diag, tc.hutchinson_diag(
        tgt.loss, params, 3, n_probes=2, csize=2)) < 1e-6
    assert _nerr(p.ggn(params, v), tc.ggn_hvp(
        tgt.model_fn, tgt.head_loss, params, v)) < 1e-6
    assert _nerr(p.fisher(params, v), tc.empirical_fisher_vp(
        tgt.per_example_fn, params, v)) < 1e-6
    counts = {w: engine.trace_count(p.cache_key(w, "pytree_fwdrev"))
              for w in ("hvp", "diag", "ggn", "fisher")}
    assert all(c == 1 for c in counts.values()), counts
    # re-planning the same signature hits the callable cache: the same
    # callables, no build
    p2 = engine.plan(tgt.loss, None, csize=2, backend="pytree_fwdrev",
                     options=dict(opts), device="cpu")
    for w, c in counts.items():
        assert p2.executable(w) is p.executable(w)
        assert engine.trace_count(p2.cache_key(w, "pytree_fwdrev")) == c
    p2.hvp(params, v)
    assert engine.trace_count(p2.cache_key("hvp", "pytree_fwdrev")) == 1
    spectrum = diag_spectrum(diag)
    assert f"layers/attn/wq[{cfg.num_layers - 1}]" in spectrum
    assert all(np.isfinite(s["rms"]) for s in spectrum.values())


def test_gqa_repeat_kv_is_the_grouped_path():
    cfg = base.get_config("h2o-danube-1.8b", reduced=True)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    rep = dataclasses.replace(cfg32, gqa_repeat_kv=True)
    params = init_params(cfg, 1, device="cpu")
    batch = make_batch(cfg, 2, 40, 2, device="cpu")
    a = lm_curvature_targets(cfg32, batch).loss(params)
    b = lm_curvature_targets(rep, batch).loss(params)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
