"""The online half of repro_torch's tuner against the reference's
(tests/test_online_tune.py is the template): the dtype-policy guard in the
per-bucket sweep, ``autotune_buckets``' store round trip, and the
self-tuning ``CurvatureService`` with its DEFAULT tuner -- a traffic shift
and a drift each trigger a real ``autotune_buckets`` sweep on the CPU whose
winner is hot-swapped (its callable already built) with every future still
resolving to the JAX engine's HVP on the same seeded numpy inputs (rtol
1e-4, atol 1e-5, the template's tolerance for rows served by a swapped-in
winner, whose csize may differ from the reference plan's)."""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro.core import testfns as jtestfns  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core import testfns  # noqa: E402
from repro_torch.engine import registry  # noqa: E402
from repro_torch.engine.service import CurvatureService  # noqa: E402

import repro_torch.engine.autotune  # noqa: E402,F401
at = sys.modules["repro_torch.engine.autotune"]

N = 8
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv(at.STORE_ENV, str(tmp_path / "autotune.json"))
    engine.clear_autotune_cache()
    engine.clear_telemetry()
    yield
    engine.clear_autotune_cache()
    engine.clear_telemetry()


def _plan(fname="rosenbrock", csize=2, **opts):
    return engine.plan(getattr(testfns, fname), N, csize=csize,
                       symmetric=False, device="cpu", options=opts or None)


def _exact_plan(fname="rosenbrock"):
    """A served plan that asks for exact duals: its dtype_tol makes the
    sweep's oracle guard reject bf16, so every winner is fp32 and the rows
    it serves are held at the fp32 tolerance."""
    return _plan(fname, dtype_tol=1e-12)


def _want(fname, a, v):
    jp = jengine.plan(getattr(jtestfns, fname), N, csize=2, symmetric=False)
    return np.asarray(jp.hvp(jnp.asarray(a), jnp.asarray(v)))


def _drive(svc, p, batch, rounds, now, rng):
    futs = []
    for _ in range(rounds):
        A = rng.standard_normal((batch, N)).astype(np.float32)
        V = rng.standard_normal((batch, N)).astype(np.float32)
        futs += [(svc.submit(p, A[i], V[i]), A[i], V[i])
                 for i in range(batch)]
        now[0] += 0.01
        svc.flush()
    return futs


def _check(futs, fname="rosenbrock"):
    for fut, a, v in futs:
        np.testing.assert_allclose(fut.result(timeout=60),
                                   _want(fname, a, v), **TOL)


# ---------------------------------------------------------------------------
# the per-bucket sweep
# ---------------------------------------------------------------------------

def test_autotuner_drops_rejected_policy_and_keeps_fp32():
    cfgs = engine.autotune_buckets(
        testfns.rosenbrock, N, [4], symmetric=False,
        options={"dtype_tol": 1e-12}, reps=1, use_store=False,
        device="cpu")
    cfg = cfgs[4]
    assert cfg.dtype_policy == "fp32" and cfg.source == "sweep"
    assert any(pol == "bf16" for pol, _err in cfg.rejected)


def test_pinned_bad_policy_raises():
    with pytest.raises(engine.DtypePolicyRejected):
        engine.autotune_buckets(
            testfns.rosenbrock, N, [4], symmetric=False,
            options={"dtype_policy": "bf16", "dtype_tol": 1e-12},
            reps=1, use_store=False, device="cpu")


def test_autotune_buckets_sweeps_observed_shapes_and_persists():
    cfgs = engine.autotune_buckets(testfns.rosenbrock, N, {2: 0.3, 8: 0.7},
                                   symmetric=False, reps=1, device="cpu")
    assert set(cfgs) == {2, 8}
    for b, cfg in cfgs.items():
        assert cfg.bucket == b and cfg.us_per_point > 0
        assert cfg.source == "sweep" and cfg.backend.startswith("vmap_")
    key = next(k for k in engine.load_store() if k.endswith("|svc"))
    assert "|cpu|" in key
    before = engine.probe_count()
    again = engine.autotune_buckets(testfns.rosenbrock, N, {2: 0.3, 8: 0.7},
                                    symmetric=False, reps=1, device="cpu")
    assert engine.probe_count() == before          # warm store: no probes
    assert all(c.source == "disk" for c in again.values())
    assert {b: (c.csize, c.backend) for b, c in again.items()} == \
           {b: (c.csize, c.backend) for b, c in cfgs.items()}
    forced = engine.autotune_buckets(testfns.rosenbrock, N, [8],
                                     symmetric=False, reps=1, force=True,
                                     device="cpu")
    assert forced[8].source == "sweep" and engine.probe_count() > before
    with pytest.raises(ValueError, match="positive"):
        engine.autotune_buckets(testfns.rosenbrock, N, [0], device="cpu")
    with pytest.raises(ValueError, match="coalesced"):
        engine.autotune_buckets(testfns.rosenbrock, N, [4], workload="hvp",
                                device="cpu")


def test_bucket_probes_run_in_the_dispatchers_window(monkeypatch):
    """Each probe runs the plan's cached callable on operands already on
    the plan's device and returns host numpy, as the dispatcher's timed
    window does; its plan is the one apply_bucket_config derives."""
    seen = []
    real = at._served_window

    def spy(p, workload, A, V):
        assert isinstance(A, torch.Tensor) and A.device == p.device
        run = real(p, workload, A, V)

        def probe():
            out = run()
            assert isinstance(out, np.ndarray) and out.shape == (4, N)
            return out
        seen.append(p)
        return probe

    monkeypatch.setattr(at, "_served_window", spy)
    base = _plan()
    cfg = engine.autotune_buckets(base.f, N, [4], symmetric=False,
                                  options=base.options, reps=1,
                                  use_store=False, device="cpu")[4]
    won = engine.apply_bucket_config(base, cfg)
    assert any(p.cache_key("batched_hvp", cfg.backend)
               == won.cache_key("batched_hvp", cfg.backend) for p in seen)


def test_bucket_sweep_on_a_card_plan_carries_its_instance_blocks():
    """On a (fake) CUDA plan the bucket grid is the kernel's first: every
    csize with [None] + the instance blocks of the backend's form of f,
    before the vmap schedules."""
    from dataclasses import replace

    from repro_torch.kernels import chess_hvp as ck
    from repro_torch.kernels.ops import backend_form
    f = testfns.make_fletcher_powell(64)
    base = replace(engine.plan(f, 64, m=64, csize=1, symmetric=False,
                               device="cpu"),
                   device=torch.device("cuda", 0))
    grid = at._combo_grid(engine.function_fingerprint(f), base,
                          "batched_hvp")
    cuda = [(c, bm) for bk, c, bm in grid if bk == "cuda"]
    assert cuda and grid[:len(cuda)] == [("cuda", c, bm) for c, bm in cuda]
    for c in {c for c, _ in cuda}:
        assert [bm for cc, bm in cuda if cc == c] == [None] + \
            ck.instance_blocks(backend_form(f, 64), 64, c)


def _normalized_err(got, want):
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / np.linalg.norm(want))


@pytest.mark.parametrize("fname", ["rosenbrock", "ackley"])
def test_default_policy_axis_matches_reference(fname):
    """The default dtype axis, ("fp32", "bf16") as the reference's: on the
    same f, n and bucket both sweeps keep or reject bf16 alike under
    DEFAULT_DTYPE_TOL; a bucket swapped to bf16 duals serves rows whose
    normalized error against the JAX engine's exact HVP is under that
    tolerance and within a factor 4 of the reference's bf16 bucket on the
    same inputs (the two round bf16 tangents in different op orders)."""
    from dataclasses import replace
    b = 4
    cfg = engine.autotune_buckets(getattr(testfns, fname), N, [b],
                                  symmetric=False, reps=1, use_store=False,
                                  device="cpu")[b]
    jcfg = jengine.autotune_buckets(getattr(jtestfns, fname), N, [b],
                                    symmetric=False, reps=1,
                                    use_store=False)[b]
    assert at.DEFAULT_DTYPE_TOL == 5e-2
    assert [pol for pol, _ in cfg.rejected] == \
        [pol for pol, _ in jcfg.rejected] == []
    assert cfg.dtype_policy in ("fp32", "bf16")
    rng = np.random.RandomState(11)
    A = rng.uniform(-2, 2, (b, N)).astype(np.float32)
    V = rng.randn(b, N).astype(np.float32)
    want = np.stack([_want(fname, A[i], V[i]) for i in range(b)])
    half = dict(csize=2, backend="vmap_l2", blk_m=None, dtype_policy="bf16")
    p = engine.apply_bucket_config(_plan(fname), replace(cfg, **half))
    jp = jengine.apply_bucket_config(
        jengine.plan(getattr(jtestfns, fname), N, csize=2, symmetric=False),
        replace(jcfg, **half))
    err = _normalized_err(p.batched_hvp(A, V).numpy(), want)
    jerr = _normalized_err(jp.batched_hvp(jnp.asarray(A), jnp.asarray(V)),
                           want)
    assert 0.0 < err <= at.DEFAULT_DTYPE_TOL
    assert 0.0 < jerr <= at.DEFAULT_DTYPE_TOL
    assert jerr / 4 <= err <= 4 * jerr


# ---------------------------------------------------------------------------
# the self-tuning service with its default tuner
# ---------------------------------------------------------------------------

def test_service_default_policy_axis_serves_within_its_tolerance():
    """A served plan with no dtype_tol: the default re-tune may swap a
    bucket to bf16 duals.  Every row served after the swap is held to the
    JAX engine's exact HVP -- at the fp32 tolerance on an fp32 winner, at
    DEFAULT_DTYPE_TOL (normalized, per batch) on a bf16 one."""
    p = _plan()
    now = [0.0]
    rng = np.random.default_rng(3)
    svc = CurvatureService(max_batch=8, max_wait_us=100.0,
                           clock=lambda: now[0], start=False,
                           retune_min_points=8, retune_deadline_s=0.5,
                           tune_dispatch=False)
    _check(_drive(svc, p, 8, 2, now, rng))
    assert svc.retune()["hot_swaps"] == 1
    won = svc.tuning_report()[0]["buckets"][8]
    futs = _drive(svc, p, 8, 2, now, rng)
    for k in range(0, len(futs), 8):
        batch = futs[k:k + 8]
        got = np.stack([fut.result(timeout=60) for fut, _a, _v in batch])
        want = np.stack([_want("rosenbrock", a, v) for _f, a, v in batch])
        if won["dtype_policy"] == "fp32":
            np.testing.assert_allclose(got, want, **TOL)
        else:
            assert won["dtype_policy"] == "bf16"
            assert _normalized_err(got, want) <= at.DEFAULT_DTYPE_TOL
    svc.shutdown()


def test_service_retunes_on_traffic_shift_with_the_default_tuner():
    """Bucket-4 traffic is tuned by autotune_buckets; the mix shifts to
    bucket 8 and the next pass sweeps bucket 8 only, keeping bucket 4's
    winner; requests queued across the swap resolve, and the swapped
    callable was already built by the sweep."""
    p = _exact_plan()
    now = [0.0]
    rng = np.random.default_rng(0)
    svc = CurvatureService(max_batch=8, max_wait_us=100.0,
                           clock=lambda: now[0], start=False,
                           retune_min_points=8, retune_deadline_s=0.5,
                           tune_dispatch=False)
    futs = _drive(svc, p, 4, 4, now, rng)
    s1 = svc.retune()
    assert s1 == {"queues_examined": 1, "queues_tuned": 1,
                  "hot_swaps": 1, "errors": 0}
    q = list(svc._queues.values())[0]
    assert set(q.exec_by_bucket) == {4} and q.tuned_us[4] > 0
    stored = [k for k in engine.load_store() if k.endswith("|svc")]
    assert len(stored) == 1 and "|m4|" in stored[0]

    futs += _drive(svc, p, 8, 3, now, rng)
    A = rng.standard_normal((8, N)).astype(np.float32)
    V = rng.standard_normal((8, N)).astype(np.float32)
    inflight = [(svc.submit(p, A[i], V[i]), A[i], V[i]) for i in range(8)]
    win4 = q.exec_by_bucket[4]
    s2 = svc.retune()
    assert s2["hot_swaps"] == 1 and q.exec_by_bucket[4] is win4
    assert set(q.exec_by_bucket) == {4, 8}
    builds = engine.trace_count()
    svc.flush()                             # in-flight work on the winner
    assert engine.trace_count() == builds   # its callable was built
    futs += inflight
    _check(futs)
    rep = svc.tuning_report()[0]
    assert set(rep["buckets"]) == {4, 8}
    assert all(b["tuned_us"] > 0 and b["backend"].startswith("vmap_")
               and b["dtype_policy"] == "fp32"
               for b in rep["buckets"].values())
    assert svc.stats()["retunes"] == 2 and svc.stats()["retune_errors"] == 0
    svc.shutdown()


def test_service_drift_forces_a_retune_with_the_default_tuner(monkeypatch):
    p = _exact_plan("ackley")
    now = [0.0]
    rng = np.random.default_rng(1)
    calls = []
    real = at.autotune_buckets

    def spy(*args, **kw):
        calls.append((dict(args[2]), kw["force"]))
        return real(*args, **kw)

    svc = CurvatureService(max_batch=8, max_wait_us=100.0,
                           clock=lambda: now[0], start=False,
                           retune_min_points=8, retune_deadline_s=0.5,
                           drift_factor=1.5, tune_dispatch=False)
    monkeypatch.setattr(sys.modules["repro_torch.engine.service"],
                        "autotune_buckets", spy)
    futs = _drive(svc, p, 8, 4, now, rng)
    svc.retune()
    assert calls == [({8: 1.0}, False)]
    q = list(svc._queues.values())[0]
    # shrink the learned baseline below the measured us/point: the next
    # pass sees recent mean > drift_factor x baseline and re-probes
    q.tuned_us[8] = 1e-6
    futs += _drive(svc, p, 8, 4, now, rng)
    svc.retune()
    assert calls[-1] == ({8: 1.0}, True)
    assert q.tuned_us[8] > 1e-6               # a fresh measured baseline
    _check(futs, "ackley")
    svc.shutdown()


def test_retune_thread_runs_the_default_tuner():
    """retune_interval_s without tuner= starts the background thread, which
    tunes the served bucket on its own."""
    p = _exact_plan()
    rng = np.random.default_rng(2)
    done = threading.Event()
    with CurvatureService(max_batch=4, max_wait_us=100.0,
                          retune_interval_s=0.05, retune_min_points=4,
                          retune_deadline_s=0.2,
                          tune_dispatch=False) as svc:
        futs = []
        for _ in range(200):
            A = rng.standard_normal((4, N)).astype(np.float32)
            V = rng.standard_normal((4, N)).astype(np.float32)
            futs += [(svc.submit(p, A[i], V[i]), A[i], V[i])
                     for i in range(4)]
            for fut, _a, _v in futs[-4:]:
                fut.result(timeout=60)
            if svc.stats()["hot_swaps"]:
                done.set()
                break
        assert done.is_set(), svc.stats()
        assert svc.stats()["retune_errors"] == 0
        _check(futs)


def test_registry_consult_follows_served_history():
    """What the dispatcher records steers backend="auto" for the plan's
    own signature (and device) only."""
    p = _plan("rosenbrock", csize=4)
    assert p.backend_for("batched_hvp") == "vmap_l2"
    registry.record_execution(p.cache_key("batched_hvp", "vmap_l0"),
                              "vmap_l0", "batched_hvp", bucket=4,
                              n_points=4, elapsed_s=1e-9)
    assert p.backend_for("batched_hvp") == "vmap_l0"
    assert _plan("rosenbrock", csize=2).backend_for("batched_hvp") == \
        "vmap_l2"
