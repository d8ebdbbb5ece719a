"""repro_torch.engine.service against the reference's CurvatureService
(the flat cases of tests/test_service.py and the injected-tuner cases of
tests/test_online_tune.py are the templates): coalesced HVPs and Hessians
equal the JAX plans' batched_hvp / hvp / hessian on the same seeded numpy
inputs (rtol 1e-5, atol 1e-5, the template's tolerance), padding and the
wait budget under a fake clock, failure paths, telemetry, the online
re-tune with an injected tuner and with the default one, and the refusals
that stand until pytree plans are ported."""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro.core import testfns as jtestfns  # noqa: E402
from repro_torch import convert, engine  # noqa: E402
from repro_torch.core import testfns  # noqa: E402
from repro_torch.engine import registry  # noqa: E402
from repro_torch.engine.service import (CurvatureService,  # noqa: E402
                                        ServiceClosed, ServiceQueueFull)

N = 8
TOL = dict(rtol=1e-5, atol=1e-5)


def _data(n, m, seed=0):
    rng = np.random.RandomState(seed)
    return (np.asarray(rng.uniform(-2, 2, (m, n)), np.float32),
            np.asarray(rng.randn(m, n), np.float32))


def _plan(fname="rosenbrock", csize=2, n=N, **kw):
    return engine.plan(getattr(testfns, fname), n, csize=csize,
                       symmetric=False, device="cpu", **kw)


def _jplan(fname="rosenbrock", csize=2, n=N):
    return jengine.plan(getattr(jtestfns, fname), n, csize=csize,
                        symmetric=False)


def _want_hvp(jp, A, V):
    return np.asarray(jp.batched_hvp(jnp.asarray(A), jnp.asarray(V)))


@pytest.fixture(autouse=True)
def _clean_telemetry():
    engine.clear_telemetry()
    yield
    engine.clear_telemetry()


# ---------------------------------------------------------------------------
# correctness: coalesced == the reference's direct executables
# ---------------------------------------------------------------------------

def test_interleaved_submits_match_reference_batched_hvp():
    """Requests for two plans interleaved through one running service each
    match the JAX plan's batched_hvp."""
    p_ros, p_ack = _plan("rosenbrock"), _plan("ackley")
    m = 13                                    # non-bucket count on purpose
    A, V = _data(N, m, seed=1)
    with CurvatureService(max_batch=8, max_wait_us=500) as svc:
        futs = []
        for i in range(m):
            futs.append(("rosenbrock", i, svc.submit(p_ros, A[i], V[i])))
            futs.append(("ackley", i, svc.submit(p_ack, A[i], V[i])))
        got = {(tag, i): fut.result(timeout=60) for tag, i, fut in futs}
    for tag in ("rosenbrock", "ackley"):
        want = _want_hvp(_jplan(tag), A, V)
        for i in range(m):
            np.testing.assert_allclose(got[(tag, i)], want[i], **TOL)


def test_concurrent_client_threads_match_reference():
    p = _plan()
    m, clients = 24, 4
    A, V = _data(N, m, seed=2)
    results = [None] * m
    with CurvatureService(max_batch=8, max_wait_us=200) as svc:
        def client(cid):
            futs = [(i, svc.submit(p, A[i], V[i]))
                    for i in range(cid, m, clients)]
            for i, fut in futs:
                results[i] = fut.result(timeout=60)
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    want = _want_hvp(_jplan(), A, V)
    for i in range(m):
        np.testing.assert_allclose(results[i], want[i], **TOL)


@pytest.mark.parametrize("fname", ["rosenbrock", "ackley", "fletcher_powell"])
def test_hessian_requests_coalesce_and_match_reference(fname):
    """v=None submits coalesce through batched_hessian; each equals the JAX
    plan's hessian.  Fletcher-Powell is served from the coefficients the
    reference generates, carried over as numpy."""
    if fname == "fletcher_powell":
        f = convert.fletcher_powell_from_numpy(*jtestfns._fp_coeffs(N))
        jf = jtestfns.make_fletcher_powell(N)
    else:
        f, jf = getattr(testfns, fname), getattr(jtestfns, fname)
    p = engine.plan(f, N, csize=2, symmetric=False, device="cpu")
    jp = jengine.plan(jf, N, csize=2, symmetric=False)
    A, V = _data(N, 3, seed=3)
    svc = CurvatureService(start=False, max_batch=8)
    futs = [svc.submit(p, A[i]) for i in range(3)]
    hfuts = [svc.submit(p, A[i], V[i]) for i in range(3)]
    assert svc.flush() == 6
    want_h = np.asarray(jp.batched_hvp(jnp.asarray(A), jnp.asarray(V)))
    scale = 1.0 + np.abs(want_h).max()        # Fletcher-Powell's ~1e5
    for i, (fut, hfut) in enumerate(zip(futs, hfuts)):
        got = fut.result(timeout=0)
        assert got.shape == (N, N)
        np.testing.assert_allclose(got, np.asarray(jp.hessian(A[i])),
                                   rtol=1e-5, atol=1e-5 * scale)
        np.testing.assert_allclose(hfut.result(timeout=0), want_h[i],
                                   rtol=1e-5, atol=1e-5 * scale)
    svc.shutdown()


# ---------------------------------------------------------------------------
# padding / bucketing
# ---------------------------------------------------------------------------

def test_bucket_size_and_pad_helpers_equal_reference():
    for k in range(1, 20):
        assert engine.bucket_size(k) == jengine.bucket_size(k)
        assert engine.bucket_size(k, 16 if k <= 16 else 32) == \
            jengine.bucket_size(k, 16 if k <= 16 else 32)
    X = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(engine.pad_rows(X, 8),
                                  np.asarray(jengine.pad_rows(X, 8)))
    x = np.arange(5, dtype=np.float32)
    np.testing.assert_array_equal(engine.pad_cols(x, 9),
                                  np.asarray(jengine.pad_cols(x, 9)))
    with pytest.raises(ValueError):
        engine.pad_rows(X, 2)


@pytest.mark.parametrize("k,expected_bucket", [(1, 1), (3, 4), (5, 8),
                                               (7, 8)])
def test_padding_correct_at_non_bucket_sizes(k, expected_bucket):
    p = _plan()
    A, V = _data(N, k, seed=10 + k)
    svc = CurvatureService(start=False, max_batch=8)
    futs = [svc.submit(p, A[i], V[i]) for i in range(k)]
    assert svc.poll(now=1e9) == k            # wait budget exceeded: flush
    assert svc.stats()["buckets"] == {expected_bucket: 1}
    assert svc.stats()["padded_rows"] == expected_bucket - k
    want = _want_hvp(_jplan(), A, V)
    for i, fut in enumerate(futs):
        np.testing.assert_allclose(fut.result(timeout=0), want[i], **TOL)
    svc.shutdown()


def test_overfull_queue_splits_into_max_batch_buckets():
    p = _plan()
    A, V = _data(N, 10, seed=4)
    svc = CurvatureService(start=False, max_batch=4, max_wait_us=1e9)
    futs = [svc.submit(p, A[i], V[i]) for i in range(10)]
    assert svc.poll(now=0.0) == 8
    assert svc.stats()["buckets"] == {4: 2}
    assert svc.poll(now=0.0) == 0
    assert svc.poll(now=1e9) == 2
    assert svc.stats()["buckets"] == {4: 2, 2: 1}
    want = _want_hvp(_jplan(), A, V)
    for i, fut in enumerate(futs):
        np.testing.assert_allclose(fut.result(timeout=0), want[i], **TOL)
    svc.shutdown()


# ---------------------------------------------------------------------------
# wait budget (fake clock: no sleeping)
# ---------------------------------------------------------------------------

def test_max_wait_us_flush_with_fake_clock():
    now = [0.0]
    svc = CurvatureService(start=False, clock=lambda: now[0],
                           max_batch=64, max_wait_us=500.0)
    p = _plan()
    A, V = _data(N, 2, seed=5)
    f0 = svc.submit(p, A[0], V[0])
    now[0] = 300e-6
    f1 = svc.submit(p, A[1], V[1])
    assert svc.poll() == 0
    now[0] = 499e-6
    assert svc.poll() == 0
    assert not f0.done() and not f1.done()
    now[0] = 501e-6
    assert svc.poll() == 2
    want = _want_hvp(_jplan(), A, V)
    np.testing.assert_allclose(f0.result(timeout=0), want[0], **TOL)
    np.testing.assert_allclose(f1.result(timeout=0), want[1], **TOL)
    svc.shutdown()


def test_full_bucket_dispatches_before_wait_budget():
    now = [0.0]
    svc = CurvatureService(start=False, clock=lambda: now[0],
                           max_batch=2, max_wait_us=1e9)
    p = _plan()
    A, V = _data(N, 2, seed=6)
    svc.submit(p, A[0], V[0])
    assert svc.poll() == 0
    svc.submit(p, A[1], V[1])
    assert svc.poll() == 2
    svc.shutdown()


# ---------------------------------------------------------------------------
# failure paths
# ---------------------------------------------------------------------------

def test_exception_propagates_into_every_future():
    boom = RuntimeError("deliberate failure")

    def bad(x):
        raise boom

    p = engine.plan(bad, N, csize=1, backend="vmap_l2", symmetric=False,
                    device="cpu")
    A, V = _data(N, 3, seed=7)
    svc = CurvatureService(start=False, max_batch=8)
    futs = [svc.submit(p, A[i], V[i]) for i in range(3)]
    assert svc.flush() == 3
    for fut in futs:
        with pytest.raises(RuntimeError, match="deliberate"):
            fut.result(timeout=0)
    svc.shutdown()


def test_bad_shapes_rejected_at_submit():
    p = _plan()
    svc = CurvatureService(start=False)
    A, V = _data(N, 1, seed=8)
    with pytest.raises(ValueError):
        svc.submit(p, np.zeros((N + 1,), np.float32), V[0])
    with pytest.raises(ValueError):
        svc.submit(p, A[0], np.zeros((2, N), np.float32))
    svc.shutdown()


def test_bounded_queue_backpressure_and_close():
    p = _plan()
    A, V = _data(N, 3, seed=9)
    svc = CurvatureService(start=False, max_queue=2)
    svc.submit(p, A[0], V[0])
    svc.submit(p, A[1], V[1])
    with pytest.raises(ServiceQueueFull):
        svc.submit(p, A[2], V[2], block=False)
    with pytest.raises(ServiceQueueFull):
        svc.submit(p, A[2], V[2], timeout=0.01)
    svc.flush()
    fut = svc.submit(p, A[2], V[2], block=False)
    svc.shutdown(wait=True)
    assert fut.done()
    with pytest.raises(ServiceClosed):
        svc.submit(p, A[0], V[0])


def test_shutdown_no_wait_fails_pending_futures():
    p = _plan()
    A, V = _data(N, 2, seed=11)
    svc = CurvatureService(start=False)
    futs = [svc.submit(p, A[i], V[i]) for i in range(2)]
    svc.shutdown(wait=False)
    for fut in futs:
        with pytest.raises(ServiceClosed):
            fut.result(timeout=0)


# ---------------------------------------------------------------------------
# plan integration, telemetry, workers
# ---------------------------------------------------------------------------

def test_plan_submit_routes_through_default_service():
    p = _plan()
    A, V = _data(N, 1, seed=12)
    fut = p.submit(A[0], V[0])
    want = np.asarray(_jplan().hvp(A[0], V[0]))
    np.testing.assert_allclose(fut.result(timeout=60), want, **TOL)
    assert p.service() is engine.get_service()
    engine.shutdown_service()


def test_plans_with_same_signature_share_a_queue():
    p1, p2 = _plan(), _plan()
    assert p1 is not p2
    A, V = _data(N, 2, seed=13)
    svc = CurvatureService(start=False, max_batch=8)
    f1 = svc.submit(p1, A[0], V[0])
    f2 = svc.submit(p2, A[1], V[1])
    assert svc.poll(now=1e9) == 2
    assert svc.stats()["batches"] == 1
    assert f1.done() and f2.done()
    svc.shutdown()


def test_round_robin_prevents_queue_starvation():
    p_a, p_b = _plan("rosenbrock"), _plan("ackley")
    A, V = _data(N, 6, seed=15)
    svc = CurvatureService(start=False, max_batch=2, max_wait_us=1e9)
    for i in range(4):
        svc.submit(p_a, A[i], V[i])
    fb = [svc.submit(p_b, A[4 + i], V[4 + i]) for i in range(2)]
    q1, reqs1 = svc._take_ready_batch(now=0.0)
    q2, reqs2 = svc._take_ready_batch(now=0.0)
    assert q1.plan.f is p_a.f and len(reqs1) == 2
    assert q2.plan.f is p_b.f and len(reqs2) == 2
    svc._execute(q1, reqs1)
    svc._execute(q2, reqs2)
    assert all(f.done() for f in fb)
    svc.flush()
    svc.shutdown()


def test_execution_telemetry_recorded_per_bucket():
    p = _plan()
    A, V = _data(N, 5, seed=14)
    svc = CurvatureService(start=False, max_batch=8)
    for i in range(5):
        svc.submit(p, A[i], V[i], client="c0")
    svc.flush()
    svc.shutdown()
    (rec,) = engine.execution_stats()
    assert rec["workload"] == "batched_hvp" and rec["backend"] == "vmap_l2"
    assert rec["signature"] == p.cache_key("batched_hvp", "vmap_l2")
    assert list(rec["by_bucket"]) == [8]
    b = rec["by_bucket"][8]
    assert b["count"] == 1 and b["us_per_point_mean"] > 0
    assert b["executions"] == 1 and b["points"] == 5
    tel = engine.bucket_telemetry(rec["signature"])
    assert tel[8]["count"] == 1 and tel[8]["recent_us_mean"] > 0
    assert engine.client_stats() == {"c0": {"points": 5, "batches": 1}}


def test_record_execution_windows_and_clear():
    sig = ("sig",)
    for k in range(40):
        registry.record_execution(sig, "vmap_l2", "batched_hvp", bucket=4,
                                  n_points=2, elapsed_s=2e-6 * (k + 1),
                                  now=float(k))
    registry.record_execution(sig, "vmap_l2", "batched_hvp", bucket=4,
                              n_points=0, elapsed_s=1.0)   # ignored
    tel = engine.bucket_telemetry(sig)[4]
    assert tel["count"] == 40 and tel["last_t"] == 39.0
    (rec,) = engine.execution_stats()
    assert rec["by_bucket"][4]["executions"] == 40
    assert rec["by_bucket"][4]["points"] == 80
    # the recent window holds the newest 32 samples: us/point k+1, k=8..39
    assert tel["recent_us_mean"] == pytest.approx(sum(range(9, 41)) / 32)
    assert tel["recent_us_min"] == pytest.approx(9.0)
    engine.clear_telemetry()
    assert engine.bucket_telemetry(sig) == {} and not engine.execution_stats()


def test_many_workers_many_clients_lose_nothing():
    """Stress: more dispatch workers and client threads than cores, with a
    short switch interval.  Every future resolves to the reference's HVP,
    and the service's counters and the telemetry agree on every row and
    batch (a lost update would break one of them)."""
    import sys
    p_ros, p_ack = _plan("rosenbrock"), _plan("ackley")
    m, clients = 96, 12
    A, V = _data(N, m, seed=21)
    results = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with CurvatureService(max_batch=8, max_wait_us=50.0,
                              workers=8) as svc:
            def client(c):
                for i in range(c, m, clients):
                    p = p_ros if i % 2 else p_ack
                    results[i] = svc.submit(p, A[i], V[i],
                                            client=f"c{c}").result(60)
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            stats = svc.stats()
    finally:
        sys.setswitchinterval(old)
    for tag, parity in (("rosenbrock", 1), ("ackley", 0)):
        want = _want_hvp(_jplan(tag), A, V)
        for i in range(parity, m, 2):
            np.testing.assert_allclose(results[i], want[i], **TOL)
    assert stats["submitted"] == stats["dispatched"] == m
    recs = engine.execution_stats()
    assert sum(b["executions"] for r in recs
               for b in r["by_bucket"].values()) == stats["batches"]
    assert sum(b["points"] for r in recs
               for b in r["by_bucket"].values()) == m
    assert sum(t["points"] for t in engine.client_stats().values()) == m


def test_dispatcher_pool_size():
    """workers=None: one worker per visible CUDA device, or one."""
    from repro_torch.serving.dispatch import Dispatcher
    svc = CurvatureService(max_batch=8)
    assert len(svc._dispatcher.threads) == max(torch.cuda.device_count(), 1)
    svc.shutdown()
    with pytest.raises(ValueError):
        Dispatcher(svc._sched, workers=-1)


# ---------------------------------------------------------------------------
# online re-tune (fake clock, injected tuner: fully deterministic)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Cfg:
    """A tuner's per-bucket winner (the reference's BucketTunedConfig)."""
    bucket: int
    csize: int
    backend: str
    blk_m: object
    dtype_policy: str
    us_per_point: float


def _fake_tuner(calls, csize=4):
    def tuner(plan, workload, buckets, force, deadline_s):
        calls.append((dict(buckets), force))
        return {b: _Cfg(b, csize, "vmap_l2", None, "fp32", 1e6)
                for b in buckets}
    return tuner


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


def test_service_retunes_on_traffic_shift_and_winner_changes():
    p = _plan()
    now, calls = [0.0], []
    rng = np.random.default_rng(0)
    svc = CurvatureService(max_batch=8, max_wait_us=100.0,
                           clock=lambda: now[0], start=False,
                           tuner=_fake_tuner(calls), retune_min_points=8,
                           tune_dispatch=False)
    futs = _drive(svc, p, 4, 4, now, rng)
    s1 = svc.retune()
    assert s1 == {"queues_examined": 1, "queues_tuned": 1,
                  "hot_swaps": 1, "errors": 0}
    assert calls[-1] == ({4: 1.0}, False)
    q = list(svc._queues.values())[0]
    ep, backend, key = q.exec_by_bucket[4]
    assert ep.csize == 4 and backend == "vmap_l2"
    assert key == ep.cache_key("batched_hvp", "vmap_l2")
    assert ep.device == p.device and ep.backend == "vmap_l2"

    futs += _drive(svc, p, 8, 3, now, rng)
    A = rng.standard_normal((8, N)).astype(np.float32)
    V = rng.standard_normal((8, N)).astype(np.float32)
    inflight = [(svc.submit(p, A[i], V[i]), A[i], V[i]) for i in range(8)]
    s2 = svc.retune()
    assert calls[-1][0] == {8: 1.0}
    assert s2["hot_swaps"] == 1
    svc.flush()
    futs += inflight

    futs += _drive(svc, p, 8, 4, now, rng)
    s3 = svc.retune()
    assert s3["hot_swaps"] == 0 and len(calls) == 2

    jp = _jplan()
    for fut, a, v in futs:
        np.testing.assert_allclose(fut.result(timeout=30),
                                   np.asarray(jp.hvp(a, v)), **TOL)
    assert svc.stats()["retunes"] == 3
    rep = svc.tuning_report()
    assert rep[0]["buckets"][4]["csize"] == 4
    svc.shutdown()


def test_service_drift_forces_a_retune():
    p = _plan()
    now, calls = [0.0], []
    rng = np.random.default_rng(1)
    svc = CurvatureService(max_batch=8, max_wait_us=100.0,
                           clock=lambda: now[0], start=False,
                           tuner=_fake_tuner(calls), retune_min_points=8,
                           drift_factor=1.5, tune_dispatch=False)
    for fut, a, v in _drive(svc, p, 8, 4, now, rng):
        fut.result(30)
    svc.retune()
    q = list(svc._queues.values())[0]
    q.tuned_us[8] = 1e-3
    for fut, a, v in _drive(svc, p, 8, 4, now, rng):
        fut.result(30)
    svc.retune()
    assert calls[-1] == ({8: 1.0}, True)
    svc.shutdown()


def test_service_fits_dispatch_knobs_from_rate_and_telemetry():
    p = _plan()
    now, calls = [0.0], []
    rng = np.random.default_rng(2)
    svc = CurvatureService(max_batch=256, max_wait_us=100.0,
                           clock=lambda: now[0], start=False,
                           tuner=_fake_tuner(calls), retune_min_points=8,
                           tune_dispatch=True)
    for _ in range(4):                       # 10k req/s at bucket 8
        A = rng.standard_normal((8, N)).astype(np.float32)
        V = rng.standard_normal((8, N)).astype(np.float32)
        fs = [svc.submit(p, A[i], V[i]) for i in range(8)]
        now[0] += 8e-4
        svc.flush()
        for f in fs:
            f.result(30)
    svc.retune()
    rep = svc.tuning_report()
    assert rep and rep[0]["max_batch"] == 8
    assert rep[0]["max_wait_us"] is not None
    assert 8 in rep[0]["buckets"]
    svc.shutdown()


def test_tuner_errors_are_counted():
    p = _plan()
    now = [0.0]

    def broken(*args):
        raise RuntimeError("tuner failed")

    svc = CurvatureService(max_batch=8, clock=lambda: now[0], start=False,
                           tuner=broken, retune_min_points=4)
    for fut, a, v in _drive(svc, p, 4, 2, now, np.random.default_rng(4)):
        fut.result(30)
    assert svc.retune()["errors"] == 1
    assert svc.stats()["retune_errors"] == 1
    svc.shutdown()


def test_retune_without_a_tuner_is_refused(monkeypatch, tmp_path):
    """Without an injected tuner the service re-tunes with its default,
    autotune.autotune_buckets: the re-tune thread starts, and a synchronous
    pass sweeps the observed bucket, hot-swaps its winner and counts no
    error (a non-positive interval is still refused)."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    engine.clear_autotune_cache()
    with pytest.raises(ValueError, match="> 0"):
        CurvatureService(retune_interval_s=0.0, tuner=_fake_tuner([]))
    with pytest.raises(ValueError, match="> 0"):
        CurvatureService(retune_interval_s=-1.0)
    svc = CurvatureService(retune_interval_s=1.0)
    assert svc._retune_thread is not None and svc._retune_thread.is_alive()
    p = _plan()
    now = [0.0]
    svc2 = CurvatureService(start=False, clock=lambda: now[0],
                            retune_min_points=1, retune_deadline_s=0.2)
    for fut, a, v in _drive(svc2, p, 4, 2, now, np.random.default_rng(5)):
        fut.result(30)
    assert svc.retune()["queues_examined"] == 0      # no traffic yet
    summary = svc2.retune()
    assert summary["hot_swaps"] == 1 and summary["errors"] == 0
    (rep,) = svc2.tuning_report()
    assert rep["buckets"][4]["tuned_us"] > 0
    for s in (svc, svc2):
        assert s.stats()["retune_errors"] == 0
        s.shutdown()
    assert not svc._retune_thread
    engine.clear_autotune_cache()


def test_pytree_plans_and_autotune_wait_for_their_items(monkeypatch,
                                                        tmp_path):
    with pytest.raises(NotImplementedError, match="A.4"):
        engine.plan(lambda t: t, None, device="cpu")
    # csize="autotune" is ported: the store is the test's own
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    engine.clear_autotune_cache()
    try:
        p = engine.plan(testfns.rosenbrock, N, m=4, csize="autotune",
                        device="cpu")
        assert p.backend_for("batched_hvp") == engine.lookup_tuned(
            p, "batched_hvp").backend
    finally:
        engine.clear_autotune_cache()
    with pytest.raises(NotImplementedError, match="A.4"):
        engine.autotune(testfns.rosenbrock, N, workload="diag",
                        device="cpu")
    spec = engine.spec_of({"w": np.ones((2, 3), np.float32),
                           "b": torch.zeros(4)})
    assert spec.size == 10 and spec.dtypes == ("float32", "float32")
    row = spec.ravel({"w": np.ones((2, 3), np.float32),
                      "b": torch.arange(4.0)})
    back = spec.unravel(row)
    np.testing.assert_array_equal(back["b"], np.arange(4.0))
    same = engine.spec_of({"w": np.zeros((2, 3), np.float32),
                           "b": torch.ones(4)})
    assert same == spec and hash(same) == hash(spec)
    with pytest.raises(ValueError, match="structure"):
        spec.ravel({"w": np.ones((2, 3))})
