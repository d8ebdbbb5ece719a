"""repro_torch.obs against the reference's repro.obs (tests/test_obs.py is
the template): the copied metrics registry and flight recorder, their
Prometheus text against the reference's for the same operations (same
series, same values), the service's stats() and registry in agreement,
the torch.profiler capture session (a Chrome trace that names the
dispatch worker's per-bucket annotation), and traces and metrics over the
wire."""

import glob
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import engine as jengine  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.core import testfns as jtestfns  # noqa: E402
from repro.engine.service import CurvatureService as JService  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JRegistry  # noqa: E402
from repro_torch import engine, obs  # noqa: E402
from repro_torch.core import testfns  # noqa: E402
from repro_torch.engine.service import CurvatureService  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.obs.trace import FlightRecorder, Trace  # noqa: E402
from repro_torch.serving import AdmissionController, ClientPolicy  # noqa

NS = (8, 12, 16)


@pytest.fixture(autouse=True)
def _fresh_obs():
    """Both packages' registries and recorders start enabled and empty."""
    was, jwas = obs.enabled(), jobs.enabled()
    obs.enable()
    jobs.enable()
    obs.reset()
    jobs.reset()
    engine.clear_telemetry()
    jengine.clear_telemetry()
    yield
    obs.set_enabled(was)
    jobs.set_enabled(jwas)
    obs.reset()
    jobs.reset()


def _xv(n, seed=0):
    rng = np.random.RandomState(seed)
    return (np.asarray(rng.uniform(-2, 2, n), np.float32),
            np.asarray(rng.randn(n), np.float32))


def _series(text, timed=("_us_",)):
    """{series: value} of a Prometheus exposition; series whose values are
    measured times (``timed``) keep only their sample count."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        base = re.split(r"[{ ]", name)[0]
        if any(t in base + "_" for t in timed) and not \
                base.endswith("_count"):
            continue
        out[name] = float(value)
    return out


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def _registry_ops(reg_cls):
    t = [0.0]
    reg = reg_cls(clock=lambda: t[0], time_scale=1e6)
    c = reg.counter("reqs_total", "requests", labelnames=("priority",))
    c.inc(priority="batch")
    c.inc(2.0, priority="interactive")
    g = reg.gauge("depth", "queue depth")
    g.set(7.0)
    g.dec(2.0)
    h = reg.histogram("lat_us", "latency", buckets=(10.0, 100.0, 1000.0))
    h.observe(50.0)
    h.observe(5000.0)
    with h.time():
        t[0] += 100e-6
    reg.histogram("d_us", "durations").observe(42.0)
    reg.set_collector("view", lambda r: r.gauge("pending", "live").child()
                      .set(3.0))
    return reg


def test_prometheus_text_equals_reference_for_the_same_operations():
    reg, jreg = _registry_ops(MetricsRegistry), _registry_ops(JRegistry)
    assert reg.to_prometheus() == jreg.to_prometheus()
    assert reg.to_json() == jreg.to_json()
    json.dumps(reg.to_json())
    c = reg.get("reqs_total")
    assert c.value(priority="batch") == 1.0 and c.total() == 3.0
    assert reg.value("depth") == 5.0 and reg.value("pending") == 3.0
    snap = reg.get("lat_us").snapshot()
    assert snap["count"] == 3 and snap["counts"] == [0, 2, 0, 1]
    assert snap["sum"] == pytest.approx(5150.0)


def test_metric_declarations_are_idempotent_but_conflicts_raise():
    reg = MetricsRegistry()
    c1 = reg.counter("x_total", labelnames=("k",))
    assert reg.counter("x_total", labelnames=("k",)) is c1
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x_total")
    with pytest.raises(ValueError, match="already registered"):
        reg.counter("x_total", labelnames=("other",))
    with pytest.raises(ValueError, match="labelnames"):
        c1.inc(wrong="v")


def test_collectors_run_at_scrape_time_and_survive_reset():
    reg = MetricsRegistry()
    live = {"pending": 3}
    calls = []

    def collect(r):
        calls.append(1)
        r.gauge("pending", "live view").child().set(live["pending"])

    reg.set_collector("svc", collect)
    assert reg.value("pending") == 3.0
    live["pending"] = 9
    assert reg.value("pending") == 9.0
    reg.reset()
    assert reg.get("pending") is None
    assert reg.value("pending") == 9.0
    n = len(calls)
    reg.remove_collector("svc")
    reg.to_prometheus()
    assert len(calls) == n


# ---------------------------------------------------------------------------
# tracing + flight recorder
# ---------------------------------------------------------------------------

def _fake_trace(rec, t, spans):
    tr = Trace(meta={"n": 8}, clock=lambda: t[0], recorder=rec)
    for name, dur in spans:
        t0 = t[0]
        t[0] += dur
        tr.add_span(name, t0, t[0])
    tr.finish()
    return tr


def test_recorder_digest_and_bounded_rings():
    reg = MetricsRegistry()
    rec = FlightRecorder(capacity=4, slow_threshold_s=0.05, registry=reg)
    t = [0.0]
    slow = _fake_trace(rec, t, [("device_execute", 0.2)])
    _fake_trace(rec, t, [("enqueue", 100e-6)])
    assert reg.get("repro_span_duration_us") is None    # deferred digest
    rec.digest()
    assert reg.value("repro_traces_total") == 2.0
    assert reg.get("repro_span_duration_us").snapshot(
        span="enqueue")["sum"] == pytest.approx(100.0)
    for _ in range(6):
        _fake_trace(rec, t, [("device_execute", 1e-4)])
    assert len(rec) == 4 and slow not in rec.recent(16)
    assert rec.slowest(1)[0] is slow


def test_trace_to_dict_is_json_safe_and_disabled_obs_is_inert():
    t = [1.0]
    rec = FlightRecorder(registry=MetricsRegistry())
    tr = Trace(meta={"client": "c", "arr": np.float32(2.5)},
               clock=lambda: t[0], recorder=rec)
    with tr.span("admit"):
        t[0] += 0.001
    tr.add_span("device_execute", t[0], t[0] + 0.002,
                meta={"bucket": 4, "n_pad": np.int64(16)})
    tr.finish(error="Boom")
    d = tr.to_dict()
    json.dumps(d)
    assert [s["name"] for s in d["spans"]] == ["admit", "device_execute"]
    assert d["spans"][0]["dur_ms"] == pytest.approx(1.0)
    obs.disable()
    assert obs.trace_begin(client="x") is None
    assert obs.event("retune", plan="p") is None
    obs.enable()
    assert isinstance(obs.trace_begin(), Trace)


# ---------------------------------------------------------------------------
# the serving path's series, against the reference's
# ---------------------------------------------------------------------------

def _serve_sequence(svc_cls, eng, tfn, reg, device_kw):
    """The same submits, priorities and clients through a start=False
    service; returns (stats, the registry's series)."""
    fam = tfn.ragged_family("rosenbrock")
    plans = {n: eng.plan(fam, n, symmetric=False, **device_kw) for n in NS}
    p8 = eng.plan(tfn.rosenbrock, 8, csize=2, symmetric=False, **device_kw)
    svc = svc_cls(max_batch=4, max_wait_us=100.0, start=False)
    futs = []
    for i, n in enumerate(list(NS) * 3):
        a, v = _xv(n, seed=i)
        futs.append(svc.submit(plans[n], a, v, client=f"c{i % 2}",
                               priority="interactive" if i % 3 else "batch"))
    for i in range(5):
        futs.append(svc.submit(p8, *_xv(8, seed=40 + i)))
    svc.flush()
    for f in futs:
        f.result(timeout=60)
    svc.shutdown()
    return svc.stats(), _series(reg.to_prometheus())


def test_serving_series_equal_reference():
    """Same traffic, same series and values in both registries (measured
    times compared by their sample counts only)."""
    s, got = _serve_sequence(CurvatureService, engine, testfns,
                             obs.metrics_registry(), {"device": "cpu"})
    js, want = _serve_sequence(JService, jengine, jtestfns,
                               jobs.metrics_registry(), {})
    # the backend label names the executable that ran: vmap_l2 in both
    assert got == want
    assert s == js
    assert got["repro_points_total"] == s["dispatched"] == 14
    assert got['repro_batches_total{kind="ragged"}'] == s["ragged_batches"]


def test_service_stats_and_metrics_registry_agree():
    fam = testfns.ragged_family("rosenbrock")
    plans = {n: engine.plan(fam, n, symmetric=False, device="cpu")
             for n in NS}
    svc = CurvatureService(max_batch=4, max_wait_us=100.0, start=False)
    futs = []
    for i, n in enumerate(list(NS) * 3):
        a, v = _xv(n, seed=i)
        futs.append(svc.submit(plans[n], a, v, client=f"c{i % 2}",
                               priority="interactive" if i % 3 else "batch"))
    svc.flush()
    for f in futs:
        f.result(timeout=30)
    s = svc.stats()
    reg = obs.metrics_registry()
    assert reg.total("repro_requests_total") == s["submitted"]
    assert reg.value("repro_requests_total", priority="batch") == 3.0
    assert reg.total("repro_points_total") == s["dispatched"]
    assert reg.value("repro_batches_total", kind="ragged") == \
        s["ragged_batches"]
    assert reg.value("repro_batches_total", kind="dense") == \
        s["batches"] - s["ragged_batches"]
    assert reg.total("repro_padded_rows_total") == s["padded_rows"]
    assert reg.total("repro_cross_n_fills_total") == s["cross_n_fills"]
    for b, count in s["buckets"].items():
        assert reg.value("repro_bucket_batches_total", bucket=b) == count
    assert reg.value("repro_pending") == 0.0
    assert reg.total("repro_traces_total") == s["submitted"]
    for cid, tot in engine.client_stats().items():
        assert reg.value("repro_client_points_total", client=cid) == \
            tot["points"]
    assert reg.total("repro_executions_total") == s["batches"]
    svc.shutdown()
    assert reg.total("repro_points_total") == s["dispatched"]


def test_admission_shed_counts_agree_with_registry():
    adm = AdmissionController(default_policy=ClientPolicy(rate=0.001,
                                                          burst=1))
    p = engine.plan(testfns.rosenbrock, 8, csize=2, symmetric=False,
                    device="cpu")
    a, v = _xv(8)
    with CurvatureService(max_batch=8, max_wait_us=100.0, start=False,
                          admission=adm) as svc:
        fut = svc.submit(p, a, v, client="c")
        with pytest.raises(Exception, match="rate"):
            svc.submit(p, a, v, client="c")
        svc.flush()
        fut.result(timeout=30)
        reg = obs.metrics_registry()
        assert reg.value("repro_admission_shed_total", reason="rate") == \
            svc.stats()["admission"]["shed_rate"] == 1
        shed = [t for t in obs.recorder().recent(16) if t.meta.get("error")]
        assert shed and shed[0].meta["error"] == "ServiceOverloaded"


# ---------------------------------------------------------------------------
# profiling: torch.profiler sessions and per-bucket annotations
# ---------------------------------------------------------------------------

def test_profile_session_traces_the_dispatch_workers_annotation(tmp_path):
    """A running service's worker thread executes the bucket; the session's
    Chrome trace names its ``repro:<workload>:<backend>:b<bucket>``
    range."""
    p = engine.plan(testfns.rosenbrock, 8, csize=2, symmetric=False,
                    device="cpu")
    assert not obs.is_active()
    with CurvatureService(max_batch=4, max_wait_us=1e6) as svc:
        with obs.profile_session(str(tmp_path)) as where:
            assert where == str(tmp_path) and obs.is_active()
            with pytest.raises(RuntimeError, match="already active"):
                with obs.profile_session(str(tmp_path)):
                    pass
            futs = [svc.submit(p, *_xv(8, seed=i)) for i in range(4)]
            for f in futs:
                f.result(timeout=60)
    assert not obs.is_active()
    (path,) = glob.glob(os.path.join(str(tmp_path),
                                     "repro_torch_trace_*.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "repro:batched_hvp:vmap_l2:b4" in names


def test_annotate_is_a_no_op_outside_a_session():
    import contextlib
    assert isinstance(obs.annotate("x"), contextlib.nullcontext)


# ---------------------------------------------------------------------------
# end to end: traces + metrics over the wire
# ---------------------------------------------------------------------------

def _frontend(**kw):
    from repro_torch.serving.frontend import CurvatureFrontend
    fam = testfns.ragged_family("rosenbrock")
    plans = {"rosenbrock": lambda n: engine.plan(fam, n, symmetric=False,
                                                 device="cpu")}
    return CurvatureFrontend(plans, max_batch=8, max_wait_us=200.0, **kw)


def test_wire_traces_cover_the_full_request_path():
    from repro_torch.serving.frontend import connect
    adm = AdmissionController(default_policy=ClientPolicy(rate=1000.0,
                                                          burst=100))
    with _frontend(admission=adm) as fe:
        with connect(*fe.address, client="e2e") as cli:
            cli.hvp("rosenbrock", *_xv(8, seed=3))
            traces = []
            for _ in range(100):
                traces = cli.trace(k=8)["traces"]
                if traces:
                    break
            assert traces, "no trace reached the flight recorder"
            names = [s["name"] for s in traces[0]["spans"]]
            for want in ("admit", "enqueue", "coalesce", "dispatch_wait",
                         "device_execute", "respond"):
                assert want in names, f"span {want!r} missing: {names}"
            assert traces[0]["meta"]["client"] == "e2e"
            j = cli.metrics()
            assert j["repro_points_total"]["series"][0]["value"] >= 1
            text = cli.metrics(format="prometheus")
            assert "# TYPE repro_requests_total counter" in text
            assert "repro_span_duration_us_bucket" in text


def test_wire_slow_ring_events_and_http_exporter():
    import urllib.request

    from repro_torch.obs.http import start_metrics_server
    from repro_torch.serving.frontend import connect
    obs.event("retune", plan="rosenbrock", trigger="test")
    srv = start_metrics_server(port=0)
    try:
        with _frontend() as fe:
            with connect(*fe.address, client="slowpoke") as cli:
                cli.hvp("rosenbrock", *_xv(8))
                for _ in range(100):
                    got = cli.trace(k=4, slow=True)
                    if got["traces"]:
                        break
                assert got["traces"][0]["meta"]["client"] == "slowpoke"
                assert "retune" in [e["kind"] for e in got["events"]]
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert "repro_points_total" in r.read().decode()
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert r.read() == b"ok\n"
    finally:
        srv.close()
