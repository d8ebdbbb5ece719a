"""repro_torch.serving against the reference's serving stack
(tests/test_serving.py is the template): masked ragged families and the
ragged callable against the JAX forms and ragged executable (rtol 1e-5,
atol 1e-5), cross-n coalescing and its padding-waste gate, admission
shedding, the fair scheduler's dequeue orders against the JAX scheduler's
on the same submits, the wire protocol byte for byte, the TCP front-end,
the server's selftest and its refusals, and the family plans' route to the
cuda backend on a CUDA plan."""

import collections
import dataclasses
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro.core import testfns as jtestfns  # noqa: E402
from repro.engine import opmodel as jopmodel  # noqa: E402
from repro.serving import protocol as jprotocol  # noqa: E402
from repro.serving import scheduler as jscheduler  # noqa: E402
from repro.serving import admission as jadmission  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core import testfns  # noqa: E402
from repro_torch.engine import opmodel  # noqa: E402
from repro_torch.engine.service import CurvatureService  # noqa: E402
from repro_torch.serving import (AdmissionController, ClientPolicy,  # noqa
                                 Scheduler, ServiceClosed, ServiceOverloaded,
                                 TokenBucket, protocol)

ROOT = Path(__file__).resolve().parents[1]
NS = (8, 12, 16)
TOL = dict(rtol=1e-5, atol=1e-5)


def _xv(n, seed=0):
    rng = np.random.RandomState(seed)
    return (np.asarray(rng.uniform(-2, 2, n), np.float32),
            np.asarray(rng.randn(n), np.float32))


def _fam_plans(name="rosenbrock", ns=NS):
    fam = testfns.ragged_family(name)
    return fam, {n: engine.plan(fam, n, symmetric=False, device="cpu")
                 for n in ns}


def _jplan(n=8):
    return jengine.plan(jtestfns.rosenbrock, n, csize=2, symmetric=False)


def _plan(n=8):
    return engine.plan(testfns.rosenbrock, n, csize=2, symmetric=False,
                       device="cpu")


# ---------------------------------------------------------------------------
# masked families and the ragged callable, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rosenbrock", "ackley"])
@pytest.mark.parametrize("n_eff", [1, 7, 12])
def test_masked_family_matches_jax_and_the_dense_function(name, n_eff):
    """masked(x_pad, n_eff) == f(x_pad[:n_eff]) and == the JAX masked form,
    for a Python n_eff and a tensor one."""
    fam, jfam = testfns.ragged_family(name), jtestfns.ragged_family(name)
    x, _ = _xv(12, seed=3)
    want = np.asarray(jfam.masked(jnp.asarray(x), n_eff))
    got = fam.masked(torch.from_numpy(x), n_eff)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    got_t = fam.masked(torch.from_numpy(x), torch.tensor(n_eff))
    np.testing.assert_allclose(got_t.numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.numpy(), fam.fn(torch.from_numpy(x[:n_eff])).numpy(),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["rosenbrock", "ackley"])
def test_ragged_rows_match_jax_ragged_executable(name):
    """The batched_hvp_ragged callable's rows against the reference's
    ragged executable on the same padded bucket; the prefix also matches
    each width's own dense plan, and masking is exact past it."""
    n_pad, ns = 16, [16, 12, 8, 5, 16]
    rng = np.random.RandomState(11)
    A = rng.uniform(-2, 2, (len(ns), n_pad)).astype(np.float32)
    V = rng.randn(len(ns), n_pad).astype(np.float32)
    NE = np.asarray(ns, np.int32)
    fam, jfam = testfns.ragged_family(name), jtestfns.ragged_family(name)
    gplan = engine.plan(fam, n_pad, symmetric=False, device="cpu")
    assert gplan.opt("ragged_family") is fam
    got = gplan.executable("batched_hvp_ragged")(
        torch.from_numpy(A), torch.from_numpy(V), torch.from_numpy(NE))
    want = jengine.plan(jfam, n_pad, symmetric=False).executable(
        "batched_hvp_ragged")(jnp.asarray(A), jnp.asarray(V),
                              jnp.asarray(NE))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i, n in enumerate(ns):
        dense = engine.plan(fam, n, symmetric=False, device="cpu").hvp(
            A[i, :n], V[i, :n])
        np.testing.assert_allclose(got[i, :n].numpy(), dense.numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got[i, n:].numpy(), 0.0, atol=1e-6)


def test_ragged_family_identity_and_refusal():
    fam = testfns.ragged_family("rosenbrock")
    assert testfns.ragged_family("rosenbrock") is fam
    other = engine.RaggedFamily("rosenbrock", testfns.rosenbrock)
    assert other == fam and hash(other) == hash(fam)
    assert fam.__name__ == "ragged:rosenbrock"
    with pytest.raises(ValueError, match="fletcher_powell|ragged"):
        testfns.ragged_family("fletcher_powell")


def test_family_plans_reach_the_cuda_backend_on_a_cuda_plan():
    """A family's dense plan computes fn(x), so its kernel forms are fn's:
    a CUDA plan of a family resolves batched_hvp to the cuda kernel."""
    from repro_torch.kernels.ops import kernel_form
    cuda = engine.get_backend("cuda")
    for name in ("rosenbrock", "ackley"):
        fam = testfns.ragged_family(name)
        fn = getattr(testfns, name)
        assert kernel_form(fam) == (fn, (), name)
        p = engine.plan(fam, 64, symmetric=False, device="cpu")
        assert p.backend_for("batched_hvp") == "vmap_l2"
        on_card = dataclasses.replace(p, device=torch.device("cuda", 0))
        assert cuda.can_run(on_card, "batched_hvp")
        assert on_card.backend_for("batched_hvp") == "cuda"
        assert cuda.priority > engine.get_backend("vmap_l2").priority
        # the ragged workload has no kernel, here as in the reference
        assert on_card.backend_for("batched_hvp_ragged") == "vmap_l2"
    # a family without a hand-written form reaches the kernel through the
    # form generated from a trace of fn; one whose fn does not trace (a
    # Python branch on a value) stays off the kernel
    quad = engine.RaggedFamily("quad", lambda x: (x * x).sum(0))
    p = dataclasses.replace(engine.plan(quad, 8, device="cpu"),
                            device=torch.device("cuda", 0))
    assert kernel_form(quad)[2] is None
    assert p.backend_for("batched_hvp") == "cuda"

    def branch(x):
        return (x * x).sum(0) if float(x.val[0]) > 0 else x.sum(0)
    fam = engine.RaggedFamily("branch", branch)
    p = dataclasses.replace(engine.plan(fam, 8, device="cpu"),
                            device=torch.device("cuda", 0))
    assert p.backend_for("batched_hvp") == "vmap_l2"


def test_default_masked_form_zero_masks_the_input():
    quad = engine.RaggedFamily("quad", lambda x: (x * x).sum(0))
    x = torch.arange(1.0, 7.0)
    assert quad.masked(x, 3).item() == pytest.approx(1 + 4 + 9)


# ---------------------------------------------------------------------------
# cross-n coalescing
# ---------------------------------------------------------------------------

def test_mixed_n_clients_share_one_ragged_bucket():
    """Two clients, three widths, one flush -> ONE ragged batch whose
    results match the reference's dense plans, witnessed in telemetry."""
    engine.clear_telemetry()
    fam, plans = _fam_plans()
    jfam = jtestfns.ragged_family("rosenbrock")
    svc = CurvatureService(max_batch=16, max_wait_us=100.0, start=False)
    reqs = []
    for i, n in enumerate(list(NS) * 2):
        a, v = _xv(n, seed=i)
        cid = f"cli-{i % 2}"
        reqs.append((n, a, v, svc.submit(plans[n], a, v, client=cid)))
    svc.flush()
    for n, a, v, fut in reqs:
        want = jengine.plan(jfam, n, symmetric=False).hvp(a, v)
        np.testing.assert_allclose(fut.result(timeout=30), np.asarray(want),
                                   **TOL)
    s = svc.stats()
    assert s["batches"] == 1 and s["ragged_batches"] == 1
    assert s["ragged_points"] == len(reqs)
    assert s["cross_n_fills"] >= len(NS) - 1
    cs = engine.client_stats()
    assert cs["cli-0"]["points"] == 3 and cs["cli-1"]["points"] == 3
    (rec,) = engine.execution_stats()
    assert rec["workload"] == "batched_hvp_ragged"
    assert rec["backend"] == "vmap_l2"
    svc.shutdown()


@pytest.mark.parametrize("kw", [{"coalesce_waste_max": 0.1},
                                {"coalesce_across_n": False}])
def test_widths_stay_per_n_when_merging_is_refused(kw):
    """A tight waste gate (n=8 padded to 16 wastes 0.25 > 0.1), or cross-n
    off: every width dispatches dense on its own."""
    fam, plans = _fam_plans()
    svc = CurvatureService(max_batch=16, max_wait_us=100.0, start=False,
                           **kw)
    futs = []
    for n in NS:
        a, v = _xv(n)
        futs.append(svc.submit(plans[n], a, v))
    svc.flush()
    for fut in futs:
        fut.result(timeout=30)
    s = svc.stats()
    assert s["batches"] == len(NS) and s["ragged_batches"] == 0
    svc.shutdown()


def test_full_dense_bucket_is_never_diluted():
    fam, plans = _fam_plans()
    svc = CurvatureService(max_batch=2, max_wait_us=100.0, start=False)
    futs = []
    for i in range(2):                      # full bucket of n=8
        a, v = _xv(8, seed=i)
        futs.append(svc.submit(plans[8], a, v))
    a, v = _xv(16, seed=9)
    futs.append(svc.submit(plans[16], a, v))
    svc.flush()
    for fut in futs:
        fut.result(timeout=30)
    s = svc.stats()
    assert s["ragged_batches"] == 0 and s["batches"] == 2
    svc.shutdown()


def test_ragged_member_queues_exempt_from_retune():
    fam, plans = _fam_plans()
    calls = []

    def tuner(plan, workload, buckets, force, deadline_s):
        calls.append(dict(buckets))
        return {}

    svc = CurvatureService(max_batch=8, max_wait_us=100.0, start=False,
                           tuner=tuner, retune_min_points=1,
                           tune_dispatch=False)
    for n in NS:
        a, v = _xv(n)
        svc.submit(plans[n], a, v)
    svc.flush()
    rep = svc.retune()
    assert rep["queues_tuned"] == 0 and calls == []
    svc.shutdown()


# ---------------------------------------------------------------------------
# the op models, exactly equal to the reference's
# ---------------------------------------------------------------------------

def test_ragged_padding_waste_equals_reference():
    cases = [([8], None), ([8, 12, 16], None), ([4, 128], None),
             ([48, 56, 64, 64], None), ([5, 7], 16), ([1, 1, 3], 3)]
    for ns, n_pad in cases:
        assert opmodel.ragged_padding_waste(ns, n_pad) == \
            jopmodel.ragged_padding_waste(ns, n_pad)
    for bad in ([], [0, 4]):
        with pytest.raises(ValueError):
            opmodel.ragged_padding_waste(bad)
    with pytest.raises(ValueError):
        opmodel.ragged_padding_waste([8, 16], 12)


def test_suggest_dispatch_knobs_equals_reference():
    tables = [{4: 2.0, 8: 1.0, 64: 0.5}, {4: 2.0, 8: 1.0}, {1: 3.0},
              {4: None, 8: 0.0, 16: 1.5, 512: 0.1}, {}]
    for rate in (None, 0.0, 1.0, 1000.0, 1e5, 3.7e6):
        for us in tables:
            for cap, mb in ((5000.0, 256), (200.0, 8)):
                assert opmodel.suggest_dispatch_knobs(
                    rate, us, wait_cap_us=cap, max_batch_cap=mb) == \
                    jopmodel.suggest_dispatch_knobs(
                        rate, us, wait_cap_us=cap, max_batch_cap=mb)


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------

def test_token_bucket_refill_and_retry_after():
    tb = TokenBucket(rate=10.0, burst=2)
    assert tb.try_take(0.0) and tb.try_take(0.0)
    assert not tb.try_take(0.0)
    assert tb.retry_after() == pytest.approx(0.1)
    assert tb.try_take(0.1)


def test_rate_limited_client_sheds_with_retry_hint():
    now = [0.0]
    adm = AdmissionController(default_policy=ClientPolicy(rate=1.0, burst=2),
                              clock=lambda: now[0])
    p = _plan()
    a, v = _xv(8)
    svc = CurvatureService(max_batch=8, max_wait_us=100.0, start=False,
                           admission=adm)
    futs = [svc.submit(p, a, v, client="chatty") for _ in range(2)]
    with pytest.raises(ServiceOverloaded) as ei:
        svc.submit(p, a, v, client="chatty")
    assert ei.value.retry_after_s > 0
    futs.append(svc.submit(p, a, v, client="quiet"))
    svc.flush()
    for f in futs:
        f.result(timeout=30)
    assert svc.stats()["admission"]["shed_rate"] == 1
    svc.shutdown()


def _shed_sequence(pkg_engine, svc_cls, plan):
    """The reference's high-water scenario; returns which submits shed."""
    a, v = _xv(8)
    adm = pkg_engine.AdmissionController(high_water=4,
                                         interactive_headroom=1.5)
    svc = svc_cls(max_batch=64, max_wait_us=1e6, start=False, admission=adm)
    shed = []
    for pr in ["batch"] * 5 + ["interactive"] * 3 + ["batch"]:
        try:
            svc.submit(plan, a, v, priority=pr)
            shed.append((pr, False))
        except Exception as e:               # ServiceOverloaded of either
            assert type(e).__name__ == "ServiceOverloaded"
            shed.append((pr, True))
    stats = adm.stats()
    svc.flush()
    svc.shutdown()
    return shed, stats


def test_high_water_shedding_order_equals_reference():
    from repro.engine.service import CurvatureService as JService
    got = _shed_sequence(engine, CurvatureService, _plan())
    want = _shed_sequence(jengine, JService, _jplan())
    assert got == want
    assert got[1]["shed_depth"] == 3


def test_unknown_priority_rejected_at_submit():
    with CurvatureService(start=False) as svc:
        with pytest.raises(ValueError, match="priority"):
            svc.submit(_plan(), *_xv(8), priority="urgent")


# ---------------------------------------------------------------------------
# scheduler: strict priority + weighted fairness, against the reference
# ---------------------------------------------------------------------------

def _bare(mod, adm_mod, policies=None, **kw):
    stats = collections.Counter()
    stats["buckets"] = collections.Counter()
    adm = None
    if policies is not None:
        adm = adm_mod.AdmissionController(policies={
            c: adm_mod.ClientPolicy(weight=w) for c, w in policies.items()})
    return mod.Scheduler(max_batch=kw.pop("max_batch", 8),
                         max_wait_us=100.0, max_queue=4096,
                         clock=lambda: 0.0, stats=stats, admission=adm, **kw)


def _orders(sched, plans, submits, rounds):
    """Submit (plan index, client, priority) triples, then take ``rounds``
    forced batches; returns [(n, [(client, priority), ...]), ...]."""
    for k, client, pr in submits:
        a, v = _xv(plans[k].n, seed=k)
        sched.submit(plans[k], a, v, client=client, priority=pr)
    out = []
    for _ in range(rounds):
        batch = sched.take_ready_batch(0.0, force=True)
        if batch is None:
            break
        q, reqs = batch
        out.append((q.plan.n, [(r.client, r.priority) for r in reqs]))
    return out


SCENARIOS = {
    "interactive_first": (None, 4, [(0, "c", "batch")] * 4
                          + [(0, "c", "interactive")] * 3, 3),
    "weighted_fair": ({"fast": 2.0}, 6, [(0, "fast", "batch")] * 6
                      + [(0, "slow", "batch")] * 6, 2),
    "late_arrival": (None, 4, [(0, "greedy", "batch")] * 12
                     + [(0, "late", "batch")], 4),
    "cross_queue": ({"vip": 4.0}, 2, [(0, "vip", "batch")] * 12
                    + [(1, "std", "batch")] * 12, 5),
    "untagged_fifo": (None, 8, [(0, None, "batch")] * 5, 1),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_dequeue_orders_equal_reference(scenario):
    policies, max_batch, submits, rounds = SCENARIOS[scenario]
    from repro_torch.serving import admission, scheduler
    got = _orders(_bare(scheduler, admission, policies, max_batch=max_batch),
                  [_plan(8), _plan(12)], submits, rounds)
    want = _orders(_bare(jscheduler, jadmission, policies,
                         max_batch=max_batch),
                   [_jplan(8), _jplan(12)], submits, rounds)
    assert got == want and got


def test_interactive_drains_strictly_before_batch():
    from repro_torch.serving import admission, scheduler
    got = _orders(_bare(scheduler, admission, max_batch=4), [_plan()],
                  SCENARIOS["interactive_first"][2], 1)
    assert [pr for _, pr in got[0][1]] == ["interactive"] * 3 + ["batch"]


def test_weighted_fair_dequeue_prevents_starvation():
    from repro_torch.serving import admission, scheduler
    got = _orders(_bare(scheduler, admission, {"fast": 2.0}, max_batch=6),
                  [_plan()], SCENARIOS["weighted_fair"][2], 1)
    clients = [c for c, _ in got[0][1]]
    assert clients.count("fast") == 4 and clients.count("slow") == 2


def test_scheduler_isinstance_and_pytree_diag_refused():
    sched = _bare(__import__("repro_torch.serving.scheduler",
                             fromlist=["Scheduler"]), None)
    assert isinstance(sched, Scheduler)
    p = dataclasses.replace(_plan(), n=None)
    tree = {"w": np.ones(3, np.float32)}
    # pytree diag submits are ported (ROADMAP A.4): a seed row and the
    # probe budget ride with the request, capped by the plan's n_probes
    fut = sched.submit(p, tree, 7, workload="diag", n_probes=2)
    (q,) = sched.queues.values()
    (req,) = q.requests
    assert q.workload == "batched_diag" and q.spec is not None
    assert (int(req.v), req.p) == (7, 2) and not fut.done()
    with pytest.raises(ValueError, match="out of range"):
        sched.submit(p, tree, 7, workload="diag", n_probes=5)
    with pytest.raises(ValueError, match="seed"):
        sched.submit(p, tree, workload="diag")
    with pytest.raises(ValueError, match="workload"):
        sched.submit(_plan(), *_xv(8), workload="diag")


# ---------------------------------------------------------------------------
# transport: wire protocol + socket front-end
# ---------------------------------------------------------------------------

FRAMES = [
    {"id": 1, "method": "hvp", "plan": "rosenbrock", "n": 3,
     "a": [0.5, -1.25, 2.0], "v": [1.0, 0.0, -3.5], "client": "c0",
     "priority": "interactive"},
    {"id": 2, "method": "ping"},
    {"id": 3, "ok": True, "result": [[1.0, 2.0], [3.0, 4.5]]},
    {"id": "x", "method": "trace", "k": 4, "slow": True},
]


def test_protocol_encode_is_byte_identical_to_reference():
    for frame in FRAMES:
        assert protocol.encode(frame) == jprotocol.encode(frame)
        assert protocol.decode(protocol.encode(frame)) == frame
    from repro_torch.serving import ServiceQueueFull
    pairs = [(ServiceOverloaded("slow down", 0.25),
              jadmission.ServiceOverloaded("slow down", 0.25)),
             (ServiceQueueFull("full"), jadmission.ServiceQueueFull("full")),
             (ServiceClosed("x"), jadmission.ServiceClosed("x")),
             (ValueError("bad"), ValueError("bad")),
             (RuntimeError("boom"), RuntimeError("boom"))]
    for exc, jexc in pairs:
        assert protocol.encode(protocol.error_frame(7, exc)) == \
            jprotocol.encode(jprotocol.error_frame(7, jexc))
    assert protocol.METHODS == jprotocol.METHODS


def test_protocol_roundtrip_and_error_codes():
    with pytest.raises(ValueError):
        protocol.decode(b"not json\n")
    err = protocol.error_frame(3, ServiceOverloaded("slow down", 0.25))
    assert err["error"]["code"] == "overloaded"
    exc = protocol.exception_for(err["error"]["code"],
                                 err["error"]["message"],
                                 err["error"].get("retry_after_s", 0.0))
    assert isinstance(exc, ServiceOverloaded)
    assert exc.retry_after_s == pytest.approx(0.25)
    assert isinstance(protocol.exception_for("closed", "x", 0.0),
                      ServiceClosed)


def test_frontend_roundtrips_results_and_typed_errors():
    """A round trip on 127.0.0.1 against the reference's dense plans."""
    from repro_torch.serving.frontend import CurvatureFrontend, connect
    fam = testfns.ragged_family("rosenbrock")
    jfam = jtestfns.ragged_family("rosenbrock")
    plans = {"rosenbrock": lambda n: engine.plan(fam, n, symmetric=False,
                                                 device="cpu")}
    with CurvatureFrontend(plans, max_batch=8, max_wait_us=200.0) as fe:
        host, port = fe.address
        with connect(host, port, client="t") as cli:
            assert cli.ping() == "pong"
            assert cli.plans() == {"rosenbrock": {"family": True}}
            a, v = _xv(8, seed=5)
            jp = jengine.plan(jfam, 8, symmetric=False)
            np.testing.assert_allclose(cli.hvp("rosenbrock", a, v),
                                       np.asarray(jp.hvp(a, v)), **TOL)
            np.testing.assert_allclose(cli.hessian("rosenbrock", a),
                                       np.asarray(jp.hessian(a)), **TOL)
            with pytest.raises(ValueError):          # unknown plan name
                cli.hvp("nope", a, v)
            assert cli.stats()["batches"] >= 1


def test_frontend_maps_admission_rejections_onto_the_wire():
    from repro_torch.serving.frontend import CurvatureFrontend, connect
    fam = testfns.ragged_family("rosenbrock")
    plans = {"rosenbrock": lambda n: engine.plan(fam, n, symmetric=False,
                                                 device="cpu")}
    adm = AdmissionController(default_policy=ClientPolicy(rate=0.001,
                                                          burst=1))
    with CurvatureFrontend(plans, max_batch=8, max_wait_us=200.0,
                           admission=adm) as fe:
        with connect(*fe.address, client="limited") as cli:
            a, v = _xv(8)
            cli.hvp("rosenbrock", a, v)              # burst token
            with pytest.raises(ServiceOverloaded) as ei:
                cli.hvp("rosenbrock", a, v)
            assert ei.value.retry_after_s > 0


def test_frontend_stop_is_idempotent_and_frees_the_port():
    from repro_torch.serving.frontend import CurvatureFrontend
    fam = testfns.ragged_family("rosenbrock")
    fe = CurvatureFrontend({"rosenbrock": lambda n: engine.plan(
        fam, n, symmetric=False, device="cpu")})
    fe.start()
    host, port = fe.address
    fe.stop()
    fe.stop()
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, port))
    s.close()


# ---------------------------------------------------------------------------
# close(): deterministic, idempotent, drains in-flight work
# ---------------------------------------------------------------------------

def test_close_drains_in_flight_futures_and_is_idempotent():
    p = _plan()
    rng = np.random.RandomState(0)
    svc = CurvatureService(max_batch=64, max_wait_us=1e6)   # never flushes
    futs = []
    for _ in range(9):
        a = np.asarray(rng.uniform(-2, 2, 8), np.float32)
        v = np.asarray(rng.randn(8), np.float32)
        futs.append((a, v, svc.submit(p, a, v)))
    svc.close()
    for a, v, fut in futs:
        assert fut.done()
        np.testing.assert_allclose(fut.result(timeout=0),
                                   p.hvp(a, v).numpy(), rtol=1e-4,
                                   atol=1e-4)
    svc.close()
    with pytest.raises(ServiceClosed):
        svc.submit(p, np.zeros(8, np.float32), np.zeros(8, np.float32))


def test_close_joins_the_retune_thread():
    p = _plan()
    a, v = _xv(8)
    svc = CurvatureService(max_batch=8, max_wait_us=100.0,
                           retune_interval_s=0.01,
                           tuner=lambda *args, **kw: {},
                           retune_min_points=1)
    svc.submit(p, a, v).result(timeout=30)
    t = svc._retune_thread
    assert t is not None and t.is_alive()
    svc.close()
    t.join(timeout=10)
    assert not t.is_alive()
    svc.close()


def test_concurrent_close_and_submits_race_cleanly():
    p = _plan()
    a, v = _xv(8)
    svc = CurvatureService(max_batch=8, max_wait_us=50.0)
    outcomes = []

    def spam():
        for _ in range(50):
            try:
                outcomes.append(svc.submit(p, a, v).result(timeout=30))
            except ServiceClosed:
                outcomes.append("closed")

    ts = [threading.Thread(target=spam) for _ in range(3)]
    for t in ts:
        t.start()
    svc.close()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert len(outcomes) == 150
    assert all(isinstance(o, np.ndarray) or o == "closed"
               for o in outcomes)


# ---------------------------------------------------------------------------
# the server entry point
# ---------------------------------------------------------------------------

def _serve(*args, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=240)


def test_serve_selftest_on_the_cpu():
    out = _serve("--device", "cpu", "--selftest")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "round-trips OK" in out.stdout
    assert "device cpu" in out.stdout


def test_serve_refusals(tmp_path):
    out = _serve("--selftest", env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "--device cpu" in out.stderr
    # the online re-tune is ported: the flag is accepted and the server
    # serves with its re-tune thread running (store: the test's own)
    out = _serve("--device", "cpu", "--retune-interval-s", "1",
                 "--selftest",
                 env_extra={"REPRO_TORCH_AUTOTUNE_CACHE": str(
                     tmp_path / "autotune.json")})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "round-trips OK" in out.stdout


def test_tuned_env_sets_only_the_preload():
    from repro_torch.launch import serve
    assert set(serve.tuned_env()) <= {"LD_PRELOAD",
                                      "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"}
    plans = serve.build_plans(["rosenbrock", "ackley", "fletcher_powell"],
                              device="cpu")
    p = plans["fletcher_powell"](6)
    assert p.device == torch.device("cpu") and p.n == 6
    assert plans["rosenbrock"](8).opt("ragged_family") is \
        testfns.ragged_family("rosenbrock")
    with pytest.raises(SystemExit):
        serve.build_plans(["nope"], device="cpu")
