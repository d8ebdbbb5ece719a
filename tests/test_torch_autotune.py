"""repro_torch.engine.autotune against the reference's joint autotuner
(tests/test_autotune.py is the template): the op model's probe helpers and
the sweep grid equal the reference's, the telemetry consult follows the
same best-us trajectory and pick, an autotuned CPU plan's batched_hvp
equals the JAX engine's on the same seeded numpy inputs (rtol 2e-3, atol
2e-3, the engine tests' tolerance); then the port's own behaviour:
fingerprints (tensors by content), best-of-k timing, the store (its own
env var, the plan's device in the key), a warm process that plans with
zero probes, and the ``cuda`` backend's instances-per-CTA dial on a fake
CUDA plan (no card here)."""

import json
import os
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.engine.autotune  # noqa: E402,F401
from repro import engine as jengine  # noqa: E402
from repro.core import testfns as jtestfns  # noqa: E402
from repro.engine import opmodel as jopmodel  # noqa: E402
from repro.engine import registry as jregistry  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core import testfns  # noqa: E402
from repro_torch.engine import opmodel, registry  # noqa: E402
from repro_torch.kernels import chess_hvp as ck  # noqa: E402

# the engine packages re-export the autotune FUNCTION under the submodule's
# name: the modules come from sys.modules
import repro_torch.engine.autotune  # noqa: E402,F401
at = sys.modules["repro_torch.engine.autotune"]
jat = sys.modules["repro.engine.autotune"]

ROOT = Path(__file__).resolve().parents[1]
N, M = 8, 16
FNS = ("rosenbrock", "ackley", "fletcher_powell")
CUDA0 = torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    """Each test tunes into its own store and starts (and leaves) no
    in-memory tuner or telemetry state in either package."""
    monkeypatch.setenv(at.STORE_ENV, str(tmp_path / "autotune.json"))
    monkeypatch.setenv(jat.STORE_ENV, str(tmp_path / "reference.json"))
    for pkg in (engine, jengine):
        pkg.clear_autotune_cache()
        pkg.clear_telemetry()
    yield
    for pkg in (engine, jengine):
        pkg.clear_autotune_cache()
        pkg.clear_telemetry()


def _data(m, n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-2, 2, (m, n)).astype(np.float32),
            rng.randn(m, n).astype(np.float32))


def _fake_cuda(plan):
    """A CPU plan moved onto a card this machine does not have: resolution
    and the grid run, nothing launches."""
    return replace(plan, device=CUDA0)


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(1, 16), (17, 32), (33, 48), (49, 64)])
def test_probe_helpers_equal_reference(lo, hi):
    for n_probes in range(lo, hi + 1):
        assert (opmodel.probe_csize_candidates(n_probes)
                == jopmodel.probe_csize_candidates(n_probes))
        assert (opmodel.model_csize_probes(n_probes)
                == jopmodel.model_csize_probes(n_probes))
        for c in opmodel.probe_csize_candidates(n_probes):
            assert (opmodel.probe_chunk_cost(n_probes, c)
                    == jopmodel.probe_chunk_cost(n_probes, c))
    with pytest.raises(ValueError):
        opmodel.probe_csize_candidates(0)


@pytest.mark.parametrize("workload", ["batched_hvp", "hvp", "hessian"])
@pytest.mark.parametrize("n,symmetric", [(8, False), (13, True), (64, True)])
def test_combo_grid_order_equals_reference_on_a_cpu_plan(n, symmetric,
                                                         workload):
    """Same csize order per backend (model argmin first), and the same
    order among the backends both packages register."""
    f, jf = testfns.rosenbrock, jtestfns.rosenbrock
    mm = at._probe_m(M)
    base = engine.plan(f, n, m=mm, csize=1, symmetric=symmetric,
                       device="cpu")
    got = at._combo_grid(engine.function_fingerprint(f), base, workload)
    want = jat._combo_grid(jengine.function_fingerprint(jf), n, mm,
                           symmetric, "auto", None, workload, False)
    shared = {bk for bk, _, _ in got} & {bk for bk, _, _ in want}
    assert shared >= {"vmap_l0", "vmap_l1", "vmap_l2"}
    assert "cuda" not in {bk for bk, _, _ in got}      # a CPU plan
    assert ([c for c in got if c[0] in shared]
            == [c for c in want if c[0] in shared])


def test_telemetry_best_trajectory_and_pick_equal_reference():
    """One record_execution sequence with an injected clock, through both
    registries: the same windowed, age-decayed best_us after every record,
    and the same _telemetry_best pick."""
    p = engine.plan(testfns.ackley, N, m=M, csize=2, symmetric=False,
                    device="cpu")
    jp = jengine.plan(jtestfns.ackley, N, m=M, csize=2, symmetric=False)
    names = {b: engine.get_backend(b) for b in ("vmap_l0", "vmap_l1",
                                                  "vmap_l2")}
    jnames = {b: jengine.get_backend(b) for b in names}
    fp = engine.function_fingerprint(p.f)
    jfp = jengine.function_fingerprint(jp.f)
    rng = np.random.RandomState(11)
    seq = [(b, float(rng.uniform(1e-5, 1e-3)), 90.0 * k)
           for k, b in enumerate(rng.choice(sorted(names), 150))]
    for k, (b, elapsed, now) in enumerate(seq):
        sig, jsig = p.cache_key("batched_hvp", b), jp.cache_key(
            "batched_hvp", b)
        registry.record_execution(sig, b, "batched_hvp", bucket=8,
                                  n_points=8, elapsed_s=elapsed, now=now)
        jregistry.record_execution(jsig, b, "batched_hvp", bucket=8,
                                   n_points=8, elapsed_s=elapsed, now=now)
        assert (registry._TELEMETRY[sig]["best_us"]
                == jregistry._TELEMETRY[jsig]["best_us"]), k
        pick = registry._telemetry_best(p, "batched_hvp", names, fp)
        assert pick == jregistry._telemetry_best(jp, "batched_hvp", jnames,
                                                 jfp), k
    assert p.backend_for("batched_hvp") == pick


def test_dtype_policy_error_parity_with_reference():
    """bf16 duals: under DEFAULT_DTYPE_TOL in both packages, the port's
    normalized oracle error within a factor 4 of the reference's (the two
    round bf16 tangents in different op orders), and a policy held to a
    tolerance below its error is rejected in both."""
    p = engine.plan(testfns.rosenbrock, N, csize=2, symmetric=False,
                    dtype_policy="bf16", device="cpu")
    jp = jengine.plan(jtestfns.rosenbrock, N, csize=2, symmetric=False,
                      dtype_policy="bf16")
    err = engine.verify_dtype_policy(p)
    jerr = jengine.verify_dtype_policy(jp)
    assert 0.0 < err < engine.DEFAULT_DTYPE_TOL == jat.DEFAULT_DTYPE_TOL
    assert 0.0 < jerr < jat.DEFAULT_DTYPE_TOL
    assert jerr / 4 <= err <= 4 * jerr
    strict = replace(p, options=p.options + (("dtype_tol", 1e-9),))
    jstrict = jengine.plan(jtestfns.rosenbrock, N, csize=2, symmetric=False,
                           dtype_policy="bf16", dtype_tol=1e-9)
    with pytest.raises(engine.DtypePolicyRejected):
        engine.verify_dtype_policy(strict)
    with pytest.raises(jengine.DtypePolicyRejected):
        jengine.verify_dtype_policy(jstrict)
    assert engine.verify_dtype_policy(strict, raise_on_reject=False) > 1e-9
    assert engine.verify_dtype_policy(
        engine.plan(testfns.rosenbrock, N, csize=2, device="cpu")) == 0.0


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("fname", FNS)
def test_autotuned_plan_matches_jax_engine(fname, symmetric):
    p = engine.plan(testfns.FUNCTIONS[fname](N), N, m=M, csize="autotune",
                    symmetric=symmetric, device="cpu")
    cfg = engine.lookup_tuned(p, "batched_hvp")
    assert cfg is not None and cfg.source == "sweep"
    assert p.csize == cfg.csize and p.backend == "auto"
    assert p.backend_for("batched_hvp") == cfg.backend
    assert cfg.trials and not cfg.failures and cfg.sweep_s > 0
    assert min(t for *_, t in cfg.trials) == cfg.time_s
    A, V = _data(M, N, seed=7)
    jp = jengine.plan(jtestfns.FUNCTIONS[fname](N), N, m=M, csize="auto",
                      symmetric=symmetric)
    want = np.asarray(jp.batched_hvp(jnp.asarray(A), jnp.asarray(V)))
    np.testing.assert_allclose(p.batched_hvp(A, V).numpy(), want,
                               rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# function identity
# ---------------------------------------------------------------------------

def test_fingerprint_stable_and_content_sensitive():
    fp1 = engine.function_fingerprint(testfns.rosenbrock)
    assert fp1 == engine.function_fingerprint(testfns.rosenbrock)
    assert fp1.startswith("rosenbrock:")
    assert fp1 != engine.function_fingerprint(testfns.ackley)

    def make(c):
        def f(x):
            return ((x * c) * x).sum(0)
        return f

    assert (engine.function_fingerprint(make(2.0))
            != engine.function_fingerprint(make(3.0)))
    assert (engine.function_fingerprint(make(2.0))
            == engine.function_fingerprint(make(2.0)))


def test_fingerprint_hashes_tensors_in_closures_by_content():
    def make(t):
        def f(x):
            return (x * t).sum(0)
        return f

    a = make(torch.arange(4.0))
    assert (engine.function_fingerprint(a)
            == engine.function_fingerprint(make(torch.arange(4.0))))
    assert (engine.function_fingerprint(a)
            != engine.function_fingerprint(make(torch.arange(4.0) + 1)))
    assert (engine.function_fingerprint(make(torch.ones(2, 2)))
            != engine.function_fingerprint(make(torch.ones(4))))
    assert (engine.function_fingerprint(make(torch.ones(4)))
            != engine.function_fingerprint(
                make(torch.ones(4, dtype=torch.bfloat16))))
    # Fletcher-Powell closes over its coefficient tensors
    fps = {engine.function_fingerprint(g)
           for g in (testfns.make_fletcher_powell(8),
                     testfns.make_fletcher_powell(8, seed=1964),
                     testfns.make_fletcher_powell(16))}
    assert len(fps) == 3
    fam = testfns.ragged_family("rosenbrock")     # __slots__, no weakref
    assert (engine.function_fingerprint(fam)
            == engine.function_fingerprint(fam))
    assert (engine.function_fingerprint(fam)
            != engine.function_fingerprint(testfns.ragged_family("ackley")))


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def test_time_once_best_of_k_and_deadline():
    calls = []

    def fn():
        calls.append(time.perf_counter())
        time.sleep(0.02)

    t = at._time_once(fn, reps=3, deadline_s=None)
    assert len(calls) == 4              # 1 warmup + 3 timed
    assert 0.015 <= t <= 0.2
    calls.clear()
    before = engine.probe_count()
    at._time_once(fn, reps=50, deadline_s=0.05)
    assert 2 <= len(calls) <= 10
    assert engine.probe_count() == before + len(calls)


def test_failed_candidates_are_listed_and_never_measured(monkeypatch):
    """A candidate that raises is skipped: it is not a trial, it is in the
    winner's failures, and the winner is a candidate that ran."""
    real = at._time_once

    def flaky(fn, **kw):
        if fn.func.__self__.csize == 2:     # the probe plan of the call
            raise RuntimeError("kernel launch failed")
        return real(fn, **kw)

    monkeypatch.setattr(at, "_time_once", flaky)
    cfg = engine.autotune(testfns.rosenbrock, N, m=M, reps=1,
                          symmetric=False, device="cpu")
    assert cfg.csize != 2 and cfg.failures
    assert all(c == 2 and "launch failed" in err
               for _bk, c, _bm, err in cfg.failures)
    assert all(c != 2 for _bk, c, _bm, _t in cfg.trials)

    def broken(fn, **kw):
        raise RuntimeError("no kernel")

    monkeypatch.setattr(at, "_time_once", broken)
    with pytest.raises(RuntimeError, match="no .* candidate ran"):
        engine.autotune(testfns.ackley, N, m=M, reps=1, device="cpu")


def test_workloads_that_wait_for_pytree_curvature():
    """Pytree curvature is ported: the diag workload sweeps the probe-chunk
    axis (the divisors of n_probes) on pytree_fwdrev, pytree plans tune by
    example, in memory only; a pytree tune without an example and an
    untunable workload still raise."""
    cfg = engine.autotune(testfns.rosenbrock, N, workload="diag",
                          device="cpu", reps=1)
    assert cfg.backend == "pytree_fwdrev"
    assert {c for _bk, c, _bm, _t in cfg.trials} == {1, 2, 4}
    assert cfg.csize == min(cfg.trials, key=lambda t: t[3])[1]

    def loss(t):
        return (t["w"] ** 4).sum() + (t["b"] ** 2).sum()

    tree = {"b": torch.ones(3), "w": torch.arange(4.0)}
    store = at.store_path()
    before = os.path.exists(store) and open(store).read()
    d = engine.autotune(loss, None, workload="diag", example=tree,
                        device="cpu", reps=1, options=(("n_probes", 8),))
    assert d.backend == "pytree_fwdrev" and 8 % d.csize == 0
    assert len(d.trials) == 4                    # csize 1, 2, 4, 8
    h = engine.autotune(loss, None, workload="hvp", example=tree,
                        device="cpu", reps=1)
    assert (h.backend, len(h.trials)) == ("pytree_fwdrev", 1)
    # memoized in-process, never persisted
    assert engine.autotune(loss, None, workload="diag", example=tree,
                           device="cpu", options=(("n_probes", 8),)) is d
    assert (os.path.exists(store) and open(store).read()) == before
    with pytest.raises(ValueError, match="example"):
        engine.autotune(testfns.rosenbrock, None, device="cpu")
    with pytest.raises(ValueError, match="pytree workloads"):
        engine.autotune(loss, None, workload="batched_hvp", example=tree,
                        device="cpu")
    with pytest.raises(ValueError, match="workload"):
        engine.autotune(testfns.rosenbrock, N, workload="quadform",
                        device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            engine.autotune(testfns.rosenbrock, N)   # the card by default


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

def test_store_round_trip_in_process():
    cfg = engine.autotune(testfns.rosenbrock, N, m=M, reps=1,
                          symmetric=False, device="cpu")
    path = at.store_path()
    assert path.endswith("autotune.json") and at.STORE_ENV == \
        "REPRO_TORCH_AUTOTUNE_CACHE" != jat.STORE_ENV
    (key, entry), = json.load(open(path)).items()
    assert key.startswith("rosenbrock:") and key.endswith("|auto|cpu")
    assert entry["csize"] == cfg.csize and entry["backend"] == cfg.backend
    assert entry["time_s"] > 0 and entry["torch"] == torch.__version__
    engine.clear_autotune_cache()
    probes = engine.probe_count()
    cfg2 = engine.autotune(testfns.rosenbrock, N, m=M, reps=1,
                           symmetric=False, device="cpu")
    assert engine.probe_count() == probes
    assert (cfg2.csize, cfg2.backend, cfg2.source) == (
        cfg.csize, cfg.backend, "disk")
    p = engine.plan(testfns.rosenbrock, N, m=M, csize="autotune",
                    symmetric=False, device="cpu")
    assert engine.probe_count() == probes
    assert p.backend_for("batched_hvp") == cfg.backend
    # the reference's store was never written, and never answers the port
    assert not os.path.exists(os.environ[jat.STORE_ENV])


def test_corrupt_store_is_ignored():
    with open(at.store_path(), "w") as fh:
        fh.write("{ not json")
    cfg = engine.autotune(testfns.rosenbrock, N, m=M, reps=1,
                          symmetric=False, device="cpu")
    assert cfg.source == "sweep"
    assert json.load(open(at.store_path()))   # repaired on save


@pytest.mark.parametrize("sentinel", ["", "0", "off"])
def test_store_disabled_by_env(sentinel, monkeypatch, tmp_path):
    monkeypatch.setenv(at.STORE_ENV, sentinel)
    monkeypatch.chdir(tmp_path)
    engine.clear_autotune_cache()
    cfg = engine.autotune(testfns.ackley, N, m=M, reps=1, symmetric=False,
                          device="cpu")
    assert cfg.source == "sweep"
    assert engine.load_store() == {} and engine.save_store() is None
    assert not list(tmp_path.iterdir())
    assert at.store_path().endswith(os.path.join("repro_torch",
                                                 "autotune.json"))


def test_platform_key_carries_the_device_name(monkeypatch):
    assert at._platform("cpu") == "cpu"
    assert at._platform(CUDA0).startswith("cuda:")
    monkeypatch.setattr(at, "_DEVICE_NAMES", {})
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert at._platform(CUDA0) == "cuda:NVIDIA_H100_80GB_HBM3"
    key = at._store_key("f:0", 64, "batched_hvp", True, 128, "auto",
                        at._platform(CUDA0))
    assert key.endswith("|m128|auto|cuda:NVIDIA_H100_80GB_HBM3")


def test_cpu_history_never_answers_a_card_plan():
    """A CPU tune record and CPU telemetry steer the CPU plan; the same
    plan moved onto a (fake) card resolves by its own history only: no
    tune record, no telemetry of its device, so the static pick, cuda."""
    f = testfns.rosenbrock
    cfg = engine.autotune(f, N, m=M, reps=1, symmetric=False,
                          device="cpu")
    p = engine.plan(f, N, m=M, csize=cfg.csize, symmetric=False,
                    device="cpu")
    slowest = next(b for b in ("vmap_l0", "vmap_l1", "vmap_l2")
                   if b != cfg.backend)
    assert engine.lookup_tuned(p, "batched_hvp") is not None
    card = _fake_cuda(p)
    assert engine.lookup_tuned(card, "batched_hvp") is None
    assert card.backend_for("batched_hvp") == "cuda"
    # telemetry too: a CPU signature never matches the card plan
    c_other = next(c for c in (1, 2, 4, 8) if c != cfg.csize)
    other = engine.plan(f, N, m=M, csize=c_other, symmetric=False,
                        device="cpu")
    engine.record_execution(other.cache_key("batched_hvp", slowest), slowest,
                            "batched_hvp", bucket=8, n_points=8,
                            elapsed_s=1e-9)
    assert other.backend_for("batched_hvp") == slowest
    assert _fake_cuda(other).backend_for("batched_hvp") == "cuda"
    engine.clear_telemetry()
    assert other.backend_for("batched_hvp") == "vmap_l2"


def test_store_survives_process_restart(tmp_path):
    """A fresh process with a warm store plans csize="autotune" without a
    single timed probe, to the same winner."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env[at.STORE_ENV] = str(tmp_path / "warm.json")
    script = (
        "import sys\n"
        "from repro_torch import engine\n"
        "from repro_torch.core import testfns\n"
        "p = engine.plan(testfns.make_fletcher_powell(6), 6, m=8,\n"
        "                csize='autotune', symmetric=False, device='cpu')\n"
        "cfg = engine.lookup_tuned(p, 'batched_hvp')\n"
        "print('PLAN', p.csize, p.backend_for('batched_hvp'), cfg.source,\n"
        "      engine.probe_count())\n"
        "assert not any(m == 'repro' or m.startswith(('repro.', 'jax'))\n"
        "               for m in sys.modules)\n")
    outs = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", script], env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        outs.append(out.stdout.split()[-5:])
    (tag1, c1, b1, src1, probes1), (tag2, c2, b2, src2, probes2) = outs
    assert tag1 == tag2 == "PLAN"
    assert src1 == "sweep" and int(probes1) > 0
    assert src2 == "disk" and int(probes2) == 0
    assert (c1, b1) == (c2, b2)


# ---------------------------------------------------------------------------
# the cuda backend's instances-per-CTA dial (fake CUDA plans)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("csize", [1, 4, 8, 16, 64])
@pytest.mark.parametrize("fname", FNS)
def test_instance_blocks_per_form(fname, csize):
    blocks = ck.instance_blocks(fname, 64, csize)
    lanes = ck.lanes_for(csize)
    top = 4 if (fname == "fletcher_powell" and csize >= 8) else 32
    assert blocks == [q for q in (1, 2, 4, 8, 16, 32) if q <= top]
    for q in blocks:
        assert ck.shared_bytes(fname, 64, q, lanes) <= ck.SMEM_MAX
    # the wrapper's own pick lies in the fit, and past max_n nothing does
    P = len(ck.sub_cells(64, csize, True)[0])
    assert 1 <= ck._instances_per_block(P, 64, fname, lanes) <= top
    assert ck.instance_blocks(fname, ck.max_n(fname, csize) + 1, csize) == []


@pytest.mark.parametrize("fname", FNS)
def test_cuda_backend_vetoes_a_blk_m_outside_the_dial(fname):
    f = testfns.FUNCTIONS[fname](64)
    cuda = engine.get_backend("cuda")
    for csize in (4, 8):
        base = _fake_cuda(engine.plan(f, 64, csize=csize, device="cpu"))
        listed = ck.instance_blocks(fname, 64, csize)
        for blk_m in listed:
            p = replace(base, options=(("blk_m", blk_m),))
            assert cuda.can_run(p, "batched_hvp")
            assert p.backend_for("batched_hvp") == "cuda"
        for blk_m in (3, 64, max(listed) * 2):
            p = replace(base, options=(("blk_m", blk_m),))
            assert not cuda.can_run(p, "batched_hvp")
            assert p.backend_for("batched_hvp") == "vmap_l2"
            with pytest.raises(ValueError, match="cannot run"):
                registry.resolve_backend(replace(p, backend="cuda"),
                                         "batched_hvp")


@pytest.mark.parametrize("fname", FNS)
def test_card_plan_refuses_a_blk_m_the_kernel_does_not_take(fname):
    """plan()'s check on a card plan: a blk_m that instance_blocks lists
    at (n, csize) passes, any other raises ValueError (no plan that runs
    on a vmap backend instead); under csize="autotune" one csize that
    takes it is enough.  A CPU plan is not checked."""
    plan_mod = sys.modules["repro_torch.engine.plan"]
    f = testfns.FUNCTIONS[fname](64)
    for csize in (4, 8):
        for blk_m in ck.instance_blocks(fname, 64, csize):
            plan_mod._check_blk_m(f, 64, [csize], CUDA0, blk_m)
        for bad in (3, 64, True, 2.0,
                    2 * ck.instance_blocks(fname, 64, csize)[-1]):
            with pytest.raises(ValueError, match="blk_m"):
                plan_mod._check_blk_m(f, 64, [csize], CUDA0, bad)
    if fname == "fletcher_powell":
        plan_mod._check_blk_m(f, 64, [4, 8], CUDA0, 16)   # csize 4 takes it
    with pytest.raises(ValueError, match="blk_m"):       # no device form
        plan_mod._check_blk_m(testfns.make_fletcher_powell(64).kernel_fn,
                              64, [4], CUDA0, 1)
    plan_mod._check_blk_m(f, 64, [8], torch.device("cpu"), 3)
    assert engine.plan(f, 64, csize=8, blk_m=3, device="cpu").opt("blk_m") \
        == 3


def test_a_raising_cuda_candidate_on_the_card_raises_the_sweep():
    """The sweeps skip a candidate that raises, except a cuda one on a CUDA
    device: the grid already left out what the kernel cannot take, so that
    error is a kernel fault, raised with its cause."""
    err = RuntimeError("no kernel image")
    for bk, device in (("cuda", "cpu"), ("vmap_l2", CUDA0)):
        at._kernel_fault(bk, device, 4, 2, err)
    with pytest.raises(RuntimeError, match="cuda candidate") as raised:
        at._kernel_fault("cuda", CUDA0, 4, 2, err)
    assert raised.value.__cause__ is err


def test_a_pinned_blk_m_on_a_card_plan_keeps_the_csizes_that_take_it():
    f = testfns.make_fletcher_powell(64)
    base = _fake_cuda(engine.plan(f, 64, m=128, csize=1, symmetric=False,
                                  device="cpu"))
    fp = engine.function_fingerprint(f)
    grid = at._combo_grid(fp, base, "batched_hvp", pinned_blk_m=16)
    assert grid and {c for _bk, c, _bm in grid} == {
        c for c in opmodel.pruned_csize_candidates(64, False)
        if 16 in ck.instance_blocks("fletcher_powell", 64, c)}
    assert [bm for bk, _c, bm in grid if bk == "cuda"] == [16] * len(
        {c for _bk, c, _bm in grid})
    # on the CPU the pin keeps every csize (the kernel never runs there)
    cpu = at._combo_grid(fp, replace(base, device=torch.device("cpu")),
                         "batched_hvp", pinned_blk_m=16)
    assert {c for _bk, c, _bm in cpu} == set(
        opmodel.pruned_csize_candidates(64, False))


def test_kernel_grid_and_wrapper_take_an_explicit_ipb():
    m, n = 1000, 64
    P = ck.kernel_grid(m, n, 4, True, "rosenbrock")[1]
    for ipb in ck.instance_blocks("rosenbrock", n, 4):
        assert ck.kernel_grid(m, n, 4, True, "rosenbrock", ipb=ipb) == (
            -(-m // ipb), P)
    for bad in (0, 3, 33, 2.0, True):
        assert not ck.is_instance_block("rosenbrock", n, 4, bad)
        with pytest.raises(ValueError, match="ipb"):
            ck.kernel_grid(m, n, 4, True, "rosenbrock", ipb=bad)
    with pytest.raises(ValueError, match="ipb"):
        ck.kernel_grid(m, n, 8, True, "fletcher_powell", ipb=8)
    # on CPU tensors the plain version ignores ipb, which is still checked
    f = testfns.make_fletcher_powell(6)
    A, V = (torch.as_tensor(x) for x in _data(3, 6, seed=2))
    kw = dict(consts=f.kernel_consts, device_fn="fletcher_powell",
              symmetric=True)
    want = ck.chess_hvp_cuda(f.kernel_fn, A, V, 8, **kw)
    torch.testing.assert_close(
        ck.chess_hvp_cuda(f.kernel_fn, A, V, 8, ipb=4, **kw), want)
    for bad in (8, 3):
        with pytest.raises(ValueError, match="ipb"):
            ck.chess_hvp_cuda(f.kernel_fn, A, V, 8, ipb=bad, **kw)
    with pytest.raises(ValueError, match="device form"):
        ck.chess_hvp_cuda(f.kernel_fn, A, V, 8, consts=f.kernel_consts,
                          ipb=1)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("fname", FNS)
def test_cuda_combos_sweep_the_instance_blocks(fname, symmetric):
    f = testfns.FUNCTIONS[fname](64)
    base = _fake_cuda(engine.plan(f, 64, m=128, csize=1,
                                  symmetric=symmetric, device="cpu"))
    grid = at._combo_grid(engine.function_fingerprint(f), base,
                          "batched_hvp")
    csizes = opmodel.pruned_csize_candidates(64, symmetric)
    argmin = opmodel.model_csize(64, symmetric)
    order = [argmin] + [c for c in csizes if c != argmin]
    want = [("cuda", c, bm) for c in order
            for bm in [None] + ck.instance_blocks(fname, 64, c)]
    assert grid[:len(want)] == want          # cuda first: highest priority
    assert [bk for bk, _, _ in grid[len(want):]] == (
        ["vmap_l2"] * len(order) + ["vmap_l1"] * len(order)
        + ["vmap_l0"] * len(order))
    # a pinned blk_m is honoured, not swept
    pinned = at._combo_grid(engine.function_fingerprint(f),
                            replace(base, options=(("blk_m", 2),)),
                            "batched_hvp", pinned_blk_m=2)
    assert [bm for bk, _, bm in pinned if bk == "cuda"] == [2] * len(order)
    # workloads the kernel does not serve have no cuda combo
    assert "cuda" not in {bk for bk, _, _ in at._combo_grid(
        engine.function_fingerprint(f), base, "hvp")}


def test_apply_bucket_config_reproduces_the_probe_cache_key():
    base = engine.plan(testfns.rosenbrock, N, csize=2, symmetric=False,
                       device="cpu")
    cfg = engine.BucketTunedConfig(bucket=4, csize=4, backend="vmap_l2",
                                   blk_m=None, dtype_policy="fp32",
                                   us_per_point=1.0, source="sweep")
    ep = engine.apply_bucket_config(base, cfg)
    probe = engine.plan(testfns.rosenbrock, N, csize=4, symmetric=False,
                        backend="vmap_l2", device="cpu")
    assert ep.cache_key("batched_hvp", "vmap_l2") == probe.cache_key(
        "batched_hvp", "vmap_l2")
    # a cuda winner carries its instances per CTA into the derived plan
    card = _fake_cuda(engine.plan(testfns.rosenbrock, 64, csize=4,
                                  symmetric=False, device="cpu"))
    kcfg = replace(cfg, csize=8, backend="cuda", blk_m=4)
    kp = engine.apply_bucket_config(card, kcfg)
    assert kp.opt("blk_m") == 4 and kp.backend_for("batched_hvp") == "cuda"
    assert kp.cache_key("batched_hvp", "cuda") == at._derive(
        card, 8, "cuda", 4).cache_key("batched_hvp", "cuda")
