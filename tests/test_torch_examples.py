"""The port's example scripts (``examples_torch/``) on the CPU, at small
sizes, against the reference package: ``quickstart``'s Hessian, HVP,
gradient, L0/L1/L2 batches and engine plan, and ``hvp_service``'s served
and sequential rows, equal the reference's ``repro.core.api`` /
``repro.engine`` results on the same numpy inputs (rtol 1e-5, atol
1e-5 * (1 + max|want|), the bound of test_torch_api.py and
test_torch_service.py); the three LM scripts run, their figures are
finite, ``train_lm``'s loss check holds under both optimizers and a second
call resumes from the first one's checkpoint."""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.hmath as jhm  # noqa: E402
from repro import engine as jengine  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core import testfns as jtestfns  # noqa: E402
from repro_torch import engine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5


def _script(name):
    path = ROOT / "examples_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * (1 + np.abs(want).max()),
                               err_msg=what)


@pytest.fixture(autouse=True)
def _fresh_engine(tmp_path, monkeypatch):
    # auto resolution consults tuned winners and telemetry: the scripts
    # run as a fresh process would.  One intra-op thread: these small
    # models run ~100x slower when several test workers' thread pools
    # share the cores
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    engine.clear_autotune_cache()
    engine.clear_telemetry()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    engine.clear_autotune_cache()
    engine.clear_telemetry()


def _jfunction(x):
    """quickstart's my_function on the reference's hmath."""
    return jhm.sin(x[0] * x[1]) + jhm.exp(x[2] * 0.5) + (x * x).sum(0)


def test_quickstart_matches_the_reference():
    out = _script("quickstart").main(["--device", "cpu"])
    arr = out.pop("arrays")
    n, csize = out["n"], out["csize"]
    a, v = jnp.asarray(arr["a"]), jnp.asarray(arr["v"])
    np.testing.assert_array_equal(arr["a"],
                                  np.asarray(jtestfns.sample_point(n, 0)))
    assert csize == japi.optimal_csize(n)
    _close(arr["H"], japi.hessian(_jfunction, a, csize=csize,
                                  symmetric=True), "H")
    _close(arr["Hv"], japi.hvp(_jfunction, a, v, csize=csize,
                               symmetric=True), "Hv")
    _close(arr["g"], japi.gradient(_jfunction, a, csize=csize), "g")
    # and its own torch.func checks
    for name in ("H", "Hv", "g"):
        _close(arr[name], arr[f"{name}_ref"], f"{name} vs torch.func")
        assert out[f"{name}_err"] <= RTOL * (
            1 + np.abs(arr[f"{name}_ref"]).max())
    A, V = jnp.asarray(arr["A"]), jnp.asarray(arr["V"])
    for level in ("L0", "L1", "L2"):
        assert out["batched"][level] == {"shape": [64, n], "finite": True}
        _close(arr[f"batched_{level}"],
               japi.batched_hvp(jtestfns.rosenbrock, A, V, csize=csize,
                                level=level), level)
    jplan = jengine.plan(jtestfns.rosenbrock, n, m=64, csize="auto",
                         backend="auto", symmetric=False)
    assert out["plan"]["csize"] == jplan.csize
    assert out["plan"]["backend"] == "vmap_l2"      # the CPU has no kernel
    _close(arr["plan"], jplan.execute(A, V), "plan.execute")


def test_hvp_service_matches_the_reference():
    out = _script("hvp_service").main(
        ["--device", "cpu", "--n", "8", "--requests", "64", "--clients", "4"])
    arr = out.pop("arrays")
    assert out["requests"] == 64 and out["backend"] == "vmap_l2"
    jplan = jengine.plan(jtestfns.rosenbrock, 8, m=64, csize="auto",
                         symmetric=False)
    assert out["csize"] == jplan.csize
    want = np.stack([np.asarray(jplan.hvp(jnp.asarray(a), jnp.asarray(v)))
                     for a, v in zip(arr["A"], arr["V"])])
    _close(arr["served"], want, "served rows")
    _close(arr["baseline"], want, "sequential rows")
    assert out["max_abs_err"] <= RTOL * (1 + np.abs(want).max())
    assert sum(out["buckets"].values()) == out["batches"] >= 1
    fe = out["frontend"]
    assert fe["round_trips"] == 64 and fe["ns"] == [4, 8, 10]
    assert fe["max_abs_err"] <= RTOL * (1 + fe["max_abs_want"])


def test_lm_curvature_runs():
    out = _script("lm_curvature").main(
        ["--device", "cpu", "--probes", "2", "--csize", "2"])
    assert out["backend"] == "pytree_fwdrev" and out["diag_finite"]
    assert len(out["diag_top"]) == 5
    assert out["block_rows"] == 64               # the reduced d_model
    for key in ("loss", "hv_norm", "eig_min", "eig_max", "condition"):
        assert math.isfinite(out[key]), key
    assert all(math.isfinite(x) and x > 0 for x in out["diag_top"].values())


def test_serve_lm_runs():
    out = _script("serve_lm").main(
        ["--device", "cpu", "--requests", "4", "--max-new", "4"])
    assert out["requests"] == 4 and out["tokens"] == 16
    assert math.isfinite(out["tokens_per_s"]) and out["tokens_per_s"] > 0
    assert all(len(t) == 4 for t in out["out_tokens"].values())


TRAIN_SMALL = ["--device", "cpu", "--batch", "4", "--seq", "32"]


@pytest.mark.parametrize("optimizer", ["adamw", "sophia_h"])
def test_train_lm_reduces_the_loss(optimizer, tmp_path):
    out = _script("train_lm").main(TRAIN_SMALL + [
        "--optimizer", optimizer, "--steps", "30",
        "--ckpt-dir", str(tmp_path / "ckpt")])
    assert out["model"] == "lm-tiny" and out["optimizer"] == optimizer
    assert out["resumed"] == 0 and out["final_step"] == 30
    assert [m["step"] for m in out["metrics"]] == list(range(30))
    assert all(math.isfinite(m["loss"]) for m in out["metrics"])
    assert out["last"] < out["first"]
    assert (tmp_path / "ckpt" / "LATEST").read_text().strip() == "30"


def test_train_lm_resumes_from_its_latest_checkpoint(tmp_path):
    train = _script("train_lm")
    argv = TRAIN_SMALL + ["--optimizer", "adamw",
                          "--ckpt-dir", str(tmp_path / "ckpt")]
    first = train.main(argv + ["--steps", "30"])
    again = train.main(argv + ["--steps", "50"])
    assert again["resumed"] == 30 and again["final_step"] == 50
    assert [m["step"] for m in again["metrics"]] == list(range(30, 50))
    assert again["last"] < again["first"] < first["first"]
