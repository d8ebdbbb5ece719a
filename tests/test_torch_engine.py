"""repro_torch.engine: device rules, backend resolution, the callable cache,
and plan results against the JAX engine (tolerance of
tests/test_chessfad_api.py)."""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro.core import testfns as jtestfns  # noqa: E402
from repro_torch import convert, engine  # noqa: E402
from repro_torch.core import testfns  # noqa: E402

FNS = ("rosenbrock", "ackley", "fletcher_powell")


def _data(tag, m, n):
    rng = np.random.RandomState(zlib.crc32(tag.encode()))
    return (rng.uniform(-2, 2, (m, n)).astype(np.float32),
            rng.randn(m, n).astype(np.float32))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


def test_plan_without_device_needs_a_card():
    if torch.cuda.is_available():
        p = engine.plan(testfns.rosenbrock, 8)
        assert p.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            engine.plan(testfns.rosenbrock, 8)


@pytest.mark.parametrize("fname", FNS)
def test_cpu_plan_resolves_to_vmap_l2(fname):
    n = 64
    p = engine.plan(testfns.FUNCTIONS[fname](n), n, m=524288, csize="auto",
                    device="cpu")
    assert p.csize == 4 and p.device == torch.device("cpu")
    assert p.backend_for("batched_hvp") == "vmap_l2"
    assert not engine.get_backend("cuda").can_run(p, "batched_hvp")
    for workload in ("hvp", "hessian", "batched_hessian"):
        assert p.backend_for(workload) == "vmap_l2"
    assert "device=cpu" in p.describe()


def test_cuda_backend_refusals():
    cuda = engine.get_backend("cuda")
    p = engine.plan(testfns.rosenbrock, 8, csize=2, device="cpu")
    assert not cuda.can_run(p, "batched_hvp")
    with pytest.raises(ValueError, match="cannot run"):
        engine.plan(testfns.rosenbrock, 8, csize=2, backend="cuda",
                    device="cpu").batched_hvp(*_data("x", 2, 8))
    # vetoes that hold on any device: no device form, a mesh, and workloads
    # other than batched_hvp; any csize runs (past 64 lanes as sub-cells)
    from dataclasses import replace
    on_card = replace(p, device=torch.device("cuda", 0))
    assert cuda.can_run(on_card, "batched_hvp")
    assert not cuda.can_run(on_card, "hvp")
    assert not cuda.can_run(replace(on_card, f=lambda x: x.sum(0)),
                            "batched_hvp")
    for csize in (65, 96, 128):
        wide = replace(on_card, csize=csize)
        assert cuda.can_run(wide, "batched_hvp")
        assert wide.backend_for("batched_hvp") == "cuda"
    assert not cuda.can_run(replace(on_card, mesh="mesh"), "batched_hvp")
    assert cuda.priority > max(engine.get_backend(f"vmap_l{k}").priority
                               for k in range(3))


@pytest.mark.parametrize("csize", [1, 4, 8, 16, 33, 64, 96])
@pytest.mark.parametrize("fname", FNS)
def test_cuda_backend_vetoes_n_past_the_kernels_shared_memory(fname, csize):
    """A fake CUDA plan: the cuda backend supports n exactly up to the
    form's cap (one instance in one CTA's shared memory, the wrapper's own
    test), ``auto`` then falls back to vmap_l2, and an explicit
    ``backend="cuda"`` is refused by registry.resolve_backend, not by the
    kernel wrapper."""
    from dataclasses import replace

    from repro_torch.engine import registry
    from repro_torch.kernels import chess_hvp as ck
    cuda = engine.get_backend("cuda")
    cap = ck.max_n(fname, csize)
    # never below the first kernel's 48 KB cap (n <= 2457 for every form)
    assert cap >= 2457
    assert ck.supports(fname, cap, csize)
    assert not ck.supports(fname, cap + 1, csize)
    f = testfns.FUNCTIONS[fname](4)
    base = engine.plan(f, 4, csize=csize, device="cpu")
    for n, ok in ((cap - 1, True), (cap, True), (cap + 1, False),
                  (2 * cap, False)):
        p = replace(base, n=n, device=torch.device("cuda", 0))
        assert cuda.can_run(p, "batched_hvp") is ok, n
        assert p.backend_for("batched_hvp") == ("cuda" if ok else "vmap_l2")
        explicit = replace(p, backend="cuda")
        if ok:
            assert registry.resolve_backend(explicit, "batched_hvp") is cuda
        else:
            with pytest.raises(ValueError, match="cannot run"):
                registry.resolve_backend(explicit, "batched_hvp")
    # the launch configuration fits where the veto lets n through
    lanes = ck.lanes_for(csize)
    assert ck.shared_bytes(fname, cap, 1, lanes) <= ck.SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        ck._instances_per_block(1, cap + 1, fname, lanes)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("fname", FNS)
def test_batched_hvp_matches_jax_engine(fname, symmetric):
    for n in (10, 13):                           # divisible / ragged chunks
        A, V = _data(f"{fname}{n}{symmetric}", 6, n)
        p = engine.plan(testfns.FUNCTIONS[fname](n), n, m=6, csize="auto",
                        symmetric=symmetric, device="cpu")
        jp = jengine.plan(jtestfns.FUNCTIONS[fname](n), n, m=6, csize="auto",
                          symmetric=symmetric)
        assert p.csize == jp.csize
        _close(p.batched_hvp(A, V), jp.batched_hvp(jnp.asarray(A),
                                                   jnp.asarray(V)))


@pytest.mark.parametrize("fname", FNS)
def test_single_instance_workloads_match_jax_engine(fname):
    n = 9
    A, V = _data(f"{fname}single", 3, n)
    p = engine.plan(testfns.FUNCTIONS[fname](n), n, csize=3, device="cpu")
    jp = jengine.plan(jtestfns.FUNCTIONS[fname](n), n, csize=3,
                      backend="vmap_l2")
    _close(p.hvp(A[0], V[0]), jp.hvp(jnp.asarray(A[0]), jnp.asarray(V[0])))
    _close(p.hessian(A[0]), jp.hessian(jnp.asarray(A[0])))
    _close(p.batched_hessian(A), jp.batched_hessian(jnp.asarray(A)))
    _close(p.execute(A[0], V[0]), jp.hvp(jnp.asarray(A[0]),
                                         jnp.asarray(V[0])))
    ref_p = engine.plan(testfns.FUNCTIONS[fname](n), n, csize=3,
                        backend="reference", device="cpu")
    _close(ref_p.batched_hvp(A, V), jp.batched_hvp(jnp.asarray(A),
                                                   jnp.asarray(V)))


def test_levels_and_explicit_backends_agree():
    n = 8
    A, V = _data("levels", 4, n)
    want = engine.plan(testfns.ackley, n, csize=2, backend="reference",
                       device="cpu").batched_hvp(A, V)
    for level in ("L0", "L1", "L2"):
        p = engine.plan(testfns.ackley, n, csize=2, level=level,
                        device="cpu")
        assert p.backend_for("batched_hvp") == f"vmap_{level.lower()}"
        _close(p.batched_hvp(A, V), want.numpy())


def test_cache_returns_same_callable_without_rebuilding():
    engine.clear_cache()
    f = testfns.make_fletcher_powell(6)
    A, V = _data("cache", 3, 6)
    p1 = engine.plan(f, 6, csize=2, device="cpu")
    p2 = engine.plan(testfns.make_fletcher_powell(6), 6, csize=2,
                     device="cpu")
    exe = p1.executable("batched_hvp")
    assert engine.trace_count() == 1 and engine.cache_size() == 1
    assert p2.executable("batched_hvp") is exe
    p1.batched_hvp(A, V)
    p2.batched_hvp(A, V)
    assert engine.trace_count() == 1
    key = p1.cache_key("batched_hvp", "vmap_l2")
    assert engine.trace_count(key) == 1
    engine.plan(f, 6, csize=3, device="cpu").batched_hvp(A, V)
    assert engine.trace_count() == 2 and engine.cache_size() == 2
    engine.clear_cache()
    assert engine.cache_size() == 0 and engine.trace_count() == 0


def test_inputs_are_placed_on_the_plan_device():
    p = engine.plan(testfns.rosenbrock, 5, csize=2, device="cpu")
    A, V = _data("inputs", 2, 5)
    out = p.batched_hvp(A, V)                       # numpy goes to the device
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    with pytest.raises(ValueError, match="meta"):
        p.batched_hvp(torch.from_numpy(A).to("meta"), V)


def test_plan_argument_errors(monkeypatch, tmp_path):
    # csize="autotune" plans (a measured csize among the candidates) into
    # a store of the test's own
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    engine.clear_autotune_cache()
    try:
        p = engine.plan(testfns.rosenbrock, 8, csize="autotune",
                        device="cpu")
        assert p.csize in engine.csize_candidates(8)
        assert engine.lookup_tuned(p, "hvp").csize == p.csize
    finally:
        engine.clear_autotune_cache()
    with pytest.raises(ValueError, match="csize"):
        engine.plan(testfns.rosenbrock, 8, csize="tuned", device="cpu")
    # n=None is a pytree plan (ROADMAP A.4): its csize is the probe-chunk
    # model's argmin over the divisors of n_probes
    q = engine.plan(testfns.rosenbrock, None, device="cpu", n_probes=8)
    assert q.n is None and q.csize == engine.model_csize_probes(8)
    assert q.backend_for("hvp") == "pytree_fwdrev"
    with pytest.raises(ValueError):
        engine.plan(testfns.rosenbrock, 8, csize=0, device="cpu")
    with pytest.raises(ValueError):
        engine.plan(testfns.rosenbrock, 8, m=0, device="cpu")
    with pytest.raises(ValueError):
        engine.plan(testfns.rosenbrock, 8, level="L3", device="cpu")
    with pytest.raises(ValueError):
        engine.plan(testfns.rosenbrock, 8, dtype_policy="fp16", device="cpu")
    with pytest.raises(KeyError):
        engine.plan(testfns.rosenbrock, 8, backend="pallas", device="cpu")
    p = engine.plan(testfns.rosenbrock, 8, dtype_policy="fp32", device="cpu")
    assert p.options == ()                       # the default is dropped


def test_dtype_policies():
    n = 6
    A, V = _data("policy", 3, n)
    want = engine.plan(testfns.rosenbrock, n, csize=2,
                       device="cpu").batched_hvp(A, V)
    for policy, tol in (("fp64", 2e-3), ("bf16", 1e-1)):
        p = engine.plan(testfns.rosenbrock, n, csize=2, dtype_policy=policy,
                        device="cpu")
        assert p.backend_for("batched_hvp") == "vmap_l2"
        got = p.batched_hvp(A, V)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol,
                                   atol=tol * (1 + want.abs().max().item()))
    assert engine.policy_compute_dtype("bf16") == torch.bfloat16
    assert engine.policy_compute_dtype("fp32") is None


def test_bucketing_helpers_match_reference():
    for k in range(1, 40):
        assert engine.bucket_size(k) == jengine.bucket_size(k)
        assert engine.bucket_size(k, 16 if k <= 16 else None) == \
            jengine.bucket_size(k, 16 if k <= 16 else None)
    X = np.arange(12, dtype=np.float32).reshape(3, 4)
    for size in (3, 4, 8):
        got = engine.pad_rows(X, size)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, jengine.pad_rows(X, size))
        t = engine.pad_rows(torch.from_numpy(X), size)
        np.testing.assert_array_equal(t.numpy(), got)
    np.testing.assert_array_equal(engine.pad_cols(X[0], 7),
                                  jengine.pad_cols(X[0], 7))
    with pytest.raises(ValueError):
        engine.pad_rows(X, 2)


def test_convert_carries_fletcher_powell_across():
    n = 7
    A, V = _data("convert", 4, n)
    f = convert.fletcher_powell_from_numpy(*jtestfns._fp_coeffs(n))
    g = testfns.make_fletcher_powell(n)
    for c_from, c_made in zip(f.kernel_consts, g.kernel_consts):
        assert torch.equal(c_from, c_made)
    assert f.device_fn == g.device_fn == "fletcher_powell"
    tA, tV = convert.to_torch(A), convert.to_torch(V)
    assert tA.dtype == torch.float32 and tA.is_contiguous()
    for symmetric in (False, True):
        got = engine.plan(f, n, csize=3, symmetric=symmetric,
                          device="cpu").batched_hvp(tA, tV)
        want = engine.plan(g, n, csize=3, symmetric=symmetric,
                           device="cpu").batched_hvp(tA, tV)
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        convert.fletcher_powell_from_numpy(np.zeros((3, 3)), np.zeros((3, 3)),
                                           np.zeros(4))
