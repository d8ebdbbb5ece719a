"""bfloat16 submits through the port's CurvatureService against the
reference's service: a flat Rosenbrock HVP at n = 8 on ``vmap_l2`` and a
two-leaf bfloat16 tree on ``pytree_fwdrev`` come back in bfloat16 (CPU
tensors: numpy has no bfloat16 without ml_dtypes) with the reference's
values, within 1e-2 * (1 + max|want|) (a few bfloat16 ulps of the result
scale; the two packages round their bfloat16 hDual arithmetic in
different orders).  One case runs with jax blocked, where numpy has no
bfloat16 at all."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro.core import testfns as jtestfns  # noqa: E402
from repro.engine.service import CurvatureService as JService  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core import testfns  # noqa: E402
from repro_torch.engine.pytree import spec_of  # noqa: E402
from repro_torch.engine.service import CurvatureService  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N = 8
REL = 1e-2
tree_leaves = torch.utils._pytree.tree_leaves
tree_map = torch.utils._pytree.tree_map


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    engine.clear_telemetry()
    yield
    engine.clear_telemetry()
    engine.shutdown_service()


def _close(got, want):
    assert got.dtype == torch.bfloat16
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), w, rtol=REL,
                               atol=REL * (1 + np.abs(w).max()))


def _points(k, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-2, 2, (k, N)).astype(np.float32),
            rng.randn(k, N).astype(np.float32))


def test_flat_bf16_submits_match_reference_service():
    A, V = _points(5)
    plan = engine.plan(testfns.rosenbrock, N, csize=2, symmetric=False,
                       backend="vmap_l2", device="cpu")
    jplan = jengine.plan(jtestfns.rosenbrock, N, csize=2, symmetric=False,
                         backend="vmap_l2")
    with CurvatureService(max_batch=8, max_wait_us=20000.0) as svc:
        futs = [svc.submit(plan, torch.tensor(a).bfloat16(),
                           torch.tensor(v).bfloat16()) for a, v in zip(A, V)]
        # a float32 submit to the same plan keeps its numpy result
        f32 = svc.submit(plan, A[0], V[0])
        got = [f.result(timeout=60) for f in futs]
        got32 = f32.result(timeout=60)
    with JService(max_batch=8, max_wait_us=20000.0) as jsvc:
        want = [jsvc.submit(jplan, jnp.asarray(a, jnp.bfloat16),
                            jnp.asarray(v, jnp.bfloat16)).result(timeout=60)
                for a, v in zip(A, V)]
    for g, w in zip(got, want):
        assert w.dtype == jnp.bfloat16
        _close(g, w)
    assert isinstance(got32, np.ndarray) and got32.dtype == np.float32
    np.testing.assert_allclose(
        got32, np.asarray(jplan.hvp(jnp.asarray(A[0]), jnp.asarray(V[0]))),
        rtol=1e-5, atol=1e-5)


def _tree_obj(t):
    sq = sum((l.float() ** 2).sum() for l in tree_leaves(t))
    return 0.25 * sq * sq + sum(torch.cos(l.float()).sum()
                                for l in tree_leaves(t))


def _jtree_obj(t):
    sq = sum((l.astype(jnp.float32) ** 2).sum() for l in jax.tree.leaves(t))
    return 0.25 * sq * sq + sum(jnp.cos(l.astype(jnp.float32)).sum()
                                for l in jax.tree.leaves(t))


def _np_tree(i):
    return {"b": np.full((4,), 0.5 + 0.05 * i, np.float32),
            "w": np.arange(6, dtype=np.float32).reshape(3, 2) / 7 + 0.1 * i}


def test_pytree_bf16_submits_match_reference_service():
    plan = engine.plan(_tree_obj, None, backend="pytree_fwdrev",
                       device="cpu")
    jplan = jengine.plan(_jtree_obj, None, backend="pytree_fwdrev")
    pts = [_np_tree(i) for i in range(3)]
    tangents = [_np_tree(i + 5) for i in range(3)]
    bf = [tree_map(lambda a: torch.tensor(a).bfloat16(), t) for t in pts]
    spec = spec_of(bf[0])
    assert spec.torch_ravel_dtype == torch.bfloat16
    assert spec.ravel_dtype == np.float32          # the host row
    with CurvatureService(max_batch=4, max_wait_us=20000.0) as svc:
        futs = [svc.submit(plan, p, tree_map(
            lambda a: torch.tensor(a).bfloat16(), t))
            for p, t in zip(bf, tangents)]
        got = [f.result(timeout=60) for f in futs]
    with JService(max_batch=4, max_wait_us=20000.0) as jsvc:
        want = [jsvc.submit(
            jplan, jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p),
            jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), t)
        ).result(timeout=60) for p, t in zip(pts, tangents)]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert w[k].dtype == jnp.bfloat16
            _close(g[k], w[k])


def test_bf16_submits_with_jax_blocked():
    """numpy without ml_dtypes: the flat and pytree bfloat16 rows go
    through hostarray, and each result equals the direct plan call."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "from repro_torch import engine\n"
        "from repro_torch.core import testfns\n"
        "from repro_torch.engine.service import CurvatureService\n"
        "p = engine.plan(testfns.rosenbrock, 8, csize=2, symmetric=False,\n"
        "                backend='vmap_l2', device='cpu')\n"
        "q = engine.plan(lambda t: (t['a'].float() ** 4).sum()\n"
        "                + (t['b'].float() ** 2).sum(), None,\n"
        "                backend='pytree_fwdrev', device='cpu')\n"
        "g = torch.Generator().manual_seed(0)\n"
        "a, v = (torch.randn(8, generator=g).bfloat16() for _ in 'av')\n"
        "t = {'a': torch.randn(3, generator=g).bfloat16(),\n"
        "     'b': torch.randn(2, 2, generator=g).bfloat16()}\n"
        "with CurvatureService(max_batch=4, max_wait_us=1000.0) as s:\n"
        "    r = s.submit(p, a, v).result(60)\n"
        "    rt = s.submit(q, t, t).result(60)\n"
        "assert r.dtype == torch.bfloat16\n"
        "assert torch.equal(r, p.hvp(a, v)), (r, p.hvp(a, v))\n"
        "want = q.hvp(t, t)\n"
        "for k in t:\n"
        "    assert rt[k].dtype == torch.bfloat16\n"
        "    assert torch.equal(rt[k], want[k]), k\n"
        "assert not [m for m, mod in sys.modules.items() if mod is not "
        "None and m.startswith(('jax', 'ml_dtypes'))]\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["REPRO_TORCH_AUTOTUNE_CACHE"] = ""
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
