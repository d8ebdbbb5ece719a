"""The ``cuda`` backend's ``blk_m`` (instances per CTA) for any f, as the
reference's ``pallas`` backend takes ``blk_m`` for any hmath-written f
(``src/repro/kernels/ops.py::_pallas_make``, swept by
``src/repro/engine/autotune.py``'s grid).

On the CPU, with fake CUDA plans (no card here):

* the tuner's grid on quickstart's ``my_function`` sweeps ``[None] +
  instance_blocks(form, n, csize)`` of the generated form the backend runs;
* one budget: the top of ``instance_blocks(form, ...)`` is the most
  instances the wrapper itself picks (``_fit``'s cap, the half-SM budget
  of a generated form included);
* a listed ``blk_m`` is taken and an unlisted one refused with the reason,
  for the paper's test functions and a function without a hand-written
  form alike;
* the reference's ``plan(..., backend="pallas", blk_m=4)`` in interpret mode
  equals the port's result on the same seeded inputs at the reference's
  kernel tolerance (rtol 1e-5, atol 1e-5 * (1 + max|want|), as
  tests/test_torch_kernels_pallas.py).
"""

import sys
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro.core import hmath as jhm  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core import testfns  # noqa: E402
from repro_torch.engine import opmodel, registry  # noqa: E402
from repro_torch.kernels import chess_hvp as ck  # noqa: E402
from repro_torch.kernels.ops import backend_form  # noqa: E402
from tests.test_torch_chess_traced import (  # noqa: E402
    make_all_ops, my_function)

import repro_torch.engine.autotune  # noqa: E402,F401
at = sys.modules["repro_torch.engine.autotune"]

RTOL = 1e-5                      # atol = RTOL * (1 + max|want|)
CUDA0 = torch.device("cuda", 0)
N = 64


def my_function_jax(x):
    return jhm.sin(x[0] * x[1]) + jhm.exp(x[2] * 0.5) + (x * x).sum(0)


def _fake_cuda(plan):
    return replace(plan, device=CUDA0)


def _function(name, n):
    if name == "my_function":
        return my_function
    if name == "all_ops":
        return make_all_ops(n)
    return testfns.FUNCTIONS[name](n)


@pytest.mark.parametrize("symmetric", [False, True])
def test_combo_grid_sweeps_the_generated_forms_blocks(symmetric):
    base = _fake_cuda(engine.plan(my_function, N, m=128, csize=1,
                                  symmetric=symmetric, device="cpu"))
    grid = at._combo_grid(engine.function_fingerprint(my_function), base,
                          "batched_hvp")
    form = backend_form(my_function, N)
    csizes = opmodel.pruned_csize_candidates(N, symmetric)
    argmin = opmodel.model_csize(N, symmetric)
    order = [argmin] + [c for c in csizes if c != argmin]
    want = [("cuda", c, bm) for c in order
            for bm in [None] + ck.instance_blocks(form, N, c)]
    assert len(want) > len(order)           # blocks, not [None] alone
    assert grid[:len(want)] == want


@pytest.mark.parametrize("csize", [4, 8])
@pytest.mark.parametrize("name", ["my_function", "rosenbrock", "ackley",
                                  "fletcher_powell", "all_ops"])
def test_top_instance_block_is_the_wrappers_cap(name, csize):
    """One budget: the top of the listed blocks is ``_fit``'s, and the
    wrapper's own pick reaches it where the cells are few (P = 1) and never
    passes it; for the all-ops form (33 slot rows) that cap is the
    half-SM budget's, not a power of two."""
    form = backend_form(_function(name, N), N)
    lanes = ck.lanes_for(csize)
    blocks = ck.instance_blocks(form, N, csize)
    cap = ck._fit(N, form, lanes)[-1]
    assert blocks[-1] == cap == ck._instances_per_block(1, N, form, lanes)
    P = len(ck.sub_cells(N, csize, True)[0])
    assert ck._instances_per_block(P, N, form, lanes) <= cap
    assert all(b & (b - 1) == 0 for b in blocks[:-1])
    if name == "all_ops":
        assert cap & (cap - 1) and (ck.shared_bytes(form, N, cap, lanes)
                                    <= ck.SMEM_SM // 2 - 1024)


@pytest.mark.parametrize("name", ["my_function", "rosenbrock",
                                  "fletcher_powell"])
def test_listed_blk_m_taken_unlisted_refused(name):
    f = _function(name, N)
    form = backend_form(f, N)
    cuda = engine.get_backend("cuda")
    plan_mod = sys.modules["repro_torch.engine.plan"]
    for csize in (4, 8):
        listed = ck.instance_blocks(form, N, csize)
        base = _fake_cuda(engine.plan(f, N, csize=csize, device="cpu"))
        for blk_m in listed:
            p = replace(base, options=(("blk_m", blk_m),))
            assert p.backend_for("batched_hvp") == "cuda"
            plan_mod._check_blk_m(f, N, [csize], CUDA0, blk_m)
        bad = 2 * listed[-1]
        p = replace(base, options=(("blk_m", bad),))
        assert "instance blocks" in cuda.refusal(p, "batched_hvp")
        with pytest.raises(ValueError, match="cannot run"):
            registry.resolve_backend(replace(p, backend="cuda"),
                                     "batched_hvp")
        with pytest.raises(ValueError, match=f"blk_m={bad}"):
            plan_mod._check_blk_m(f, N, [csize], CUDA0, bad)


@pytest.mark.parametrize("symmetric", [False, True])
def test_pallas_blk_m_on_any_f_equals_the_port(symmetric):
    """The reference's pallas backend at blk_m=4 on my_function (interpret
    mode) against the port's plan at the same blk_m: its CPU plan (the
    plain version) and the wrapper with ipb=4 on the CPU tensors."""
    n, m, csize = 8, 12, 4
    rng = np.random.RandomState(31 + symmetric)
    A = rng.uniform(-2, 2, (m, n)).astype(np.float32)
    V = rng.randn(m, n).astype(np.float32)
    jp = jengine.plan(my_function_jax, n, m=m, csize=csize,
                      backend="pallas", symmetric=symmetric, blk_m=4,
                      interpret=True)
    want = np.asarray(jp.batched_hvp(jnp.asarray(A), jnp.asarray(V)))
    p = engine.plan(my_function, n, m=m, csize=csize, symmetric=symmetric,
                    blk_m=4, device="cpu")
    assert p.opt("blk_m") == 4
    assert _fake_cuda(p).backend_for("batched_hvp") == "cuda"
    At, Vt = torch.from_numpy(A), torch.from_numpy(V)
    for got in (p.batched_hvp(At, Vt),
                ck.chess_hvp_cuda(my_function, At, Vt, csize,
                                  symmetric=symmetric, ipb=4)):
        np.testing.assert_allclose(
            got.numpy(), want, rtol=RTOL,
            atol=RTOL * (1 + np.abs(want).max()))
