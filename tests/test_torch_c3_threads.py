"""Two threads in ``torch.func`` at once: a service's dispatch worker runs
a budgeted pytree diag (jvp of grad under vmap) while the caller's thread
runs ``pytree_hvp`` and a SophiaH estimating train step.  Forward-AD levels
are process-wide in PyTorch, so without one lock around every transform
the caller's transform raised ``Trying to access a forward AD level with
an invalid index``.  Each concurrent result must equal its serial run
bitwise (reduced h2o-danube config on the CPU)."""

import copy
import threading
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import engine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import testfns  # noqa: E402
from repro_torch.core.curvature import pytree_hvp  # noqa: E402
from repro_torch.core.funclock import FUNC_LOCK  # noqa: E402
from repro_torch.engine.service import CurvatureService  # noqa: E402
from repro_torch.models.model import make_batch  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.models.targets import lm_curvature_targets  # noqa: E402
from repro_torch.optim import sophia_h  # noqa: E402
from repro_torch.optim.schedule import constant  # noqa: E402
from repro_torch.training.steps import TrainState, make_train_step  # noqa: E402

tree_map = torch.utils._pytree.tree_map
tree_leaves = torch.utils._pytree.tree_leaves
ROUNDS = 3
DIAGS = 4           # diag submits in flight per round


def _equal(got, want):
    return all(torch.equal(g, w)
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


def test_service_diag_beside_main_thread_transforms():
    cfg = get_config("h2o-danube-1.8b", reduced=True)
    params = init_params(cfg, 0, device="cpu")
    batch = make_batch(cfg, 2, 32, 0, device="cpu")
    tgt = lm_curvature_targets(cfg, batch)
    q = engine.plan(tgt.loss, None, device="cpu",
                    options={"n_probes": 4, **tgt.plan_options()})
    v = tree_map(lambda p: torch.randn(p.shape, dtype=p.dtype,
                                       generator=torch.Generator()
                                       .manual_seed(p.numel())), params)
    opt = sophia_h(constant(1e-3), hess_every=1, n_probes=2, csize=1)
    step = make_train_step(cfg, None, opt)

    def sophia_step():
        p = copy.deepcopy(params)
        state = TrainState(p, opt.init(p), torch.zeros((), dtype=torch.long),
                           rng=5)
        return step(state, batch)[0].params

    want_hvp = pytree_hvp(tgt.loss, params, v)
    want_step = sophia_step()
    want_diag = q.diag(params, 7)   # budget 4 == the plan's n_probes

    svc = CurvatureService(max_batch=1)
    try:
        for _ in range(ROUNDS):
            futs = [q.submit(params, 7, workload="diag", n_probes=4,
                             service=svc) for _ in range(DIAGS)]
            got_hvp = pytree_hvp(tgt.loss, params, v)
            got_step = sophia_step()
            assert _equal(got_hvp, want_hvp)
            assert _equal(got_step, want_step)
            for fut in futs:
                got = tree_map(torch.as_tensor, fut.result(timeout=120))
                assert _equal(got, want_diag)
    finally:
        svc.shutdown()


def test_hdual_and_kernel_callables_take_no_lock():
    """While another thread holds FUNC_LOCK, the vmap_l2 schedule and the
    cuda backend's callable (its plain version on CPU tensors) still run:
    the lock serializes torch.func transforms only, never kernel buckets."""
    p = engine.plan(testfns.rosenbrock, 8, csize=4, device="cpu")
    on_card = replace(p, device=torch.device("cuda", 0))
    calls = {"vmap_l2": p.executable("batched_hvp"),
             "cuda": engine.get_backend("cuda").make(on_card, "batched_hvp")}
    rng = np.random.RandomState(0)
    A = torch.tensor(rng.uniform(-2, 2, (4, 8)), dtype=torch.float32)
    V = torch.tensor(rng.randn(4, 8), dtype=torch.float32)
    held, release = threading.Event(), threading.Event()

    def hold():
        with FUNC_LOCK:
            held.set()
            release.wait(60)

    holder = threading.Thread(target=hold)
    holder.start()
    try:
        assert held.wait(60)
        out = {}
        runner = threading.Thread(
            target=lambda: out.update({k: fn(A, V)
                                       for k, fn in calls.items()}))
        runner.start()
        runner.join(60)
        assert not runner.is_alive(), "a kernel-path callable waited"
        torch.testing.assert_close(out["cuda"], out["vmap_l2"])
    finally:
        release.set()
        holder.join(60)
    assert not holder.is_alive()
