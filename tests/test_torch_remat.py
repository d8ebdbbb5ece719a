"""``cfg.remat`` in the port: in train mode every stack runs each layer as
``models.transformer._Remat``, an ``autograd.Function`` that saves the
layer's inputs only and recomputes the layer under ``torch.func.vjp`` /
``torch.func.jvp`` (``vmap`` through ``generate_vmap_rule``).  It must
give the numbers the plain layers give, bit for bit on the CPU, through
every transform the curvature engine applies, and save less.

For the reduced h2o-danube-1.8b (dense), granite-moe-1b-a400m (MoE, at
capacity 1.25: tokens drop), zamba2-1.2b (hybrid: Mamba-2 layers and the
shared block's uses) and whisper-base (the encoder and decoder stacks)
at the configs' own bfloat16 compute, float32 params, B = 2 x 16
positions, remat on and off give equal:
  * ``loss_fn`` and its ``torch.func.grad_and_value`` gradients;
  * the HVP of ``engine.plan(..., backend="pytree_fwdrev")`` (jvp of
    grad), two Hutchinson probes of its diagonal in one vmap (vmap of jvp
    of grad), its GGN product, and v.Hv forward over forward (jvp of jvp,
    which records no gradient, so its layers run without ``_Remat``);
and, under plain ``loss.backward()``, the tensors autograd saves
(``torch.autograd.graph.saved_tensors_hooks``) hold fewer bytes with
remat, and the graph holds one ``_Remat`` node per layer (and per
encoder layer).  Under ``torch.func.grad`` and ``jvp`` of ``grad``, whose
backward runs with ``create_graph``, the peak of live CPU memory
(``torch.profiler``'s allocation events, B = 2 x 64; the dense and MoE
stacks: every stack runs its layers through the same ``_run_layer``) is
under half the plain layers' too: the recompute records nothing at the
gradient's own level.  Grad
of grad, whose inner backward is recorded, composes: at float32 compute
the reverse-over-reverse HVP is within 1e-5 (normalized) of the plain
layers' (its sums group otherwise, so it is not bitwise).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch import engine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import curvature as tc  # noqa: E402
from repro_torch.models.model import loss_fn, make_batch  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.models.targets import lm_curvature_targets  # noqa: E402

NAMES = ("h2o-danube-1.8b", "granite-moe-1b-a400m", "zamba2-1.2b",
         "whisper-base")
B, S = 2, 16


def _setup(name, remat):
    cfg = dataclasses.replace(get_config(name, reduced=True), remat=remat)
    return cfg, init_params(cfg, 0, device="cpu"), make_batch(
        cfg, B, S, 7, device="cpu")


def _results(name, remat):
    cfg, params, batch = _setup(name, remat)
    loss, _ = loss_fn(params, cfg, batch)
    grads, (value, _) = torch.func.grad_and_value(
        lambda p: loss_fn(p, cfg, batch), has_aux=True)(params)
    tgt = lm_curvature_targets(cfg, batch)
    plan = engine.plan(tgt.loss, None, csize=2, backend="pytree_fwdrev",
                       device="cpu",
                       options={"n_probes": 2, **tgt.plan_options()})
    v = tc.rademacher_like(1, params)
    return {"loss": loss, "value": value, "grads": grads,
            "hvp": plan.hvp(params, v), "diag": plan.diag(params, 3),
            "ggn": plan.ggn(params, v),
            "quadform": tc.pytree_hvp_fwd(tgt.loss, params, v, v)}


@pytest.mark.parametrize("name", NAMES)
def test_remat_bitwise_equal_under_every_transform(name):
    plain, remat = _results(name, False), _results(name, True)
    for key, want in plain.items():
        got = remat[key]
        want_l, spec = pytree.tree_flatten(want)
        got_l, got_spec = pytree.tree_flatten(got)
        assert got_spec == spec, key
        for g, w in zip(got_l, want_l):
            assert g.dtype == w.dtype and torch.equal(g, w), key
        assert all(bool(torch.isfinite(w).all()) for w in want_l), key
    assert any(bool(w.any()) for w in pytree.tree_leaves(plain["hvp"]))


def _saved(name, remat):
    """(bytes autograd saves for loss.backward(), _Remat nodes in the
    graph), after checking the backward runs."""
    cfg, params, batch = _setup(name, remat)
    for p in pytree.tree_leaves(params):
        p.requires_grad_()
    nbytes = [0]

    def pack(t):
        nbytes[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = loss_fn(params, cfg, batch)
    nodes, seen, todo = 0, set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        nodes += type(fn).__name__ == "_RematBackward"
        todo.extend(f for f, _ in fn.next_functions)
    loss.backward()
    assert all(p.grad is not None for p in pytree.tree_leaves(params))
    return nbytes[0], nodes, cfg


@pytest.mark.parametrize("name", NAMES)
def test_remat_saves_fewer_bytes(name):
    plain, plain_nodes, _ = _saved(name, False)
    remat, nodes, cfg = _saved(name, True)
    assert plain_nodes == 0
    assert nodes == cfg.num_layers + cfg.encoder_layers
    assert remat < plain, (remat, plain)


def _peak_bytes(fn):
    """The most bytes live at once while ``fn`` runs on the CPU, from the
    profiler's allocation events in time order."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        fn()
    live = top = 0
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        live += e.self_cpu_memory_usage
        top = max(top, live)
    return top


@pytest.mark.parametrize("name", ["h2o-danube-1.8b",
                                  "granite-moe-1b-a400m"])
def test_remat_lowers_the_peak_under_torch_func(name):
    peaks = {}
    for remat in (False, True):
        cfg = dataclasses.replace(get_config(name, reduced=True),
                                  remat=remat)
        params = init_params(cfg, 0, device="cpu")
        tgt = lm_curvature_targets(cfg, make_batch(cfg, B, 64, 7,
                                                   device="cpu"))
        v = tc.rademacher_like(1, params)
        peaks[remat] = (
            _peak_bytes(lambda: torch.func.grad(tgt.loss)(params)),
            _peak_bytes(lambda: tc.pytree_hvp(tgt.loss, params, v)))
    for plain, remat in zip(peaks[False], peaks[True]):
        assert 0 < remat < plain / 2, peaks


@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "whisper-base"])
def test_remat_grad_of_grad_composes(name):
    got = {}
    for remat in (False, True):
        cfg = dataclasses.replace(get_config(name, reduced=True),
                                  remat=remat, compute_dtype="float32")
        params = init_params(cfg, 0, device="cpu")
        tgt = lm_curvature_targets(cfg, make_batch(cfg, B, S, 7,
                                                   device="cpu"))
        v = tc.rademacher_like(1, params)

        def g_dot_v(p):
            g = torch.func.grad(tgt.loss)(p)
            return sum((a * b).sum() for a, b in zip(
                pytree.tree_leaves(g), pytree.tree_leaves(v)))

        got[remat] = torch.cat([t.ravel() for t in pytree.tree_leaves(
            torch.func.grad(g_dot_v)(params))])
    err = torch.linalg.norm(got[True] - got[False]) / torch.linalg.norm(
        got[False])
    assert float(err) <= 1e-5


def test_transform_levels_counts_each_kind():
    """``core.funclock.transform_levels``, which decides whether the remat
    backward records a graph, counts the transforms around its caller."""
    from repro_torch.core.funclock import transform_levels

    seen = []

    def probe(x):
        seen.append({k: transform_levels(k) for k in ("grad", "jvp",
                                                      "vmap")})
        return (x * x).sum()

    x = torch.ones(3)
    probe(x)
    torch.func.grad(probe)(x)
    torch.func.jvp(torch.func.grad(probe), (x,), (x,))
    torch.func.vmap(lambda v: torch.func.jvp(torch.func.grad(probe), (x,),
                                             (v,))[1])(torch.eye(3))
    assert seen == [{"grad": 0, "jvp": 0, "vmap": 0},
                    {"grad": 1, "jvp": 0, "vmap": 0},
                    {"grad": 1, "jvp": 1, "vmap": 0},
                    {"grad": 1, "jvp": 1, "vmap": 1}]
