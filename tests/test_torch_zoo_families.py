"""The port's MoE, SSM and hybrid LM families against the JAX package on
the same numpy inputs: params of the reduced granite-moe-1b-a400m,
granite-moe-3b-a800m (5 experts), mamba2-2.7b and zamba2-1.2b drawn with
numpy from a seed by the parameter table's initializers and carried into
the port by ``lm_params_from_numpy``, tokens from a numpy seed, B = 2,
S = 16.

Tolerances (normalized error ||got - want|| / ||want||):
  * float32 compute: forward logits, aux and loss 1e-5; prefill (12
    tokens) + 4 decode steps, logits and the decode state leaf by leaf,
    with float32 states, 1e-5 (``pos`` equal);
  * bfloat16 conv states under float32 compute: the port rounds the state
    it writes in place to bfloat16 where the reference carries a float32
    tree (ROADMAP C, by design); the decode logits stay within 1e-2 of
    the reference's;
  * the continuous-batching engine (float32) emits the reference's naive
    greedy tokens (tests/test_decode_engine.py's template);
  * int8 KV caches (granite's layer caches, zamba2's shared-attention
    caches) under the reference test's max-abs 0.25 of the full forward
    (tests/test_kv_quant.py);
  * hvp and ggn through ``engine.plan(..., backend="pytree_fwdrev")`` and
    the backend's Hutchinson diagonal on numpy-drawn probes at 1e-6 of the
    reference's oracles (tests/test_zoo_conformance.py's bound), one case
    per family, float32 compute;
  * one AdamW step at 1e-5 of the reference's single-device step.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import training as jtraining  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import curvature as jc  # noqa: E402
from repro.data import SyntheticTokens as JSyntheticTokens  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.params import flatten as jflatten  # noqa: E402
from repro.models.targets import lm_curvature_targets as jtargets  # noqa
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim.schedule import warmup_cosine as jwarmup  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.convert import (batch_from_numpy,  # noqa: E402
                                 decode_state_to_numpy, lm_params_from_numpy)
from repro_torch.core import curvature as tc  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.models.decode_engine import ServingEngine  # noqa: E402
from repro_torch.models.model import (decode_step, forward,  # noqa: E402
                                      init_decode_state, loss_fn, prefill)
from repro_torch.models.params import (flatten, param_table,  # noqa: E402
                                       unflatten)
from repro_torch.models.targets import lm_curvature_targets  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.schedule import warmup_cosine  # noqa: E402
from repro_torch.training import TrainState, make_train_step  # noqa: E402

FAMILIES = ("granite-moe-1b-a400m", "granite-moe-3b-a800m", "mamba2-2.7b",
            "zamba2-1.2b")
B, S, SP, MAX_SEQ = 2, 16, 12, 24
TOL = 1e-5
CURV_TOL = 1e-6
BF16_STATE = 1e-2
N_PROBES, CSIZE = 2, 2

_jprefill = jax.jit(jmodel.prefill, static_argnums=(1,))
_jdecode = jax.jit(jmodel.decode_step, static_argnums=(1,))
_CASES: dict = {}


def _nerr(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _numpy_params(cfg, seed=0):
    """{path: float32 array} by the parameter table's initializers: normal
    at the fan-in scale, zeros / ones, A_log = log U(1, 16) and dt_bias =
    softplus^-1 of U(1e-3, 1e-1)."""
    rs = np.random.RandomState(seed)
    out = {}
    for path, spec in sorted(param_table(cfg).items()):
        shape = spec.shape
        if spec.init in ("zeros", "ones"):
            a = np.full(shape, 1.0 if spec.init == "ones" else 0.0)
        elif spec.init == "a_log":
            a = np.log(rs.uniform(1.0, 16.0, shape))
        elif spec.init == "dt_bias":
            dt = rs.uniform(1e-3, 1e-1, shape)
            a = dt + np.log(-np.expm1(-dt))
        else:
            fan_in = shape[-3] if len(shape) >= 3 else shape[-2] \
                if len(shape) == 2 else shape[-1]
            a = rs.randn(*shape) * min(0.02, 1.0 / np.sqrt(fan_in))
        out[path] = a.astype(np.float32)
    return out


def _case(name, compute_dtype="float32"):
    """Both configs, the params in both packages and a token batch."""
    key = (name, compute_dtype)
    if key not in _CASES:
        jcfg = dataclasses.replace(jbase.get_config(name, reduced=True),
                                   compute_dtype=compute_dtype)
        cfg = dataclasses.replace(base.get_config(name, reduced=True),
                                  compute_dtype=compute_dtype)
        flat = _numpy_params(cfg)
        jp = jax.tree.map(jnp.asarray, unflatten(flat))
        tokens = np.random.RandomState(1).randint(
            0, jcfg.vocab_size, (B, S)).astype(np.int32)
        _CASES[key] = (jcfg, jp, tokens, cfg,
                       lm_params_from_numpy(flat, "cpu"))
    return _CASES[key]


def _state_leaves(state, prefix=""):
    """{path: numpy} of a decode state (either package's)."""
    out = {}
    for k in sorted(state):
        v = state[k]
        if isinstance(v, dict):
            out.update(_state_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (decode_state_to_numpy(v)
                               if isinstance(v, torch.Tensor) else
                               np.asarray(jnp.asarray(v, jnp.float32)
                                          if v.dtype == jnp.bfloat16 else v))
    return out


# ---------------------------------------------------------------------------
# forward, loss, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_forward_and_loss_match_reference(name):
    jcfg, jp, tokens, cfg, tp = _case(name)
    jb = {"tokens": jnp.asarray(tokens)}
    tb = batch_from_numpy({"tokens": tokens}, "cpu")
    jlg, jaux, _ = jmodel.forward(jp, jcfg, jb)
    lg, aux, st = forward(tp, cfg, tb)
    assert st is None and lg.dtype == torch.float32
    assert _nerr(lg, jlg) <= TOL
    assert abs(aux.item() - float(jaux)) <= TOL * max(abs(float(jaux)), 1.0)
    (jl, jm), (tl, tm) = jmodel.loss_fn(jp, jcfg, jb), loss_fn(tp, cfg, tb)
    assert abs(tl.item() - float(jl)) <= TOL * abs(float(jl))
    assert abs(tm["xent"].item() - float(jm["xent"])) <= TOL * abs(
        float(jm["xent"]))
    if cfg.family == "moe":        # the aux term is in the loss only
        assert tl.item() - tm["xent"].item() == pytest.approx(
            0.01 * tm["aux"].item(), abs=1e-6)
        assert aux.item() > 0.5
    else:
        assert aux.item() == 0.0


def _decode_runs(name, jdtype, tdtype):
    """prefill + decode on both packages: [(logits, state leaves)] per
    call, reference then port."""
    jcfg, jp, tokens, cfg, tp = _case(name)
    js = jmodel.init_decode_state(jcfg, B, MAX_SEQ, dtype=jdtype)
    ts = init_decode_state(cfg, B, MAX_SEQ, dtype=tdtype, device="cpu")
    assert list(_state_leaves(ts)) == list(_state_leaves(js))
    lg, js = _jprefill(jp, jcfg, {"tokens": jnp.asarray(tokens[:, :SP])},
                       js)
    want = [(_host(lg), _state_leaves(js))]
    tl, ts = prefill(tp, cfg, {"tokens": torch.as_tensor(
        tokens[:, :SP]).long()}, ts)
    got = [(_host(tl), _state_leaves(ts))]
    for i in range(SP, S):
        lg, js = _jdecode(jp, jcfg, jnp.asarray(tokens[:, i:i + 1]),
                          jnp.full((B,), i, jnp.int32), js)
        want.append((_host(lg), _state_leaves(js)))
        tl, ts = decode_step(tp, cfg, torch.as_tensor(
            tokens[:, i:i + 1]).long(), torch.full((B,), i,
                                                   dtype=torch.int32), ts)
        got.append((_host(tl), _state_leaves(ts)))
    return want, got


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_decode_match_reference(name):
    want, got = _decode_runs(name, jnp.float32, torch.float32)
    for step, ((jl, js), (tl, ts)) in enumerate(zip(want, got)):
        assert _nerr(tl, jl) <= TOL, step
        for path, w in js.items():
            g = ts[path]
            assert g.shape == w.shape and g.dtype == w.dtype, (step, path)
            if path.endswith("pos"):
                np.testing.assert_array_equal(g, w, err_msg=path)
            elif np.any(w):
                assert _nerr(g, w) <= TOL, (step, path)
            else:
                assert not np.any(g), (step, path)


@pytest.mark.parametrize("name", ["mamba2-2.7b", "zamba2-1.2b"])
def test_bfloat16_state_rounding_gap_bounded(name):
    """The port writes the conv states into the bfloat16 state in place
    (rounded); the reference's prefill and decode return them in the
    compute dtype.  Logits stay within BF16_STATE of the reference's."""
    want, got = _decode_runs(name, jnp.bfloat16, torch.bfloat16)
    gaps = [_nerr(tl, jl) for (jl, _), (tl, _) in zip(want, got)]
    assert gaps[0] <= TOL          # the prefill reads no rounded state
    assert 0.0 < max(gaps[1:]) <= BF16_STATE, gaps


def _naive_greedy(jcfg, jp, prompt, n):
    st = jmodel.init_decode_state(jcfg, 1, 64, dtype=jnp.float32)
    lg, st = _jprefill(jp, jcfg, {"tokens": jnp.asarray(prompt[None])}, st)
    out, pos = [int(jnp.argmax(lg[0]))], len(prompt)
    while len(out) < n:
        lg, st = _jdecode(jp, jcfg, jnp.asarray([[out[-1]]], jnp.int32),
                          jnp.asarray([pos], jnp.int32), st)
        out.append(int(jnp.argmax(lg[0])))
        pos += 1
    return out


@pytest.mark.parametrize("name", ["mamba2-2.7b", "zamba2-1.2b",
                                  "granite-moe-1b-a400m"])
def test_engine_matches_reference_naive_decode(name):
    """5 prompts through 2 slots: every slot is refilled, so each prefill
    must reset the SSM and conv states (and the caches) it inherits."""
    jcfg, jp, _, cfg, tp = _case(name)
    rng = np.random.RandomState(0)
    # two prompt lengths: each is one compile of the reference's prefill
    prompts = [rng.randint(0, cfg.vocab_size, size=n)
               for n in (4, 7, 4, 7, 7)]
    eng = ServingEngine(tp, cfg, max_batch=2, max_seq=64,
                        cache_dtype=torch.float32, device="cpu")
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    assert len(eng.run()) == len(prompts)
    for req, prompt in zip(reqs, prompts):
        want = _naive_greedy(jcfg, jp, np.asarray(prompt, np.int32), 6)
        assert req.out_tokens == want, (req.rid, req.out_tokens, want)


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "zamba2-1.2b"])
def test_int8_cache_decode_within_reference_bound(name):
    _, _, tokens, cfg, tp = _case(name, "bfloat16")
    tok = torch.as_tensor(tokens[:1]).long()
    full = forward(tp, cfg, {"tokens": tok})[0].float()
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    st = init_decode_state(cfg8, 1, S, device="cpu")
    caches = st["attn_caches" if cfg.family == "hybrid" else "layer_caches"]
    assert caches["k"].dtype == torch.int8 and "k_scale" in caches
    lg, st = prefill(tp, cfg8, {"tokens": tok[:, :SP]}, st)
    errs = [float((lg.float() - full[:, SP - 1]).abs().max())]
    for i in range(SP, S):
        lg, st = decode_step(tp, cfg8, tok[:, i:i + 1],
                             torch.full((1,), i, dtype=torch.int32), st)
        errs.append(float((lg.float() - full[:, i]).abs().max()))
    assert max(errs) < 0.25, errs


# ---------------------------------------------------------------------------
# curvature and the train step
# ---------------------------------------------------------------------------

def _flat(tree):
    if isinstance(tree, dict) and all(isinstance(v, torch.Tensor)
                                      for v in flatten(tree).values()):
        return np.concatenate([v.detach().double().numpy().ravel()
                               for _, v in sorted(flatten(tree).items())])
    return np.concatenate([np.asarray(l, np.float64).ravel()
                           for l in jax.tree.leaves(tree)])


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "mamba2-2.7b",
                                  "zamba2-1.2b"])
def test_hvp_diag_ggn_match_reference_oracles(name):
    jcfg, jp, tokens, cfg, tp = _case(name)
    jt = jtargets(jcfg, {"tokens": jnp.asarray(tokens)})
    tt = lm_curvature_targets(cfg, batch_from_numpy({"tokens": tokens},
                                                    "cpu"))
    jv = jax.tree.map(lambda l: jnp.full(l.shape, 0.01, l.dtype), jp)
    tv = lm_params_from_numpy(jax.tree.map(np.asarray, jv), "cpu")
    p = engine.plan(tt.loss, None, csize=CSIZE, backend="pytree_fwdrev",
                    device="cpu",
                    options={"n_probes": N_PROBES, **tt.plan_options()})

    want = jax.jit(lambda a, v: jc.pytree_hvp(jt.loss, a, v))(jp, jv)
    assert _nerr(_flat(p.hvp(tp, tv)), _flat(want)) <= CURV_TOL
    want = jax.jit(lambda a, v: jc.ggn_hvp(jt.model_fn, jt.head_loss, a,
                                           v))(jp, jv)
    assert _nerr(_flat(p.ggn(tp, tv)), _flat(want)) <= CURV_TOL
    # the Hutchinson diagonal mean_i z_i * H z_i on Rademacher probes drawn
    # with numpy, its oracle from the reference's HVP
    rs = np.random.RandomState(3)
    zs = {k: rs.choice([-1.0, 1.0], size=(N_PROBES,) + v.shape)
          .astype(np.float32) for k, v in sorted(flatten(tp).items())}
    jhvp = jax.jit(lambda a, v: jc.pytree_hvp(jt.loss, a, v))
    want = [jax.tree.map(lambda z, hz: z * hz, z, jhvp(jp, z))
            for z in (jax.tree.map(jnp.asarray, unflatten(
                {k: v[i] for k, v in zs.items()})) for i in range(N_PROBES))]
    want = jax.tree.map(lambda *l: sum(l) / N_PROBES, *want)
    got = tc._diag_from_probes(tc._hvp_map(tt.loss, tp),
                               lm_params_from_numpy(zs, "cpu"), CSIZE)
    assert _nerr(_flat(got), _flat(want)) <= CURV_TOL
    d = p.diag(tp, 3)
    assert sorted(flatten(d)) == sorted(flatten(tp))
    assert all(bool(torch.isfinite(x).all()) for x in flatten(d).values())


@pytest.mark.parametrize("name", FAMILIES)
def test_adamw_step_matches_reference(name):
    jcfg, jp, _, cfg, tp = _case(name)
    opt = adamw(warmup_cosine(1e-2, 1, 4))
    jopt = jadamw(jwarmup(1e-2, 1, 4))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int64), 1)
    jstate = jtraining.TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32),
                                  jax.random.PRNGKey(1))
    ds = SyntheticTokens(cfg.vocab_size, B, S, 0, device="cpu")
    jds = JSyntheticTokens(cfg.vocab_size, B, S, 0)
    step = make_train_step(cfg, None, opt)
    jstep = jtraining.make_train_step(jcfg, None, jopt)
    # step 0 runs at lr 0 (the warmup) and fills the moments; step 1 moves
    # the params (a first Adam step alone is lr * sign(g), which flips on
    # noise-level gradients)
    for k in range(2):
        state, m = step(state, {"tokens": ds.batch_at(k)})
        jstate, jm = jstep(jstate, {"tokens": jds.batch_at(k)})
        for key in ("loss", "grad_norm", "aux"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=TOL, atol=1e-7, err_msg=key)
    got = {k: v.numpy() for k, v in flatten(state.params).items()}
    want = jflatten(jax.tree.map(np.asarray, jstate.params))
    assert sorted(got) == sorted(want)
    assert _nerr(np.concatenate([got[k].ravel() for k in sorted(want)]),
                 np.concatenate([want[k].ravel() for k in sorted(want)])) \
        <= TOL
