"""The port's enc-dec (whisper-base) and VLM (internvl2-1b) families
against the JAX package on the same numpy inputs: params of the reduced
configs drawn with numpy from a seed by the parameter table's
initializers (``encoder/...``, ``layers/cross/...`` and
``frontend_adapter`` among them) and carried into the port by
``lm_params_from_numpy``; tokens, audio frames and VLM patches from a
numpy seed; B = 2 and 16 positions (whisper: 16 tokens and its 24
frames; internvl2: its 8 patches and 8 tokens).  The reference's own
``init_params`` trees carry across too, leaf for leaf.

Tolerances (normalized error ||got - want|| / ||want|| unless named):
  * float32 compute: logits, loss and xent 1e-5 of the reference's;
  * ``sinusoid`` at d in {2, 64}, positions to 1,443: 1e-6 + the
    position times two float32 ulps of a frequency, absolute, of the
    reference's and of float64;
  * prefill (12 positions) then 4 decode steps at float32 compute and
    state: the logits and the decode state, leaf by leaf, ``cross_kv``
    included, 1e-5 of the reference's (``pos`` equal); the logits within
    max-abs 1e-4 of the port's own full forward
    (tests/test_models.py::test_prefill_decode_matches_forward's bound);
  * bfloat16 state: the port's prefill writes ``cross_kv`` into the
    bfloat16 state (rounded), the reference's keeps it in the compute
    dtype (by design); the decode logits stay within 1e-2 of
    the reference's;
  * two AdamW steps at 1e-5 of the reference's single-device step;
  * hvp, ggn and fisher through ``engine.plan(...,
    backend="pytree_fwdrev")`` at 1e-6 of the reference's oracles
    (tests/test_zoo_conformance.py's bound), but whisper's hvp and fisher
    at 1e-5: the reference's own float32 products lie 2.3e-6 and 2.2e-6
    from float64 there;
  * the engine serves internvl2 text-only with the reference engine's
    greedy tokens, and refuses whisper.
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
from repro.data import global_batch_at as jglobal_batch_at  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.decode_engine import \
    ServingEngine as JServingEngine  # noqa: E402
from repro.models.params import flatten as jflatten  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.models.targets import lm_curvature_targets as jtargets  # noqa
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim.schedule import warmup_cosine as jwarmup  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.convert import (batch_from_numpy,  # noqa: E402
                                 decode_state_to_numpy, lm_params_from_numpy)
from repro_torch.data import global_batch_at  # noqa: E402
from repro_torch.models.decode_engine import ServingEngine  # noqa: E402
from repro_torch.models.model import (decode_state_logical,  # noqa: E402
                                      decode_step, forward, init_decode_state,
                                      loss_fn, prefill)
from repro_torch.models.params import flatten, param_table  # noqa: E402
from repro_torch.models.params import unflatten  # noqa: E402
from repro_torch.models.targets import lm_curvature_targets  # noqa: E402
from repro_torch.models.transformer import sinusoid  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.schedule import warmup_cosine  # noqa: E402
from repro_torch.training import TrainState, make_train_step  # noqa: E402

NAMES = ("whisper-base", "internvl2-1b")
B, S, SP, MAX_SEQ = 2, 16, 12, 24
TOL = 1e-5
DEC_ABS = 1e-4
CURV_TOL = 1e-6
# whisper's float32 HVP and Fisher product are noisier than the bound
# above: the reference's lie 2.3e-6 and 2.2e-6, the port's 1.6e-6 and
# 2.6e-6, from the port's float64 products at these inputs
WHISPER_NOISE = 1e-5
NOISY = {("whisper-base", "hvp"), ("whisper-base", "fisher")}
BF16_STATE = 1e-2

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
    """{path: float32 array}: normal at the fan-in scale, zeros / ones."""
    rs = np.random.RandomState(seed)
    out = {}
    for path, spec in sorted(param_table(cfg).items()):
        shape = spec.shape
        if spec.init in ("zeros", "ones"):
            a = np.full(shape, 1.0 if spec.init == "ones" else 0.0)
        else:
            fan_in = shape[-3] if len(shape) >= 3 else shape[-2] \
                if len(shape) == 2 else shape[-1]
            a = rs.randn(*shape) * min(0.02, 1.0 / np.sqrt(fan_in))
        out[path] = a.astype(np.float32)
    return out


def _case(name):
    """Both configs (float32 compute), the params in both packages and a
    numpy batch of S positions."""
    if name not in _CASES:
        jcfg = dataclasses.replace(jbase.get_config(name, reduced=True),
                                   compute_dtype="float32")
        cfg = dataclasses.replace(base.get_config(name, reduced=True),
                                  compute_dtype="float32")
        flat = _numpy_params(cfg)
        rs = np.random.RandomState(1)
        F = cfg.frontend_len
        key = "frames" if cfg.frontend == "audio" else "patches"
        n_tok = S - F if key == "patches" else S
        batch = {"tokens": rs.randint(0, cfg.vocab_size, (B, n_tok))
                 .astype(np.int32),
                 key: rs.randn(B, F, cfg.d_model).astype(np.float32)}
        _CASES[name] = (jcfg, jax.tree.map(jnp.asarray, unflatten(flat)),
                        batch, cfg, lm_params_from_numpy(flat, "cpu"))
    return _CASES[name]


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


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
# forward, loss, sinusoid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_forward_and_loss_match_reference(name):
    jcfg, jp, batch, cfg, tp = _case(name)
    jlg, _, _ = jax.jit(jmodel.forward, static_argnums=(1,))(
        jp, jcfg, _jbatch(batch))
    lg, aux, st = forward(tp, cfg, batch_from_numpy(batch, "cpu"))
    assert st is None and lg.dtype == torch.float32 and aux.item() == 0.0
    assert lg.shape == (B, S, cfg.vocab_size)
    assert _nerr(lg, jlg) <= TOL
    jl, _ = jax.jit(jmodel.loss_fn, static_argnums=(1,))(
        jp, jcfg, _jbatch(batch))
    tl, tm = loss_fn(tp, cfg, batch_from_numpy(batch, "cpu"))
    assert abs(tl.item() - float(jl)) <= TOL * abs(float(jl))
    assert tm["xent"].item() == tl.item()


@pytest.mark.parametrize("name", NAMES)
def test_reference_init_params_carry_across(name):
    """The reference's own ``init_params`` tree (whisper's ``encoder/...``
    and ``layers/cross/...``, both families' ``frontend_adapter``) carries
    into the port with the port's table's paths, shapes and dtypes, and
    the port's forward on it is the reference's."""
    jcfg, _, batch, cfg, _ = _case(name)
    jp = jinit_params(jcfg, jax.random.PRNGKey(3))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    table = param_table(cfg)
    got = flatten(tp)
    assert sorted(got) == sorted(table)
    assert "frontend_adapter" in got
    if name == "whisper-base":
        assert any(p.startswith("layers/cross/") for p in got)
        assert any(p.startswith("encoder/layers/") for p in got)
    for path, spec in table.items():
        assert tuple(got[path].shape) == spec.shape, path
        assert got[path].dtype == torch.float32, path
    want = jax.jit(jmodel.forward, static_argnums=(1,))(
        jp, jcfg, _jbatch(batch))[0]
    assert _nerr(forward(tp, cfg, batch_from_numpy(batch, "cpu"))[0],
                 want) <= TOL


@pytest.mark.parametrize("d", [2, 64])
def test_sinusoid_matches_reference(d):
    """Up to whisper's 1,500 frames.  XLA's and torch's float32 ``exp``
    may part by one ulp on a frequency (<= 1, so <= 2**-24), which moves
    the angle at position p by p * 2**-24: the bound is twice that at the
    largest position, beside sin's own 1e-6."""
    pos = np.arange(40, dtype=np.int32).reshape(2, 20) * 37
    want = np.asarray(jtf.sinusoid(jnp.asarray(pos), d))
    got = sinusoid(torch.as_tensor(pos), d)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 + 2 * pos.max() * 2.0 ** -24)
    exact = pos[..., None] * np.exp(-np.arange(d // 2) * np.log(1e4)
                                    / max(d // 2 - 1, 1))
    np.testing.assert_allclose(
        got.numpy(), np.concatenate([np.sin(exact), np.cos(exact)], -1),
        rtol=0, atol=1e-6 + 2 * pos.max() * 2.0 ** -24)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

def _decode_runs(name, jdtype, tdtype):
    """prefill of SP positions, then decode to S, on both packages:
    [(logits, state leaves)] per call, reference then port; and the
    port's full forward."""
    jcfg, jp, batch, cfg, tp = _case(name)
    off = cfg.frontend_len if cfg.frontend == "vlm" else 0
    pre = dict(batch, tokens=batch["tokens"][:, :SP - off])
    js = jmodel.init_decode_state(jcfg, B, MAX_SEQ, dtype=jdtype)
    ts = init_decode_state(cfg, B, MAX_SEQ, dtype=tdtype, device="cpu")
    assert list(_state_leaves(ts)) == list(_state_leaves(js))
    lg, js = _jprefill(jp, jcfg, _jbatch(pre), js)
    want = [(_host(lg), _state_leaves(js))]
    tl, ts = prefill(tp, cfg, batch_from_numpy(pre, "cpu"), ts)
    got = [(_host(tl), _state_leaves(ts))]
    for i in range(SP, S):
        tok = batch["tokens"][:, i - off:i - off + 1]
        lg, js = _jdecode(jp, jcfg, jnp.asarray(tok),
                          jnp.full((B,), i, jnp.int32), js)
        want.append((_host(lg), _state_leaves(js)))
        tl, ts = decode_step(tp, cfg, torch.as_tensor(tok).long(),
                             torch.full((B,), i, dtype=torch.int32), ts)
        got.append((_host(tl), _state_leaves(ts)))
    full = _host(forward(tp, cfg, batch_from_numpy(batch, "cpu"))[0])
    return want, got, full


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_reference_and_forward(name):
    want, got, full = _decode_runs(name, jnp.float32, torch.float32)
    for step, ((jl, js), (tl, ts)) in enumerate(zip(want, got)):
        assert _nerr(tl, jl) <= TOL, step
        assert float(np.abs(tl - full[:, SP - 1 + step]).max()) <= DEC_ABS
        for path, w in js.items():
            g = ts[path]
            assert g.shape == w.shape and g.dtype == w.dtype, (step, path)
            if path.endswith("pos"):
                np.testing.assert_array_equal(g, w, err_msg=path)
            elif np.any(w):
                assert _nerr(g, w) <= TOL, (step, path)
            else:
                assert not np.any(g), (step, path)
    if name == "whisper-base":
        assert np.any(got[-1][1]["cross_kv/k"])


def test_bfloat16_cross_kv_rounding_gap_bounded():
    """The port writes the prefill's cross_kv into the bfloat16 state in
    place (rounded); the reference's prefill returns it in the compute
    dtype.  The decode logits stay within BF16_STATE of the
    reference's."""
    want, got, _ = _decode_runs("whisper-base", jnp.bfloat16,
                                torch.bfloat16)
    assert got[-1][1]["cross_kv/k"].dtype == np.float32     # bf16, read
    gaps = [_nerr(tl, jl) for (jl, _), (tl, _) in zip(want, got)]
    assert gaps[0] <= TOL          # the prefill reads no rounded cross_kv
    assert 0.0 < max(gaps[1:]) <= BF16_STATE, gaps


@pytest.mark.parametrize("name", NAMES)
def test_decode_state_logical_matches_reference(name):
    jcfg, _, _, cfg, _ = _case(name)
    want = jmodel.decode_state_logical(
        jcfg, jmodel.init_decode_state(jcfg, B, MAX_SEQ))
    got = decode_state_logical(cfg, init_decode_state(cfg, B, MAX_SEQ,
                                                      device="cpu"))
    assert got == want
    if name == "whisper-base":
        assert got["cross_kv"]["k"] == (None, "batch", None, "kv_heads",
                                        None)


# ---------------------------------------------------------------------------
# the train step and curvature
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_adamw_steps_match_reference(name):
    jcfg, jp, _, cfg, _ = _case(name)
    jp = jax.tree.map(jnp.array, jp)     # the reference's step donates it
    opt = adamw(warmup_cosine(1e-2, 1, 4))
    jopt = jadamw(jwarmup(1e-2, 1, 4))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int64), 1)
    jstate = jtraining.TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32),
                                  jax.random.PRNGKey(1))
    shape = base.InputShape("train", S, B, "train")
    step = make_train_step(cfg, None, opt)
    jstep = jtraining.make_train_step(jcfg, None, jopt)
    # step 0 runs at lr 0 (the warmup) and fills the moments
    for k in range(2):
        state, m = step(state, global_batch_at(cfg, shape, k, device="cpu"))
        jstate, jm = jstep(jstate, jglobal_batch_at(jcfg, shape, k))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=TOL, atol=1e-7, err_msg=key)
    got = {k: v.numpy() for k, v in flatten(state.params).items()}
    want = jflatten(jax.tree.map(np.asarray, jstate.params))
    assert sorted(got) == sorted(want)
    assert _nerr(np.concatenate([got[k].ravel() for k in sorted(want)]),
                 np.concatenate([want[k].ravel() for k in sorted(want)])) \
        <= TOL


def _flat(tree):
    if isinstance(tree, dict) and all(isinstance(v, torch.Tensor)
                                      for v in flatten(tree).values()):
        return np.concatenate([v.detach().double().numpy().ravel()
                               for _, v in sorted(flatten(tree).items())])
    return np.concatenate([np.asarray(l, np.float64).ravel()
                           for l in jax.tree.leaves(tree)])


@pytest.mark.parametrize("name", NAMES)
def test_hvp_ggn_fisher_match_reference_oracles(name):
    jcfg, jp, batch, cfg, tp = _case(name)
    jt = jtargets(jcfg, _jbatch(batch))
    tt = lm_curvature_targets(cfg, batch_from_numpy(batch, "cpu"))
    jv = jax.tree.map(lambda l: jnp.full(l.shape, 0.01, l.dtype), jp)
    tv = lm_params_from_numpy(jax.tree.map(np.asarray, jv), "cpu")
    p = engine.plan(tt.loss, None, csize=2, backend="pytree_fwdrev",
                    device="cpu", options={"n_probes": 2,
                                           **tt.plan_options()})
    assert _nerr(_flat(tt.model_fn(tp)), _flat(jt.model_fn(jp))) <= TOL
    bound = {w: WHISPER_NOISE if (name, w) in NOISY else CURV_TOL
             for w in ("hvp", "ggn", "fisher")}
    want = jax.jit(lambda a, v: jc.pytree_hvp(jt.loss, a, v))(jp, jv)
    assert _nerr(_flat(p.hvp(tp, tv)), _flat(want)) <= bound["hvp"]
    want = jax.jit(lambda a, v: jc.ggn_hvp(jt.model_fn, jt.head_loss, a,
                                           v))(jp, jv)
    assert _nerr(_flat(p.ggn(tp, tv)), _flat(want)) <= bound["ggn"]
    want = jax.jit(lambda a, v: jc.empirical_fisher_vp(
        jt.per_example_fn, a, v))(jp, jv)
    assert _nerr(_flat(p.fisher(tp, tv)), _flat(want)) <= bound["fisher"]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_engine_serves_vlm_text_only_and_refuses_encdec():
    """5 text-only prompts through 2 slots (each slot refilled): the
    port's engine at float32 compute emits the reference engine's greedy
    tokens (its caches bfloat16, the reference engine's fixed dtype), and
    at float32 caches the reference's float32-state greedy decode."""
    jcfg, jp, _, cfg, tp = _case("internvl2-1b")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (4, 7, 4, 7, 7)]
    jeng = JServingEngine(jp, jcfg, max_batch=2, max_seq=64)
    jreqs = [jeng.submit(p, max_new_tokens=6) for p in prompts]
    jeng.run()
    for dtype in (torch.bfloat16, torch.float32):
        eng = ServingEngine(tp, cfg, max_batch=2, max_seq=64,
                            cache_dtype=dtype, device="cpu")
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        assert len(eng.run()) == len(prompts)
        for req, jreq, prompt in zip(reqs, jreqs, prompts):
            if dtype == torch.bfloat16:
                want = jreq.out_tokens
            else:
                want = _naive_greedy(jcfg, jp, prompt, 6)
            assert req.out_tokens == want, (dtype, req.rid)

    wcfg = base.get_config("whisper-base", reduced=True)
    with pytest.raises(ValueError, match="encoder-decoder"):
        ServingEngine(_case("whisper-base")[4], wcfg, device="cpu")


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
