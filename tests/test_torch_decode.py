"""The port's dense LM decode (repro_torch.models: decode_attention, the KV
caches, init_decode_state / prefill / decode_step, decode_state_logical)
against the JAX package on the same numpy inputs and params.

Cases: the reduced h2o-danube-1.8b with its window cut to 8 and S = 24
(a prefill of 20 tokens, so the ring of 8 slots wraps, as
tests/test_models.py::test_sliding_window_cache_ring_buffer runs it), the
reduced qwen1.5-4b (QKV bias) and minitron-4b (S = 16, prefill 12).  The
logits of the prefill and of every decode step, and the decode state leaf
by leaf after each of them, are held against the reference's.

Tolerances (normalized error ||got - want|| / ||want||):
  * float32 compute, float32 caches: 1e-5 (logits and k/v);
  * bfloat16 compute and caches (the configs' own): 1e-2 -- the two
    packages round bfloat16 matmul outputs in different orders, as in
    tests/test_torch_models.py;
  * ``pos`` leaves: equal, int32, -1 for empty slots;
  * the port's own prefill/decode against its own full forward: the
    reference test's max-abs 1e-4.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.convert import (decode_state_from_numpy,  # noqa: E402
                                 decode_state_to_numpy, lm_params_from_numpy)
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.models.model import (decode_state_logical,  # noqa: E402
                                      decode_step, forward,
                                      init_decode_state, prefill)

B = 2
# (config, window override, S, prefill length, max_seq)
CASES = {"h2o-danube-1.8b": (8, 24, 20, 24),
         "qwen1.5-4b": (None, 16, 12, 24),
         "minitron-4b": (None, 16, 12, 24)}
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}

_jprefill = jax.jit(jmodel.prefill, static_argnums=(1,))
_jdecode = jax.jit(jmodel.decode_step, static_argnums=(1,))


def _nerr(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _host(x):
    """A JAX array (bfloat16 included) or a tensor as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _cfgs(name, compute_dtype):
    window = CASES[name][0]
    jcfg = jbase.get_config(name, reduced=True)
    cfg = base.get_config(name, reduced=True)
    over = {"compute_dtype": compute_dtype}
    if window is not None:
        over["sliding_window"] = window
    return (dataclasses.replace(jcfg, **over),
            dataclasses.replace(cfg, **over))


def _check_state(got, want, tol, what):
    got = decode_state_to_numpy(got)["layer_caches"]
    want = {k: np.asarray(jnp.asarray(v, jnp.float32)
                          if v.dtype == jnp.bfloat16 else v)
            for k, v in want["layer_caches"].items()}
    assert list(got) == sorted(want), what
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        if k == "pos":
            assert got[k].dtype == np.int32, (what, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=what)
        else:
            assert _nerr(got[k], want[k]) <= tol, (what, k)


def _reference_run(jcfg, jp, tokens, Sp, max_seq, jdtype):
    """The reference's prefill + decode: logits and the state after each."""
    S = tokens.shape[1]
    st = jmodel.init_decode_state(jcfg, B, max_seq, dtype=jdtype)
    lg, st = _jprefill(jp, jcfg, {"tokens": jnp.asarray(tokens[:, :Sp])}, st)
    out = [(_host(lg), jax.tree.map(np.asarray, st))]
    for i in range(Sp, S):
        lg, st = _jdecode(jp, jcfg, jnp.asarray(tokens[:, i:i + 1]),
                          jnp.full((B,), i, jnp.int32), st)
        out.append((_host(lg), jax.tree.map(np.asarray, st)))
    return out


@pytest.fixture(scope="module")
def reference_runs():
    """The JAX side of every (config, dtype) case, computed once."""
    runs = {}
    for name, (_, S, Sp, max_seq) in CASES.items():
        jp = jinit(jbase.get_config(name, reduced=True),
                   jax.random.PRNGKey(0))
        tokens = np.random.RandomState(1).randint(
            0, jbase.get_config(name, reduced=True).vocab_size,
            (B, S)).astype(np.int32)
        for dname, (jdtype, _, _) in DTYPES.items():
            jcfg, _ = _cfgs(name, dname)
            runs[name, dname] = (jax.tree.map(np.asarray, jp), tokens,
                                 _reference_run(jcfg, jp, tokens, Sp,
                                                max_seq, jdtype))
    return runs


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,softcap,cache_dtype", [
    (None, None, "float32"), (5, None, "float32"), (None, 20.0, "float32"),
    (4, 30.0, "float32"), (6, None, "bfloat16")])
def test_decode_attention_matches_reference(window, softcap, cache_dtype):
    """GQA grouped (H = 6 over KV = 2), empty slots (-1), slots past the
    query's position, the window and the softcap."""
    rs = np.random.RandomState(7)
    Bq, C, H, KV, D = 3, 12, 6, 2, 8
    q = rs.randn(Bq, 1, H, D).astype(np.float32)
    k = rs.randn(Bq, C, KV, D).astype(np.float32)
    v = rs.randn(Bq, C, KV, D).astype(np.float32)
    pos = rs.randint(0, 20, (Bq, C)).astype(np.int32)
    pos[rs.rand(Bq, C) < 0.3] = -1
    cur = np.array([19, 11, 15], np.int32)
    pos[:, 0] = cur - 1                        # at least one kept slot
    jdt, tdt = DTYPES[cache_dtype][:2]
    want = jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(pos), jnp.asarray(cur), window=window, softcap=softcap)
    got = attention.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), torch.from_numpy(pos),
        torch.from_numpy(cur).long(), window=window, softcap=softcap)
    assert got.shape == want.shape == (Bq, 1, H, D)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert _nerr(_host(got), _host(want)) <= DTYPES[cache_dtype][2]
    # a fully empty cache row attends to nothing real: the keep mask, not
    # the values, decides -- slots past cur_pos are never read
    pos2 = pos.copy()
    pos2[0, 1:] = 50
    v2 = v.copy()
    v2[0, 1:] = 1e6
    again = attention.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v2).to(tdt), torch.from_numpy(pos2),
        torch.from_numpy(cur), window=window, softcap=softcap)
    assert bool(torch.isfinite(again).all())
    assert float(again[0].abs().max()) < 1e3


# ---------------------------------------------------------------------------
# caches and the decode state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,max_seq,kv_dtype", [
    ("h2o-danube-1.8b", 64, "bfloat16"), ("h2o-danube-1.8b", 16, "bfloat16"),
    ("qwen1.5-4b", 40, "bfloat16"), ("qwen1.5-4b", 40, "int8"),
    ("h2o-danube-1.8b", 64, "int8")])
def test_init_caches_match_reference(name, max_seq, kv_dtype):
    """One layer's cache and the stacked decode state: keys, shapes, dtypes
    and values; C = min(max_seq, window) under SWA."""
    jcfg = dataclasses.replace(jbase.get_config(name, reduced=True),
                               kv_cache_dtype=kv_dtype)
    cfg = dataclasses.replace(base.get_config(name, reduced=True),
                              kv_cache_dtype=kv_dtype)
    one = transformer.init_attn_cache(cfg, 3, max_seq, device="cpu")
    jone = jtf.init_attn_cache(jcfg, 3, max_seq)
    C = max_seq if cfg.sliding_window is None else min(max_seq,
                                                       cfg.sliding_window)
    assert one["k"].shape == (3, C, cfg.num_kv_heads, cfg.head_dim_)
    assert list(one) == sorted(jone)
    state = init_decode_state(cfg, 3, max_seq, device="cpu")
    jstate = jmodel.init_decode_state(jcfg, 3, max_seq)
    for got, want in ((one, jone), (state["layer_caches"],
                                    jstate["layer_caches"])):
        for k, w in want.items():
            g = got[k]
            assert tuple(g.shape) == w.shape, k
            assert str(g.dtype).split(".")[-1] == str(w.dtype), k
            np.testing.assert_array_equal(_host(g), _host(w))
    assert list(decode_state_from_numpy(
        jax.tree.map(np.asarray, jstate), "cpu")["layer_caches"]) == \
        list(state["layer_caches"])
    f32 = init_decode_state(cfg, 1, max_seq, dtype=torch.float32,
                            device="cpu")["layer_caches"]["k"]
    assert f32.dtype == (torch.int8 if kv_dtype == "int8" else torch.float32)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            init_decode_state(cfg, 1, max_seq)      # the card by default


def test_decode_state_converters_round_trip():
    jcfg = dataclasses.replace(jbase.get_config("qwen1.5-4b", reduced=True),
                               kv_cache_dtype="int8")
    rs = np.random.RandomState(3)
    for c in (jcfg, jbase.get_config("qwen1.5-4b", reduced=True)):
        jstate = jmodel.init_decode_state(c, 2, 8)
        jstate = jax.tree.map(
            lambda a: (a + jnp.asarray(rs.randint(-3, 4, a.shape), a.dtype)),
            jstate)
        host = jax.tree.map(np.asarray, jstate)
        st = decode_state_from_numpy(host, "cpu")
        back = decode_state_to_numpy(st)
        for k, w in host["layer_caches"].items():
            g = st["layer_caches"][k]
            assert str(g.dtype).split(".")[-1] == str(w.dtype), k
            np.testing.assert_array_equal(back["layer_caches"][k],
                                          np.asarray(w, back["layer_caches"]
                                                     [k].dtype))


@pytest.mark.parametrize("shard_cache_seq", [False, True])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_decode_state_logical_matches_reference(shard_cache_seq, kv_dtype):
    jcfg = dataclasses.replace(jbase.get_config("qwen1.5-4b", reduced=True),
                               shard_cache_seq=shard_cache_seq,
                               kv_cache_dtype=kv_dtype)
    cfg = dataclasses.replace(base.get_config("qwen1.5-4b", reduced=True),
                              shard_cache_seq=shard_cache_seq,
                              kv_cache_dtype=kv_dtype)
    want = jmodel.decode_state_logical(jcfg,
                                       jmodel.init_decode_state(jcfg, 2, 8))
    got = decode_state_logical(cfg, init_decode_state(cfg, 2, 8,
                                                      device="cpu"))
    assert got == want


# ---------------------------------------------------------------------------
# prefill + decode against the reference, and against the full forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("name", list(CASES))
def test_prefill_decode_match_reference(reference_runs, name, dname):
    """Logits of the prefill and of each decode step, and the whole state
    after each, leaf by leaf; the danube case wraps its ring of 8."""
    _, S, Sp, max_seq = CASES[name]
    _, tdtype, tol = DTYPES[dname]
    jp, tokens, want = reference_runs[name, dname]
    _, cfg = _cfgs(name, dname)
    tp = lm_params_from_numpy(jp, "cpu")
    tok = torch.from_numpy(tokens).long()
    state = init_decode_state(cfg, B, max_seq, dtype=tdtype, device="cpu")
    with torch.inference_mode():
        lg, state = prefill(tp, cfg, {"tokens": tok[:, :Sp]}, state)
        got = [(lg, decode_state_to_numpy(state))]
        for i in range(Sp, S):
            lg, state = decode_step(tp, cfg, tok[:, i:i + 1],
                                    torch.full((B,), i, dtype=torch.int32),
                                    state)
            got.append((lg, decode_state_to_numpy(state)))
    assert len(got) == len(want) == S - Sp + 1
    for step, ((glg, gst), (wlg, wst)) in enumerate(zip(got, want)):
        assert glg.shape == wlg.shape == (B, cfg.vocab_size)
        assert glg.dtype == tdtype
        assert _nerr(_host(glg), wlg) <= tol, (name, dname, step)
        _check_state({"layer_caches": {k: torch.from_numpy(v) for k, v in
                                       gst["layer_caches"].items()}},
                     wst, tol, (name, dname, step))
    pos = state["layer_caches"]["pos"]
    C = pos.shape[-1]
    # the ring holds exactly the last C positions of every sequence
    assert sorted(pos[0, 0].tolist()) == list(range(S - C, S)) or C >= S


@pytest.mark.parametrize("compute_dtype,cache_dtype", [
    ("float32", torch.float32), ("bfloat16", torch.bfloat16)])
@pytest.mark.parametrize("name", list(CASES))
def test_prefill_decode_match_own_forward(name, compute_dtype, cache_dtype):
    """The reference's tests/test_models.py check on the port alone:
    prefill's last logits and each decode step's logits against the
    train-mode forward of the whole sequence, max-abs 1e-4."""
    _, S, Sp, max_seq = CASES[name]
    _, cfg = _cfgs(name, compute_dtype)
    from repro_torch.models.params import init_params
    params = init_params(cfg, 0, device="cpu")
    tok = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (B, S))).long()
    with torch.inference_mode():
        full, _, none = forward(params, cfg, {"tokens": tok}, mode="train")
        assert none is None
        state = init_decode_state(cfg, B, max_seq, dtype=cache_dtype,
                                  device="cpu")
        lg, state = prefill(params, cfg, {"tokens": tok[:, :Sp]}, state)
        errs = [float((lg - full[:, Sp - 1]).abs().max())]
        for i in range(Sp, S):
            lg, state = decode_step(params, cfg, tok[:, i:i + 1],
                                    torch.full((B,), i, dtype=torch.int64),
                                    state)
            errs.append(float((lg - full[:, i]).abs().max()))
    assert max(errs) <= 1e-4, errs


def test_state_is_written_in_place():
    """prefill and decode_step hand back the state they were given, written
    in place: a caller keeps the state before with clone()."""
    _, cfg = _cfgs("h2o-danube-1.8b", "float32")
    from repro_torch.models.params import init_params
    params = init_params(cfg, 0, device="cpu")
    tok = torch.arange(10)[None].long()
    state = init_decode_state(cfg, 1, 24, dtype=torch.float32, device="cpu")
    k = state["layer_caches"]["k"]
    _, st = prefill(params, cfg, {"tokens": tok}, state)
    assert st["layer_caches"]["k"] is k
    before = {n: c.clone() for n, c in st["layer_caches"].items()}
    _, st2 = decode_step(params, cfg, tok[:, :1], torch.tensor([10]), st)
    assert st2["layer_caches"]["k"] is k
    assert not torch.equal(before["pos"], st2["layer_caches"]["pos"])
    assert int((st2["layer_caches"]["pos"] != before["pos"]).sum()) == \
        cfg.num_layers
