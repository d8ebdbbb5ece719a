"""The port's continuous-batching decode engine
(repro_torch.models.decode_engine.ServingEngine) against naive one-request
greedy decode and against the reference's ServingEngine.

Tokens are compared for equality (greedy argmax takes the first maximum
in both packages).  The engine against naive decode runs the port alone at
the configs' own bfloat16 compute, as tests/test_decode_engine.py runs the
reference; the engine against the reference's engine runs both at float32
compute on the same params (JAX's), with each engine's default bfloat16
cache.  Logits kept by a reused slot are held bitwise against a fresh
engine's.  Few distinct prompt lengths keep the reference's jit compiles
(one per prompt length) cheap.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models.decode_engine import \
    ServingEngine as JServingEngine  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models.decode_engine import ServingEngine  # noqa: E402
from repro_torch.models.model import (decode_step,  # noqa: E402
                                      init_decode_state, prefill)
from repro_torch.models.params import init_params  # noqa: E402

MAX_SEQ = 64


def _cfg(name, **over):
    cfg = base.get_config(name, reduced=True)
    if name == "h2o-danube-1.8b":        # a ring of 8 slots, so decode wraps
        over.setdefault("sliding_window", 8)
    return dataclasses.replace(cfg, **over)


def _prompts(cfg, n, lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, size=int(lengths[i % len(lengths)]))
            .astype(np.int32) for i in range(n)]


def naive_greedy(params, cfg, prompt, max_new, max_seq=MAX_SEQ):
    """One request alone: batch-1 prefill, then batch-1 decode steps."""
    with torch.inference_mode():
        state = init_decode_state(cfg, 1, max_seq, device="cpu")
        toks = torch.as_tensor(prompt[None, :]).long()
        lg, state = prefill(params, cfg, {"tokens": toks}, state)
        out = [int(torch.argmax(lg[0]))]
        pos = len(prompt)
        while len(out) < max_new:
            lg, state = decode_step(params, cfg, torch.tensor([[out[-1]]]),
                                    torch.tensor([pos]), state)
            out.append(int(torch.argmax(lg[0])))
            pos += 1
    return out


@pytest.mark.parametrize("name", ["qwen1.5-4b", "h2o-danube-1.8b"])
def test_engine_matches_naive_decode(name):
    cfg = _cfg(name)
    params = init_params(cfg, 0, device="cpu")
    prompts = _prompts(cfg, 5, (3, 7, 10))
    eng = ServingEngine(params, cfg, max_batch=2, max_seq=MAX_SEQ,
                        device="cpu")
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    done = eng.run()
    assert len(done) == len(prompts)
    assert all(r.done and len(r.out_tokens) == 6 for r in reqs)
    for req, prompt in zip(reqs, prompts):
        want = naive_greedy(params, cfg, prompt, 6)
        assert req.out_tokens == want, (req.rid, req.out_tokens, want)
    # every tensor of the engine's state was made under inference_mode
    assert all(c.is_inference() for c in eng.state["layer_caches"].values())


@pytest.fixture(scope="module")
def jax_params():
    jp = jinit(jbase.get_config("qwen1.5-4b", reduced=True),
               jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jp)


def test_engine_matches_reference_engine(jax_params):
    """Both engines at float32 compute on JAX's params: 3 slots, 6 requests
    (two prompt lengths), 5 tokens each, the same tokens request by
    request."""
    jcfg = dataclasses.replace(jbase.get_config("qwen1.5-4b", reduced=True),
                               compute_dtype="float32")
    cfg = _cfg("qwen1.5-4b", compute_dtype="float32")
    prompts = _prompts(cfg, 6, (4, 9), seed=1)
    jeng = JServingEngine(jax_params, jcfg, max_batch=3, max_seq=MAX_SEQ)
    jreqs = [jeng.submit(p, max_new_tokens=5) for p in prompts]
    jeng.run()
    eng = ServingEngine(lm_params_from_numpy(jax_params, "cpu"), cfg,
                        max_batch=3, max_seq=MAX_SEQ, device="cpu")
    reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.run()
    for req, jreq in zip(reqs, jreqs):
        assert len(req.out_tokens) == 5
        assert req.out_tokens == jreq.out_tokens, (req.rid, req.out_tokens,
                                                   jreq.out_tokens)
    # the decode state after the run: same positions in every slot
    np.testing.assert_array_equal(
        eng.state["layer_caches"]["pos"].numpy(),
        np.asarray(jeng.state["layer_caches"]["pos"]))


def test_eos_frees_slot_early():
    """EOS produced by the prefill ends a request at one token; EOS later
    ends it at that token; either way the slot serves the next request at
    once (one slot, three requests, same tokens as naive decode)."""
    cfg = _cfg("qwen1.5-4b")
    params = init_params(cfg, 0, device="cpu")
    p = np.arange(5, dtype=np.int32)
    q = np.arange(7, 13, dtype=np.int32)
    naive_p = naive_greedy(params, cfg, p, 8)
    naive_q = naive_greedy(params, cfg, q, 8)
    eng = ServingEngine(params, cfg, max_batch=1, max_seq=MAX_SEQ,
                        device="cpu")
    r1 = eng.submit(p, max_new_tokens=50, eos_id=naive_p[0])
    later = naive_q[3]
    r2 = eng.submit(q, max_new_tokens=50, eos_id=later)
    r3 = eng.submit(p, max_new_tokens=4)
    done = eng.run()
    assert done[0] is r1 and r1.done and r1.out_tokens == naive_p[:1]
    assert r2.done and r2.out_tokens == naive_q[:naive_q.index(later) + 1]
    assert r3.done and r3.out_tokens == naive_p[:4]
    assert [r.rid for r in done] == [0, 1, 2]


def test_reused_slot_matches_fresh_engine():
    """A slot that served a longer request first gives the next request the
    same tokens and bitwise the same logits as a fresh engine: the reset
    clears pos to -1 and k/v to 0 before the prefill."""
    cfg = _cfg("h2o-danube-1.8b", compute_dtype="float32")
    params = init_params(cfg, 2, device="cpu")
    first, second = _prompts(cfg, 2, (12, 3), seed=4)
    used = ServingEngine(params, cfg, max_batch=1, max_seq=MAX_SEQ,
                         device="cpu")
    used.submit(first, max_new_tokens=9)
    used.run()
    assert int((used.state["layer_caches"]["pos"] >= 0).sum()) > 0
    again = used.submit(second, max_new_tokens=6, keep_logits=True)
    used.run()
    fresh = ServingEngine(params, cfg, max_batch=1, max_seq=MAX_SEQ,
                          device="cpu")
    want = fresh.submit(second, max_new_tokens=6, keep_logits=True)
    fresh.run()
    assert again.out_tokens == want.out_tokens
    assert len(again.out_logits) == len(want.out_logits) == 6
    for got, ref in zip(again.out_logits, want.out_logits):
        assert got.dtype == torch.float32 and got.shape == (cfg.vocab_size,)
        assert torch.equal(got, ref)
    for k, c in used.state["layer_caches"].items():
        assert torch.equal(c, fresh.state["layer_caches"][k]), k


def test_temperature_sampling_is_seeded():
    cfg = _cfg("qwen1.5-4b")
    params = init_params(cfg, 0, device="cpu")
    prompts = _prompts(cfg, 3, (4,), seed=5)

    def run(seed):
        eng = ServingEngine(params, cfg, max_batch=2, max_seq=MAX_SEQ,
                            temperature=1.0, seed=seed, device="cpu")
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run()
        return [r.out_tokens for r in reqs]

    a, b, c = run(3), run(3), run(4)
    assert a == b
    assert a != c
    assert all(0 <= t < cfg.vocab_size for toks in a for t in toks)


def test_engine_runs_on_the_card_by_default():
    cfg = _cfg("qwen1.5-4b")
    params = init_params(cfg, 0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="params"):
            ServingEngine(params, cfg)
