"""The port's int8 KV cache (repro_torch.models.kv_quant and the "k_scale"
branches of the transformer) and the curvature-informed cache policy
against the JAX package.

Tolerances:
  * quantize_kv: int8 values equal, scales within 1e-7 relative;
  * int8 prefill + decode at float32 compute against the reference's int8
    decode: logits normalized error 1e-5; the cached int8 values may part
    by one step where the two packages' float32 k/v straddle a rounding
    boundary (at most 0.5% of them), the scales within 1e-5 relative;
  * int8 decode against the port's own full forward (bfloat16 compute, the
    config's own): the reference test's max-abs 0.25 (measured: 2.9e-3);
  * int8 decode against the bfloat16 cache's: 1e-2 normalized.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import kv_quant as jkv  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.models.targets import diag_spectrum as jdiag_spectrum  # noqa
from repro.models.transformer import init_attn_cache as jinit_cache  # noqa
from repro_torch.configs import base  # noqa: E402
from repro_torch.convert import (decode_state_to_numpy,  # noqa: E402
                                 lm_params_from_numpy)
from repro_torch.models import kv_quant  # noqa: E402
from repro_torch.models.attention import decode_attention  # noqa: E402
from repro_torch.models.model import (decode_step, forward,  # noqa: E402
                                      init_decode_state, prefill)
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.models.targets import diag_spectrum  # noqa: E402
from repro_torch.models.transformer import init_attn_cache  # noqa: E402

NAME = "qwen1.5-4b"
B, S, Sp = 2, 16, 12


def _nerr(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _int8_cfgs(compute_dtype):
    over = {"kv_cache_dtype": "int8", "compute_dtype": compute_dtype}
    return (dataclasses.replace(jbase.get_config(NAME, reduced=True), **over),
            dataclasses.replace(base.get_config(NAME, reduced=True), **over))


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_dequantize_match_reference(dtype):
    rs = np.random.RandomState(0)
    x = (rs.randn(4, 16, 8, 64) * 3.0).astype(np.float32)
    x[0, 0, 0] = 0.0                                   # an all-zero head
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jkv.quantize_kv(jx)
    tq, ts = kv_quant.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7,
                               atol=0)
    for out in ("float32", "bfloat16"):
        got = kv_quant.dequantize_kv(tq, ts, getattr(torch, out))
        want = jkv.dequantize_kv(jq, js, getattr(jnp, out))
        assert got.dtype == getattr(torch, out)
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)))
    # symmetric int8: the round trip errs by at most scale / 2 per element
    back = kv_quant.dequantize_kv(tq, ts, torch.float32)
    bound = tx.float().abs().amax(-1, keepdim=True) / 254.0 + 1e-6
    assert bool(((back - tx.float()).abs() <= bound + 1e-5).all())


def test_quant_cache_write_read_and_attention():
    """One token at a time into the int8 cache, against the reference's
    cache_write_one_quant; attention over it stays near the float cache's
    (the reference test's 0.05)."""
    jcfg, cfg = _int8_cfgs("float32")
    rs = np.random.RandomState(1)
    Bc, C, KV, hd, H = 2, 32, cfg.num_kv_heads, cfg.head_dim_, cfg.num_heads
    qc = kv_quant.init_quant_attn_cache(cfg, Bc, C, device="cpu")
    jqc = jkv.init_quant_attn_cache(jcfg, Bc, C)
    assert list(qc) == sorted(jqc)
    fk = torch.zeros((Bc, C, KV, hd))
    fv = torch.zeros((Bc, C, KV, hd))
    fpos = torch.full((Bc, C), -1, dtype=torch.int32)
    for t in range(16):
        k1 = rs.randn(Bc, 1, KV, hd).astype(np.float32)
        v1 = rs.randn(Bc, 1, KV, hd).astype(np.float32)
        pos = np.full((Bc,), t + 40, np.int32)         # slot (t + 40) % 32
        got = kv_quant.cache_write_one_quant(
            qc, torch.from_numpy(k1), torch.from_numpy(v1),
            torch.from_numpy(pos))
        assert got is qc                                # in place
        jqc = jkv.cache_write_one_quant(jqc, jnp.asarray(k1),
                                        jnp.asarray(v1), jnp.asarray(pos))
        fk[:, (t + 40) % C] = torch.from_numpy(k1[:, 0])
        fv[:, (t + 40) % C] = torch.from_numpy(v1[:, 0])
        fpos[:, (t + 40) % C] = t + 40
    for k in jqc:
        np.testing.assert_array_equal(qc[k].numpy(), np.asarray(jqc[k]))
    q = torch.from_numpy(rs.randn(Bc, 1, H, hd).astype(np.float32))
    cur = torch.full((Bc,), 55)
    kq, vq = kv_quant.cache_read_quant(qc, torch.float32)
    jk, jv = jkv.cache_read_quant(jqc, jnp.float32)
    np.testing.assert_array_equal(kq.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(vq.numpy(), np.asarray(jv))
    out_q = decode_attention(q, kq, vq, qc["pos"], cur)
    out_f = decode_attention(q, fk, fv, fpos, cur)
    assert float((out_q - out_f).abs().max()) < 0.05


def test_memory_ratio():
    """The int8 cache's bytes against the bfloat16 one's, pos included, on
    the formula 2 * KV * (hd + 4) + 4 against 2 * KV * hd * 2 + 4 bytes per
    token and layer; at the full width's head_dim 80 the k/v ratio is
    0.525."""
    _, cfg8 = _int8_cfgs("bfloat16")
    cfg = base.get_config(NAME, reduced=True)
    Bc, C = 2, 128
    KV, hd = cfg.num_kv_heads, cfg.head_dim_

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree.values())

    q8 = init_attn_cache(cfg8, Bc, C, device="cpu")
    bf = init_attn_cache(cfg, Bc, C, device="cpu")
    assert q8["k"].dtype == torch.int8 and bf["k"].dtype == torch.bfloat16
    assert nbytes(q8) == Bc * C * (2 * KV * (hd + 4) + 4)
    assert nbytes(bf) == Bc * C * (2 * KV * hd * 2 + 4)
    want_q8 = jinit_cache(dataclasses.replace(
        jbase.get_config(NAME, reduced=True), kv_cache_dtype="int8"), Bc, C)
    assert nbytes(q8) == sum(x.size * x.dtype.itemsize
                             for x in jax.tree.leaves(want_q8))
    assert nbytes(q8) < 0.66 * nbytes(bf)
    full = base.get_config("h2o-danube-1.8b")
    assert full.head_dim_ == 80
    assert (2 * 8 * (80 + 4)) / (2 * 8 * 80 * 2) == 0.525


# ---------------------------------------------------------------------------
# the int8 cache end to end
# ---------------------------------------------------------------------------

def test_int8_decode_matches_reference_int8_decode():
    jcfg, cfg = _int8_cfgs("float32")
    jp = jinit(jbase.get_config(NAME, reduced=True), jax.random.PRNGKey(0))
    tokens = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jprefill = jax.jit(jmodel.prefill, static_argnums=(1,))
    jdecode = jax.jit(jmodel.decode_step, static_argnums=(1,))
    jst = jmodel.init_decode_state(jcfg, B, S + 8)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tok = torch.from_numpy(tokens).long()
    st = init_decode_state(cfg, B, S + 8, device="cpu")
    assert st["layer_caches"]["k"].dtype == torch.int8
    with torch.inference_mode():
        jlg, jst = jprefill(jp, jcfg, {"tokens": jnp.asarray(tokens[:, :Sp])},
                            jst)
        lg, st = prefill(tp, cfg, {"tokens": tok[:, :Sp]}, st)
        steps = [(lg, jlg, decode_state_to_numpy(st),
                  jax.tree.map(np.asarray, jst))]
        for i in range(Sp, S):
            jlg, jst = jdecode(jp, jcfg, jnp.asarray(tokens[:, i:i + 1]),
                               jnp.full((B,), i, jnp.int32), jst)
            lg, st = decode_step(tp, cfg, tok[:, i:i + 1],
                                 torch.full((B,), i), st)
            steps.append((lg, jlg, decode_state_to_numpy(st),
                          jax.tree.map(np.asarray, jst)))
    for n, (lg, jlg, got, want) in enumerate(steps):
        assert _nerr(lg.numpy(), np.asarray(jlg)) <= 1e-5, n
        got, want = got["layer_caches"], want["layer_caches"]
        assert list(got) == sorted(want)
        np.testing.assert_array_equal(got["pos"], want["pos"])
        for k in ("k", "v"):
            assert got[k].dtype == np.int8
            diff = np.abs(got[k].astype(np.int32) - want[k].astype(np.int32))
            assert diff.max() <= 1 and diff.mean() <= 5e-3, (n, k)
        for k in ("k_scale", "v_scale"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0)


def test_int8_decode_tracks_own_forward():
    """The reference's test_int8_cache_end_to_end_decode on the port: B = 1,
    prefill 12 of 16 tokens with the int8 cache, the config's bfloat16
    compute, each step's logits within max-abs 0.25 of the full forward."""
    _, cfg8 = _int8_cfgs("bfloat16")
    cfg = base.get_config(NAME, reduced=True)
    params = init_params(cfg, 0, device="cpu")
    tok = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (1, S))).long()
    with torch.inference_mode():
        full, _, _ = forward(params, cfg, {"tokens": tok}, mode="train")
        st = init_decode_state(cfg8, 1, S, device="cpu")
        lg, st = prefill(params, cfg8, {"tokens": tok[:, :Sp]}, st)
        errs = [float((lg.float() - full[:, Sp - 1].float()).abs().max())]
        for i in range(Sp, S):
            lg, st = decode_step(params, cfg8, tok[:, i:i + 1],
                                 torch.tensor([i]), st)
            errs.append(float((lg.float() - full[:, i].float()).abs().max()))
    assert max(errs) < 0.25, errs


@pytest.mark.parametrize("name", ["qwen1.5-4b", "h2o-danube-1.8b",
                                  "minitron-4b"])
def test_int8_decode_tracks_bfloat16_cache(name):
    """The int8 cache against the bfloat16 cache on the same tokens, both at
    the config's bfloat16 compute: the prefill's logits are the same (the
    prefill's attention reads no cache), each decode step's within 1e-2
    normalized (measured 3.8e-3 to 7.2e-3; the danube ring wraps at 48 of
    32 slots).  chip_smoke.py phase 13 (b) holds the full width to ten
    times this bound."""
    cfg = base.get_config(name, reduced=True)
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    params = init_params(cfg, 0, device="cpu")
    S2, Sp2 = 48, 40
    tok = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (B, S2))).long()

    def run(c):
        out = []
        with torch.inference_mode():
            st = init_decode_state(c, B, S2, device="cpu")
            lg, st = prefill(params, c, {"tokens": tok[:, :Sp2]}, st)
            out.append(lg.float())
            for i in range(Sp2, S2):
                lg, st = decode_step(params, c, tok[:, i:i + 1],
                                     torch.full((B,), i), st)
                out.append(lg.float())
        return out

    bf16, int8 = run(cfg), run(cfg8)
    assert torch.equal(int8[0], bf16[0])
    gaps = [_nerr(a.numpy(), b.numpy()) for a, b in zip(int8[1:], bf16[1:])]
    assert 0.0 < max(gaps) <= 1e-2, gaps


# ---------------------------------------------------------------------------
# the curvature-informed policy
# ---------------------------------------------------------------------------

def test_kv_policy_matches_reference():
    """kv_sensitivity and choose_kv_cache_dtype on one diag spectrum (the
    reduced qwen's params standing in for a Hessian diagonal, with made-up
    magnitudes per layer and one tie) equal the reference's, budget by
    budget."""
    jcfg = jbase.get_config(NAME, reduced=True)
    jcfg = dataclasses.replace(jcfg, num_layers=6)
    jp = jinit(jcfg, jax.random.PRNGKey(4))
    scale = jnp.asarray([3.0, 1.0, 2.0, 1.0, 0.5, 4.0])[:, None, None, None]
    jp["layers"]["attn"]["wk"] = jp["layers"]["attn"]["wk"] * scale
    jp["layers"]["attn"]["wv"] = jp["layers"]["attn"]["wv"] * scale
    host = jax.tree.map(np.asarray, jp)
    want_spec = jdiag_spectrum(host)
    got_spec = diag_spectrum(lm_params_from_numpy(host, "cpu"))
    assert list(got_spec) == list(want_spec)
    got = kv_quant.kv_sensitivity(got_spec)
    want = jkv.kv_sensitivity(want_spec)
    assert list(got) == list(want) == list(range(6))
    for layer in want:
        assert got[layer] == pytest.approx(want[layer], rel=1e-6)
    # one tie: the policy breaks it toward the lower layer
    tied = {**want, 3: want[1]}
    for frac in (0.0, 0.25, 0.5, 0.75, 1.0):
        assert kv_quant.choose_kv_cache_dtype(got, frac) == \
            jkv.choose_kv_cache_dtype(want, frac)
        assert kv_quant.choose_kv_cache_dtype(tied, frac) == \
            jkv.choose_kv_cache_dtype(tied, frac)
    policy = kv_quant.choose_kv_cache_dtype(got, 0.5)
    assert sum(v == "int8" for v in policy.values()) == 3
    assert kv_quant.choose_kv_cache_dtype({}, 0.5) == {}
    with pytest.raises(ValueError):
        kv_quant.choose_kv_cache_dtype(got, 1.5)
