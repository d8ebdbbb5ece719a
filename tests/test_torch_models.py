"""The port's dense LM (repro_torch.configs / models) against the JAX
package on the same numpy inputs: every config field by field, the
parameter table path by path, the forward and the loss of the reduced
h2o-danube-1.8b (window 32, run at S = 48 so the window bites), qwen1.5-4b
(QKV bias, MHA) and minitron-4b, the tiled attention path, and the
building blocks.

Tolerances (normalized error ||got - want|| / ||want||):
  * float32 compute: 1e-5 (measured: about 2.4e-7 on the logits);
  * bfloat16 compute (the configs' own): logits 1e-2, loss 2e-4 relative
    (measured: 4.3e-3 to 4.4e-3 on the logits, at most 3.6e-5 on the
    loss) -- the two packages round bfloat16 matmul outputs in different
    orders.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.model import forward as jforward  # noqa: E402
from repro.models.model import loss_fn as jloss_fn  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.models.params import param_table as jparam_table  # noqa: E402
from repro.models.targets import diag_spectrum as jdiag_spectrum  # noqa
from repro_torch.configs import base  # noqa: E402
from repro_torch.convert import (batch_from_numpy,  # noqa: E402
                                 lm_params_from_numpy)
from repro_torch.models import attention, common  # noqa: E402
from repro_torch.models.model import (forward, loss_fn,  # noqa: E402
                                      make_batch)
from repro_torch.models.params import (flatten, init_params,  # noqa: E402
                                       param_table, unflatten)
from repro_torch.models.targets import (diag_spectrum,  # noqa: E402
                                        lm_curvature_targets)

DENSE = (("h2o-danube-1.8b", 48), ("qwen1.5-4b", 16), ("minitron-4b", 16))
B = 2


def _nerr(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _case(name, S, compute_dtype=None):
    """JAX's params and a numpy token batch, in both packages."""
    jcfg = jbase.get_config(name, reduced=True)
    cfg = base.get_config(name, reduced=True)
    if compute_dtype is not None:
        jcfg = dataclasses.replace(jcfg, compute_dtype=compute_dtype)
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.RandomState(1).randint(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return (jcfg, jp, {"tokens": jnp.asarray(tokens)},
            cfg, tp, batch_from_numpy({"tokens": tokens}, "cpu"))


# ---------------------------------------------------------------------------
# configs and the parameter table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", jbase.ARCH_NAMES + ["chessfad"])
def test_every_config_equals_the_reference(name):
    for reduced in (False, True):
        want = jbase.get_config(name, reduced=reduced)
        got = base.get_config(name, reduced=reduced)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert type(got).__name__ == type(want).__name__
        if hasattr(want, "num_params"):
            assert got.num_params() == want.num_params()
            assert got.active_params() == want.active_params()
            if want.num_heads:
                assert got.head_dim_ == want.head_dim_
    assert base.SHAPES == {k: base.InputShape(**dataclasses.asdict(v))
                           for k, v in jbase.SHAPES.items()}
    assert base.ARCH_NAMES == jbase.ARCH_NAMES


@pytest.mark.parametrize("name", jbase.ARCH_NAMES)
def test_param_table_equals_the_reference(name):
    for reduced in (False, True):
        want = jparam_table(jbase.get_config(name, reduced=reduced))
        got = param_table(base.get_config(name, reduced=reduced))
        assert list(got) == list(want)
        for path in want:
            assert dataclasses.asdict(got[path]) == \
                dataclasses.asdict(want[path]), path


def test_danube_full_width_count():
    cfg = base.get_config("h2o-danube-1.8b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size, cfg.sliding_window) == \
        (24, 2560, 32, 8, 6912, 32000, 4096)
    assert cfg.num_params() == 1_831_201_280 == jbase.get_config(
        "h2o-danube-1.8b").num_params()


def test_init_params_layout_and_sorted_order():
    cfg = base.get_config("qwen1.5-4b", reduced=True)
    p = init_params(cfg, 3, device="cpu")
    jp = jinit(jbase.get_config("qwen1.5-4b", reduced=True),
               jax.random.PRNGKey(0))
    jpaths = ["/".join(k.key for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert list(flatten(p)) == jpaths == sorted(param_table(cfg))
    leaves = torch.utils._pytree.tree_leaves(p)
    assert [tuple(l.shape) for l in leaves] == \
        [tuple(np.shape(l)) for l in jax.tree.leaves(jp)]
    assert all(l.dtype == torch.float32 for l in leaves)
    assert torch.count_nonzero(p["final_norm"]) == 0
    assert torch.count_nonzero(p["layers"]["attn"]["bq"]) == 0
    # the reference's fan-in scale: std min(0.02, 1/sqrt(fan_in))
    assert abs(p["embed"].std().item() - 0.02) < 2e-3
    # one seed draws one tree; an explicit generator is used as given
    again = init_params(cfg, 3, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(leaves, torch.utils._pytree.tree_leaves(again)))
    gen = torch.Generator().manual_seed(3)
    same = init_params(cfg, gen, device="cpu")
    assert torch.equal(same["embed"], p["embed"])
    # an unsorted flat dict unflattens in sorted order at every level
    flat = dict(reversed(list(flatten(p).items())))
    assert list(flatten(unflatten(flat))) == jpaths
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            init_params(cfg, 0)                  # the card by default


def test_lm_params_from_numpy_nested_and_flat():
    jp = jinit(jbase.get_config("minitron-4b", reduced=True),
               jax.random.PRNGKey(1))
    nested = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    from repro.models.params import flatten as jflatten
    flat_np = {k: np.asarray(v) for k, v in
               reversed(list(jflatten(jp).items()))}
    from_flat = lm_params_from_numpy(flat_np, "cpu")
    assert list(flatten(nested)) == list(flatten(from_flat)) == \
        sorted(flat_np)
    for (path, got), want in zip(flatten(from_flat).items(),
                                 jax.tree.leaves(jp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.float32, path
    batch = batch_from_numpy({"tokens": np.ones((2, 5), np.int32)}, "cpu")
    assert batch["tokens"].dtype == torch.int64


def test_make_batch_and_non_dense_refusal():
    cfg = base.get_config("h2o-danube-1.8b", reduced=True)
    b1 = make_batch(cfg, 2, 12, 5, device="cpu")["tokens"]
    b2 = make_batch(cfg, 2, 12, 5, device="cpu")["tokens"]
    assert b1.shape == (2, 12) and b1.dtype == torch.int64
    assert torch.equal(b1, b2) and 0 <= b1.min() and b1.max() < 256
    for name in ("granite-moe-1b-a400m", "mamba2-2.7b", "whisper-base",
                 "internvl2-1b", "zamba2-1.2b"):
        other = base.get_config(name, reduced=True)
        with pytest.raises(NotImplementedError, match="A.7"):
            forward(init_params(other, 0, device="cpu"), other,
                    {"tokens": b1})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_batch(cfg, 2, 12)               # the card by default


# ---------------------------------------------------------------------------
# forward and loss against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,S", DENSE)
def test_forward_and_loss_float32(name, S):
    jcfg, jp, jb, cfg, tp, tb = _case(name, S, "float32")
    want = np.asarray(jforward(jp, jcfg, jb)[0])
    got = forward(tp, cfg, tb)[0]
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _nerr(got, want) <= 1e-5
    jl = float(jloss_fn(jp, jcfg, jb)[0])
    tl = float(loss_fn(tp, cfg, tb)[0])
    assert abs(tl - jl) <= 1e-5 * abs(jl)


@pytest.mark.parametrize("name,S", DENSE)
def test_forward_and_loss_bfloat16(name, S):
    jcfg, jp, jb, cfg, tp, tb = _case(name, S)
    assert cfg.compute_dtype == "bfloat16"
    want = np.asarray(jforward(jp, jcfg, jb)[0].astype(jnp.float32))
    got = forward(tp, cfg, tb)[0]
    assert got.dtype == torch.bfloat16
    assert _nerr(got.float(), want) <= 1e-2
    jl = float(jloss_fn(jp, jcfg, jb)[0])
    tl = float(loss_fn(tp, cfg, tb)[0])
    assert abs(tl - jl) <= 2e-4 * abs(jl)


def test_loss_split_and_spectrum():
    """loss == head_loss(model_fn) exactly, the per-example mean is the
    loss, and diag_spectrum reports what the reference's does."""
    _, jp, _, cfg, tp, tb = _case("h2o-danube-1.8b", 48, "float32")
    tgt = lm_curvature_targets(cfg, tb)
    loss = tgt.loss(tp)
    assert torch.equal(loss, tgt.head_loss(tgt.model_fn(tp)))
    torch.testing.assert_close(tgt.per_example_fn(tp).mean(), loss)
    assert tgt.model_fn(tp).shape == (B, 47, cfg.vocab_size)
    assert set(tgt.plan_options()) == {"model_fn", "head_loss",
                                       "per_example_fn"}
    got = diag_spectrum(tp)
    want = jdiag_spectrum(jp)
    assert list(got) == list(want)
    for k in want:
        for stat in ("mean_abs", "rms", "max_abs"):
            assert got[k][stat] == pytest.approx(want[k][stat], rel=1e-6)
        assert got[k]["size"] == want[k]["size"]


# ---------------------------------------------------------------------------
# attention and the building blocks
# ---------------------------------------------------------------------------

def _qkv(seed, S, H=4, KV=2, D=8):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, S, H, D).astype(np.float32),
            rs.randn(B, S, KV, D).astype(np.float32),
            rs.randn(B, S, KV, D).astype(np.float32))


@pytest.mark.parametrize("window,softcap", [(None, None), (6, None),
                                            (5, 30.0)])
def test_tiled_attention_matches_untiled_and_reference(window, softcap):
    S = 24
    q, k, v = _qkv(3, S)
    want = np.asarray(jattn.attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), window=window,
                                      softcap=softcap))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    untiled = attention.attention(tq, tk, tv, window=window,
                                  softcap=softcap)
    assert _nerr(untiled, want) <= 1e-5
    for q_chunk, chunk in ((8, 6), (12, 24), (24, 4), (5, 7)):
        tiled = attention.attention(tq, tk, tv, window=window,
                                    softcap=softcap, q_chunk=q_chunk,
                                    chunk=chunk)
        assert _nerr(tiled, untiled) <= 1e-5
        jt = np.asarray(jattn.attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
            softcap=softcap, q_chunk=q_chunk, chunk=chunk))
        assert _nerr(tiled, jt) <= 1e-5


def test_tiled_attention_bfloat16_and_gqa_grouping():
    q, k, v = _qkv(4, 16, H=6, KV=2)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    out = attention.attention(tq, tk, tv, q_chunk=4, chunk=8)
    assert out.dtype == torch.bfloat16
    # query head h reads KV head h // G (G = 3)
    rep_k = torch.repeat_interleave(tk, 3, dim=2)
    rep_v = torch.repeat_interleave(tv, 3, dim=2)
    ref = attention.attention(tq, rep_k, rep_v)
    assert _nerr(out.float(), ref.float()) <= 1e-2
    want = np.asarray(jattn.attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), q_chunk=4, chunk=8)
        .astype(jnp.float32))
    assert _nerr(out.float(), want) <= 1e-2


def test_rope_mask_norms_and_activations():
    rs = np.random.RandomState(5)
    x = rs.randn(B, 7, 3, 8).astype(np.float32)
    pos = np.tile(np.arange(7), (B, 1)).astype(np.int32)
    np.testing.assert_allclose(
        attention.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             500.0).numpy(),
        np.asarray(jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                    500.0)), rtol=1e-5, atol=1e-6)
    assert attention.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                0.0) is not None
    qp, kp = np.arange(9)[:, None], np.arange(9)[None, :]
    for causal, window in ((True, None), (True, 3), (False, 4)):
        np.testing.assert_array_equal(
            attention.sliding_window_mask(torch.from_numpy(qp),
                                          torch.from_numpy(kp), causal,
                                          window).numpy(),
            np.asarray(jattn.sliding_window_mask(jnp.asarray(qp),
                                                 jnp.asarray(kp), causal,
                                                 window)))
    h = rs.randn(4, 16).astype(np.float32)
    s, b = rs.randn(16).astype(np.float32), rs.randn(16).astype(np.float32)
    th, ts, tb = (torch.from_numpy(a) for a in (h, s, b))
    pairs = [(common.rms_norm(th, ts), jcommon.rms_norm(h, s)),
             (common.layer_norm(th, ts, tb), jcommon.layer_norm(h, s, b)),
             (common.silu(th), jcommon.silu(jnp.asarray(h))),
             (common.gelu(th), jcommon.gelu(jnp.asarray(h))),
             (common.softplus(th), jcommon.softplus(jnp.asarray(h)))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    # bfloat16 in, bfloat16 out; the norm itself runs in float32
    assert common.rms_norm(th.bfloat16(), ts).dtype == torch.bfloat16
    cfg = base.get_config("h2o-danube-1.8b", reduced=True)
    cast = common.cast_to_compute({"w": th, "i": torch.arange(3)}, cfg)
    assert cast["w"].dtype == torch.bfloat16
    assert cast["i"].dtype == torch.int64
    assert common.DTYPES["bfloat16"] is torch.bfloat16
