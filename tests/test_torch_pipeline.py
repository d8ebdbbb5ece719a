"""repro_torch.training.pipeline, the elastic restore and the sharded
synthetic batches against the JAX reference (tests/test_pipeline.py,
tests/test_checkpoint.py and tests/test_data.py are the templates).

One spawn of 8 gloo ranks (tests/torch_dist_ranks.py):

  * GPipe on a ("pipe", "data") = (4, 2) mesh, the reference test's case
    (8 tanh layers of width 32 in 4 stages, B = 16 in 4 microbatches):
    every rank's output within 1e-5, and its gradients of out.sum() with
    respect to the staged params and x within 1e-4, of a sequential JAX
    ``lax.scan`` of the same body (the staged gradients through the
    reference's ``stack_stages``);
  * the elastic restart: a tree of DTensors saved from a (2, 4) mesh with
    ("data", "model") placements and restored onto a (4, 2) mesh with
    ("model", "data") placements equals the saved arrays exactly, each
    rank holding the block its placements name;
  * sharded data: on a ("pod", "data", "model") = (2, 2, 2) mesh each
    rank's ``batch_at(step, sharding)`` makes only its own rows, equal to
    the reference's ``_tokens_np`` rows exactly (block pod * 2 + data of
    the batch: the reference's tuple axes are major to minor).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import SyntheticTokens as JSyntheticTokens  # noqa: E402
from repro.training.pipeline import stack_stages as jstack  # noqa: E402
from torch_dist_ranks import spawn  # noqa: E402

L, B, D = 8, 16, 32
VOCAB = 1000


def _sequential(params, x):
    def body(lp, h):
        return jnp.tanh(h @ lp["w"] + lp["b"])

    def sb(h, lp):
        return body(lp, h), None

    out, _ = jax.lax.scan(sb, x, params)
    return out


def test_pipeline_restore_and_rows_on_eight_gloo_ranks(tmp_path):
    rng = np.random.RandomState(0)
    w = (rng.randn(L, D, D) * 0.1).astype(np.float32)
    b = (rng.randn(L, D) * 0.1).astype(np.float32)
    x = rng.randn(B, D).astype(np.float32)
    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    want = np.asarray(_sequential(params, jnp.asarray(x)))
    g = jax.grad(lambda p, x: _sequential(p, x).sum(), argnums=(0, 1))(
        params, jnp.asarray(x))
    g_staged = jstack(g[0], 4)
    tw = rng.randn(16, 8).astype(np.float32)
    tm = rng.randn(16, 8).astype(np.float32)
    ckpt = tmp_path / "ckpt"
    ins = {"w": w, "b": b, "x": x, "tw": tw, "tm": tm,
           "ckpt_dir": np.array(str(ckpt)), "vocab": np.array(VOCAB)}
    ranks = spawn("pipeline", 8, tmp_path, ins, timeout=180)

    jds = JSyntheticTokens(VOCAB, 8, 16, 3)
    for rank, (got, info) in enumerate(ranks):
        # GPipe
        assert np.abs(got["out"] - want).max() < 1e-5, rank
        for key, ref in (("gw", g_staged["w"]), ("gb", g_staged["b"]),
                         ("gx", g[1])):
            assert np.abs(got[key] - np.asarray(ref)).max() < 1e-4, \
                (rank, key)
        # elastic restore
        for k, ref in (("w", tw), ("m", tm)):
            np.testing.assert_array_equal(got[f"restored_{k}"], ref)
            rs, cs = (slice(*s) for s in info["restored_slices"])
            np.testing.assert_array_equal(got[f"restored_local_{k}"],
                                          ref[rs, cs])
            assert info["restored_mesh"][k] == [4, 2]
        # sharded rows: block pod * 2 + data, two rows each
        p, d, _m = info["coords"]
        rows = np.arange(8)[(p * 2 + d) * 2:(p * 2 + d + 1) * 2]
        assert info["rows_made"] == rows.tolist(), rank
        np.testing.assert_array_equal(got["rows"], jds._tokens_np(5, rows))
        np.testing.assert_array_equal(got["rows_full"],
                                      np.asarray(jds.batch_at(5)))
    # (4, 2) with ("model", "data") placements: 8 distinct blocks
    slices = {tuple(map(tuple, info["restored_slices"]))
              for _, info in ranks}
    assert len(slices) == 8
