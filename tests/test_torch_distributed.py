"""repro_torch.core.distributed and the sharded engine backends against the
JAX reference (tests/test_sharded_rows.py and tests/test_distributed.py are
the templates).

The layout helpers are numpy and must equal the reference's exactly.  The
schedules run in ONE spawn of 8 gloo rank processes on a ("data", "model")
= (2, 4) mesh (tests/torch_dist_ranks.py); every rank returns the global
result, held to the reference's bound of 1e-6 * (1 + max|want|) against
the reference's single-device answers on the same numpy inputs, which this
process computes before the spawn."""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core import ref as jref  # noqa: E402
from repro.core import testfns as jtestfns  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core import testfns  # noqa: E402
from torch_dist_ranks import FUNCTIONS, spawn  # noqa: E402

WORLD = 8
MODEL = 4           # the model axis of the (2, 4) mesh
BOUND = 1e-6


def _nerr(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / (1.0 + np.abs(want).max()))


# ---------------------------------------------------------------------------
# the numpy layout helpers: exact equality with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("csize", [1, 2, 4, 8])
def test_layout_helpers_equal_reference(csize):
    """cyclic_layout, snake_shard_of_block, rows_per_shard and
    block_cells_bound equal the reference's over n 1-50 and sizes
    {1, 2, 3, 4, 8}."""
    for size in (1, 2, 3, 4, 8):
        for n in range(1, 51):
            assert distributed.rows_per_shard(n, size) == \
                jdist.rows_per_shard(n, size)
            nchunk = -(-n // csize)
            np.testing.assert_array_equal(
                distributed.snake_shard_of_block(nchunk, size),
                jdist.snake_shard_of_block(nchunk, size))
            got = distributed.cyclic_layout(n, csize, size)
            want = jdist.cyclic_layout(n, csize, size)
            for field in ("n", "csize", "size", "blocks", "kept",
                          "executed", "slots", "block_cells_bound"):
                assert getattr(got, field) == getattr(want, field), field
            for field in ("cells", "valid", "row_of_slot", "slot_of_row"):
                g, w = getattr(got, field), getattr(want, field)
                assert g.dtype == w.dtype, field
                np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.mark.parametrize("n,csize,rows_per,row0",
                         [(13, 4, 4, 0), (13, 4, 4, 12), (16, 4, 4, 8),
                          (7, 3, 2, 6)])
def test_cell_grid_equals_reference(n, csize, rows_per, row0):
    got = distributed._cell_grid(n, csize, rows_per, row0)
    want = jdist._cell_grid(n, csize, rows_per, row0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_count_reports_like_reference():
    seen, jseen = [], []
    for counter, count in ((seen.append, distributed._count),
                           (jseen.append, jdist._count)):
        count(counter, "cyclic", [5, 5], (4, 5))
        count(None, "block", [1], [1])
    assert seen == jseen


def test_make_test_mesh_refuses_a_bad_shape_before_any_group():
    """Checks that need no process group: a shape and axes of different
    lengths, and a mesh of more than one device with no group launched
    (this process starts none)."""
    from repro_torch.launch.mesh import make_test_mesh
    with pytest.raises(ValueError, match="length"):
        make_test_mesh((1, 1), ("data",), device="cpu")
    if not torch.distributed.is_initialized():
        with pytest.raises(ValueError, match="process group"):
            make_test_mesh((2, 4), ("data", "model"), device="cpu")


def test_plan_refuses_a_mesh_of_another_device_type():
    card_mesh = SimpleNamespace(device_type="cuda", mesh_dim_names=("model",))
    with pytest.raises(ValueError, match="mesh"):
        engine.plan(testfns.rosenbrock, 8, csize=4, mesh=card_mesh,
                    device="cpu")


def test_group_cache_follows_a_new_world():
    """A group over two data axes is cached per world: after the world is
    destroyed and started anew, an equal mesh gets a live group of the new
    world, not the dead one."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    assert not dist.is_initialized()
    groups, sums = [], []
    try:
        for _ in range(2):
            mesh = make_test_mesh((1, 1), ("pod", "data"), device="cpu")
            g = distributed._group(mesh, ("pod", "data"))
            x = torch.ones(3)
            dist.all_reduce(x, group=g)
            groups.append(g)
            sums.append(x.tolist())
            dist.destroy_process_group()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert groups[0] is not groups[1]
    assert sums == [[1.0] * 3] * 2


# ---------------------------------------------------------------------------
# the schedules on 8 gloo ranks
# ---------------------------------------------------------------------------

def _inputs():
    rng = np.random.RandomState(0)
    ins = {"A": rng.uniform(-2, 2, (16, 8)).astype(np.float32),
           "V": rng.randn(16, 8).astype(np.float32)}
    for n in (13, 16):
        r = np.random.RandomState(n)
        ins[f"a{n}"] = r.uniform(-2, 2, (n,)).astype(np.float32)
        ins[f"v{n}"] = r.randn(n).astype(np.float32)
    return ins


def _reference(ins):
    """The reference's single-device answers on the same inputs."""
    want = {}
    for fname in FUNCTIONS:
        for n in (13, 16):
            f = jtestfns.FUNCTIONS[fname](n)
            a, v = jnp.asarray(ins[f"a{n}"]), jnp.asarray(ins[f"v{n}"])
            want[f"hvp_{fname}_{n}"] = np.asarray(jref.hvp_fwdfwd(f, a, v))
            want[f"hess_{fname}_{n}"] = np.asarray(jref.hessian_fwdfwd(f, a))
    A, V = jnp.asarray(ins["A"]), jnp.asarray(ins["V"])
    for sym in (False, True):
        for level in ("L1", "L2"):
            want[f"batched_{int(sym)}_{level}"] = np.asarray(
                japi.batched_hvp_impl(jtestfns.rosenbrock, A, V, csize=2,
                                      level=level, symmetric=sym))
    a8, v8 = jnp.asarray(ins["a13"][:8]), jnp.asarray(ins["v13"][:8])
    want["hvp_rosenbrock_8"] = np.asarray(
        jref.hvp_fwdfwd(jtestfns.rosenbrock, a8, v8))
    return want


def _counters_want():
    """The reference's cell accounting for the counter dicts."""
    want = {}
    for n in (13, 16):
        lay = jdist.cyclic_layout(n, 4, MODEL)
        cyc = {"layout": "cyclic",
               "executed_per_shard": [lay.executed] * MODEL,
               "kept_per_shard": list(lay.kept)}
        cells = jdist.rows_per_shard(n, MODEL) * (-(-n // 4))
        blk = {"layout": "block", "executed_per_shard": [cells] * MODEL,
               "kept_per_shard": [cells] * MODEL}
        want[f"{n}_cyclic"] = [cyc, cyc]
        want[f"{n}_block"] = [blk, blk]
    return want


def test_schedules_on_eight_gloo_ranks(tmp_path):
    ins = _inputs()
    want = _reference(ins)
    ranks = spawn("distributed", WORLD, tmp_path, ins, timeout=180)
    counters = _counters_want()
    for rank, (got, info) in enumerate(ranks):
        errs = {}
        for fname in FUNCTIONS:
            for n in (13, 16):
                for sym in (0, 1):
                    for lay in ("cyclic", "block"):
                        key = f"{fname}_{n}_{sym}_{lay}"
                        assert info["backends"][key] == [
                            "sharded_rows", "sharded_rows", "sharded"], key
                        errs[f"hvp_{key}"] = _nerr(
                            got[f"hvp_{key}"], want[f"hvp_{fname}_{n}"])
                        errs[f"hess_{key}"] = _nerr(
                            got[f"hess_{key}"], want[f"hess_{fname}_{n}"])
        for key in ("batched_0_L1", "batched_0_L2", "batched_1_L1",
                    "batched_1_L2"):
            errs[key] = _nerr(got[key], want[key])
        for key in ("batched_plan", "batched_data8", "batched_pod_data"):
            errs[key] = _nerr(got[key], want["batched_0_L2"])
        errs["hvp_rows_named"] = _nerr(got["hvp_rows_named"],
                                       want["hvp_rosenbrock_13"])
        errs["hvp_autotune"] = _nerr(got["hvp_autotune"],
                                     want["hvp_rosenbrock_13"])
        errs["batched_autotune"] = _nerr(got["batched_autotune"],
                                         want["batched_0_L2"])
        errs["hvp_pod_data"] = _nerr(got["hvp_pod_data"],
                                     want["hvp_rosenbrock_8"])
        worst = max(errs, key=errs.get)
        assert errs[worst] <= BOUND, (rank, worst, errs[worst])

        assert info["counters"] == counters, rank
        b = info["backends"]
        assert not set(b["flat"]) & {"sharded", "sharded_rows"}, b["flat"]
        assert b["data_only"][0] not in ("sharded", "sharded_rows")
        assert b["data_only"][1] == "sharded"
        assert b["rows_default"][0] not in ("sharded", "sharded_rows")
        assert b["rows_named"] == ["sharded_rows"]
        assert b["pod_data"] == ["sharded", "sharded_rows"]
        assert info["indivisible_m"] is True
        assert info["mesh_refusals"] == [True] * 4
        assert info["mesh_signature"] == [True] * 3
        assert info["unknown_layout"] == [True, True]
    # csize="autotune" on the mesh: every rank planned the same csizes
    tuned = {tuple(info["autotune_csize"]) for _, info in ranks}
    assert len(tuned) == 1, tuned
    # every rank returns the same global result
    for key in ranks[0][0]:
        for got, _ in ranks[1:]:
            np.testing.assert_array_equal(got[key], ranks[0][0][key])
