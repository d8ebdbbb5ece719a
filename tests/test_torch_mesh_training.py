"""The port's train steps on a mesh against the JAX reference's
single-device step (tests/test_distributed.py's GSPMD and shard_map train
steps are the templates; the reference's own 2-D GSPMD test fails under
jax 0.9.0, ROADMAP C, so the reference figures here come from its
single-device ``make_train_step(cfg, None, ...)`` on the global batch,
computed in this process before the spawn).

One spawn of 8 gloo ranks (tests/torch_dist_ranks.py) runs the reduced
minitron-4b at float32 compute from the reference's own initial params,
two steps at B = 4 x S = 24, on a ("data", "model") = (2, 4) mesh (whole
batches) and a ("pod", "data", "model") = (2, 2, 2) mesh (batches sharded
by ``batch_spec``):

  * ``make_train_step(cfg, mesh, adamw)`` on both meshes: losses, grad
    norms, params and first moments within 1e-5 of the reference;
  * ``make_train_step(cfg, mesh, sophia_h)`` on (2, 4) at hess_batch_frac
    0.5 (the estimate's rows sit on the first data ranks only): the loss,
    grad norm and first moment within 1e-5 of the reference; the params,
    which also read the Hutchinson estimate, within 1e-5 of the port's own
    single-device step, which draws the same probes (the reference draws
    its probes from JAX's PRNG, so no port equals its estimate);
  * ``make_shard_map_train_step``: compress "none" within 1e-5 of the
    reference on both meshes; "bf16" (pod sums in bfloat16) with the loss
    within 2**-8 relative and the params' change within 2**-6 of the
    reference's change (the gradients carry at most three bfloat16
    roundings, 3 * 2**-9 relative, and Adam's normalized update moves by
    at most twice that); "int8" finite;
  * every rank ends with the same params;
  * ``python -m repro_torch.launch.train --data-mesh 2`` (its ``main``,
    inside the spawned world): 4 steps with a checkpoint every 2, then a
    second run resumed from the step-2 checkpoint (LATEST rewound) writes
    a step-4 checkpoint bitwise equal to the first run's.

The same spawn runs ``models.moe_sharded`` (the reference's
``moe_block_sharded`` facts, taken on its 8-device CPU mesh, hold here):

  * on a ("data", "model") = (4, 2) mesh, the reduced granite-moe-1b-a400m
    at capacity factor 4.0 (nothing drops), 64 tokens, each data rank its
    16: outputs and the gradients of <y, r> (tokens; the whole weights,
    summed over the data ranks) within 1e-5 of the reference's
    ``moe_block`` on all 64; the aux loss within 1e-6 of the mean over
    data shards of each shard's Switch loss (``moe_sharded.py``'s
    ``pmean``); 5 experts on 2 model ranks fall back to ``moe_block`` on
    the rank's rows;
  * on the (2, 4) mesh, two ``make_train_step`` steps of the reduced
    granite-moe-1b-a400m with ``moe_impl="shard_map_local"`` (one expert
    a rank): losses and params within 1e-5 of the reference's
    single-device step with ``accum_steps=2``.  Each data rank routes its
    own rows (per-shard capacity and aux), which is what the reference's
    step does with its rows split into those two microbatches;
  * on the same mesh, two ``make_train_step`` steps with
    ``moe_impl="gspmd_sort"`` at capacity factor 0.5 (the global batch's
    forward drops tokens: 24 slots an expert against the 32 two shards'
    capacities would give): each rank routes the rows of both data ranks,
    as the reference's GSPMD step routes the global batch, so the losses,
    grad norms and params are within 1e-5 of the reference's
    single-device step on the whole batch (``accum_steps=1``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import training as jtraining  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import SyntheticTokens as JSyntheticTokens  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.params import flatten as jflatten  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import sophia_h as jsophia  # noqa: E402
from repro.optim.schedule import warmup_cosine as jwarmup  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.optim import sophia_h, warmup_cosine  # noqa: E402
from repro_torch.training import TrainState, make_train_step  # noqa: E402
from torch_dist_ranks import spawn  # noqa: E402

ARCH = "minitron-4b"
MOE_ARCH = "granite-moe-1b-a400m"
B, S = 4, 24
LR = (1e-2, 1, 4)
SOPHIA = {"hess_every": 1, "n_probes": 2, "csize": 1,
          "hess_batch_frac": 0.5}
BOUND = 1e-5
BF16_LOSS = 2.0 ** -8
BF16_CHANGE = 2.0 ** -6
GLOBAL_CAPACITY = 0.5


def _cfgs():
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              compute_dtype="float32")
    jcfg = dataclasses.replace(jget_config(ARCH, reduced=True),
                               compute_dtype="float32")
    return cfg, jcfg


def _reference(jcfg, jparams, jopt, accum_steps=1):
    """Two reference steps on the global batch: (metrics per step, params,
    first moments) as numpy."""
    state = jtraining.TrainState(jparams, jopt.init(jparams),
                                 jnp.zeros((), jnp.int32),
                                 jax.random.PRNGKey(1))
    step = jtraining.make_train_step(jcfg, None, jopt,
                                     accum_steps=accum_steps)
    ds = JSyntheticTokens(jcfg.vocab_size, B, S, 0)
    metrics = []
    for k in range(2):
        state, m = step(state, {"tokens": ds.batch_at(k)})
        metrics.append({key: float(m[key])
                        for key in ("loss", "grad_norm", "lr")})
    host = jax.tree.map(np.asarray, (state.params, state.opt_state["m"]))
    return metrics, jflatten(host[0]), jflatten(host[1])


def _port_sophia(cfg, host):
    """The params after the port's single-device SophiaH steps, as
    numpy."""
    params = convert.lm_params_from_numpy(host, device="cpu")
    opt = sophia_h(warmup_cosine(*LR), **SOPHIA)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int64), 1)
    step = make_train_step(cfg, None, opt)
    ds = SyntheticTokens(cfg.vocab_size, B, S, 0, device="cpu")
    for k in range(2):
        state, _ = step(state, {"tokens": ds.batch_at(k)})
    return {k: v.numpy() for k, v in flatten(state.params).items()}


def _nerr(got: dict, want: dict) -> float:
    g = np.concatenate([np.asarray(got[k], np.float64).ravel()
                        for k in sorted(want)])
    w = np.concatenate([np.asarray(want[k], np.float64).ravel()
                        for k in sorted(want)])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _tree(arrays, key):
    """{path: array} of one run from a rank's arrays."""
    pre = f"{key}/"
    return {k[len(pre):]: v for k, v in arrays.items()
            if k.startswith(pre) and not k.startswith(pre + "m/")}


def _moments(arrays, key):
    pre = f"{key}/m/"
    return {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}


def _rel(a, b):
    """|a - b| / |b|, and 0 where both are 0 (the warmup's lr at step 0)."""
    return abs(a - b) / abs(b) if b else abs(a)


def _moe_inputs(seed, jcfg):
    """64 tokens, a cotangent and the expert weights of one MoE layer."""
    rs = np.random.RandomState(seed)
    d, E, ff = jcfg.d_model, jcfg.num_experts, jcfg.moe_d_ff
    p = {"router": rs.randn(d, E) / np.sqrt(d),
         "w_down": rs.randn(E, ff, d) / np.sqrt(ff),
         "w_gate": rs.randn(E, d, ff) / np.sqrt(d),
         "w_up": rs.randn(E, d, ff) / np.sqrt(d)}
    return ({k: v.astype(np.float32) for k, v in p.items()},
            rs.randn(64, d).astype(np.float32),
            rs.randn(64, d).astype(np.float32))


def _moe_reference(jcfg, p, x, r):
    """The reference's moe_block on all 64 tokens: y, the gradients of
    <y, r> (tokens, weights), and its sharded aux on 4 data shards."""
    def obj(xx, pp):
        y, _ = jmoe.moe_block(xx, pp, jcfg)
        return jnp.sum(y * r), y

    (_, y), (gx, gp) = jax.value_and_grad(obj, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    aux = np.mean([float(jmoe.router_topk(
        jnp.asarray(x[16 * d:16 * (d + 1)]), jnp.asarray(p["router"]),
        jcfg.experts_per_token)[2]) for d in range(4)])
    return (np.asarray(y), np.asarray(gx),
            {k: np.asarray(v) for k, v in gp.items()}, aux)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The reference's figures, and the ONE 8-rank spawn that both tests
    read."""
    tmp_path = tmp_path_factory.mktemp("mesh_training")
    cfg, jcfg = _cfgs()
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    host = jflatten(jax.tree.map(np.asarray, jparams))
    want = {"adamw": _reference(jcfg, jparams, jadamw(jwarmup(*LR))),
            "sophia": _reference(jcfg, jparams,
                                 jsophia(jwarmup(*LR), **SOPHIA)),
            "port_sophia": _port_sophia(cfg, host), "host": host}

    ins = {f"p/{k}": v for k, v in host.items()}
    ins.update(shape=np.array([B, S]), lr=np.array(LR, np.float64),
               sophia=np.array([SOPHIA[k] for k in (
                   "hess_every", "n_probes", "csize", "hess_batch_frac")],
                   np.float64))
    ins["ckpt_dir"] = np.array(str(tmp_path / "ckpt"))
    for tag, name, seed in (("moe", MOE_ARCH, 3),
                            ("moe5", "granite-moe-3b-a800m", 4)):
        mcfg = dataclasses.replace(jget_config(name, reduced=True),
                                   capacity_factor=4.0)
        p, x, r = _moe_inputs(seed, mcfg)
        want[tag] = (_moe_reference(mcfg, p, x, r) if tag == "moe" else
                     np.concatenate([np.asarray(jmoe.moe_block(
                         jnp.asarray(x[16 * d:16 * (d + 1)]),
                         {k: jnp.asarray(v) for k, v in p.items()},
                         mcfg)[0]) for d in range(4)]))
        ins.update({f"{tag}/x": x, f"{tag}/r": r},
                   **{f"{tag}/p/{k}": v for k, v in p.items()})
    gcfg = dataclasses.replace(jget_config(MOE_ARCH, reduced=True),
                               compute_dtype="float32")
    gparams = jinit_params(gcfg, jax.random.PRNGKey(5))
    ins.update({f"g/{k}": v for k, v in
                jflatten(jax.tree.map(np.asarray, gparams)).items()})
    want["moe_global_step"] = _reference(
        dataclasses.replace(gcfg, capacity_factor=GLOBAL_CAPACITY),
        jax.tree.map(jnp.array, gparams), jadamw(jwarmup(*LR)))
    want["moe_step"] = _reference(gcfg, gparams, jadamw(jwarmup(*LR)),
                                  accum_steps=2)
    return want, spawn("mesh_training", 8, tmp_path, ins, timeout=240)


def test_mesh_steps_equal_the_reference_on_eight_gloo_ranks(spawned):
    want, ranks = spawned
    want_adamw, want_sophia = want["adamw"], want["sophia"]
    port_sophia, host = want["port_sophia"], want["host"]

    runs = ["mesh_adamw_24", "mesh_sophia_24", "smap_none_24",
            "mesh_adamw_222", "smap_none_222", "smap_bf16_222",
            "smap_int8_222"]
    for rank, (got, info) in enumerate(ranks):
        assert info["mesh_adamw_24_dtensor"] and \
            info["mesh_adamw_222_dtensor"], rank
        for key in ("mesh_adamw_24", "smap_none_24", "mesh_adamw_222",
                    "smap_none_222"):
            metrics, params, m = want_adamw
            for k, w in enumerate(metrics):
                for name in ("loss",) + (("grad_norm", "lr")
                                         if key.startswith("mesh") else ()):
                    assert _rel(info[key][k][name], w[name]) <= BOUND, \
                        (rank, key, k, name)
            assert _nerr(_tree(got, key), params) <= BOUND, (rank, key)
            assert _nerr(_moments(got, key), m) <= BOUND, (rank, key)

        metrics, _, m = want_sophia
        key = "mesh_sophia_24"
        for k, w in enumerate(metrics):
            for name in ("loss", "grad_norm", "lr"):
                assert _rel(info[key][k][name], w[name]) <= BOUND, \
                    (rank, key, k, name)
        assert _nerr(_moments(got, key), m) <= BOUND, rank
        assert _nerr(_tree(got, key), port_sophia) <= BOUND, rank

        metrics, params, _ = want_adamw
        key = "smap_bf16_222"
        for k, w in enumerate(metrics):
            assert _rel(info[key][k]["loss"], w["loss"]) <= BF16_LOSS
        change = {k: params[k] - host[k] for k in params}
        got_change = {k: v - host[k] for k, v in _tree(got, key).items()}
        assert _nerr(got_change, change) <= BF16_CHANGE, rank
        assert all(np.isfinite(m_["loss"]) for m_ in info["smap_int8_222"])
        assert all(np.isfinite(v).all()
                   for v in _tree(got, "smap_int8_222").values())
        cli = info["cli"]
        assert cli["final"] == [4, 4] and cli["resumed_steps"] == [2, 3]
    # the entry point resumed at step 2 ends with the uninterrupted run's
    # step-4 checkpoint, bitwise (params, both moments, step, seed)
    assert ranks[0][1]["cli"]["equal"] is True
    assert ranks[0][1]["cli"]["leaves"] > 10
    # every rank holds the same params after every run
    for key in runs:
        first = _tree(ranks[0][0], key)
        for got, _ in ranks[1:]:
            for path, v in _tree(got, key).items():
                np.testing.assert_array_equal(v, first[path],
                                              err_msg=f"{key} {path}")


def test_moe_block_sharded_on_eight_gloo_ranks(spawned):
    want, ranks = spawned
    y, gx, gp, aux = want["moe"]
    sums = {}
    for rank, (got, info) in enumerate(ranks):
        d, m = info["moe_coords"]
        rows = slice(16 * d, 16 * (d + 1))
        assert _nerr({"y": got["moe/y"]}, {"y": y[rows]}) <= BOUND, rank
        assert _nerr({"gx": got["moe/gx"]}, {"gx": gx[rows]}) <= BOUND, rank
        assert abs(info["moe/aux"] - aux) <= 1e-6 * aux, rank
        # every model rank ends with the whole gradient of its rows' loss
        for k in gp:
            sums.setdefault((m, k), []).append(got[f"moe/g/{k}"])
        np.testing.assert_allclose(got["moe5/y"], want["moe5"][rows],
                                   rtol=1e-5, atol=1e-6, err_msg=str(rank))
    for (m, k), parts in sums.items():
        assert len(parts) == 4
        assert _nerr({k: np.sum(parts, 0)}, {k: gp[k]}) <= BOUND, (m, k)

    metrics, params, _ = want["moe_step"]
    for rank, (got, info) in enumerate(ranks):
        for k, w in enumerate(metrics):
            for name in ("loss", "grad_norm"):
                assert _rel(info["moe_mesh_step"][k][name], w[name]) <= \
                    BOUND, (rank, k, name)
        assert _nerr(_tree(got, "moe_mesh_step"), params) <= BOUND, rank


def test_gspmd_sort_routes_the_global_batch_on_eight_gloo_ranks(spawned):
    want, ranks = spawned
    metrics, params, _ = want["moe_global_step"]
    for rank, (got, info) in enumerate(ranks):
        assert sum(d for d, _ in info["moe_global_drops"]) > 0, rank
        for k, w in enumerate(metrics):
            for name in ("loss", "grad_norm"):
                assert _rel(info["moe_global_step"][k][name], w[name]) <= \
                    BOUND, (rank, k, name)
        assert _nerr(_tree(got, "moe_global_step"), params) <= BOUND, rank


def test_entry_point_refuses_a_mesh_the_world_cannot_hold():
    """Outside a launched world, ``--data-mesh 2`` raises: nothing drops
    to the mesh-less step when a mesh was asked for."""
    from repro_torch.launch import train as train_cli
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", ARCH, "--reduced", "--steps", "1",
                        "--device", "cpu", "--data-mesh", "2"])
