"""repro_torch's data, checkpoint and training modules and launch/train.py
against the JAX reference (tests/test_data.py, test_checkpoint.py,
test_training_loop.py and test_system.py are the templates):

  * SyntheticTokens and global_batch_at equal the reference's exactly;
  * checkpoints: atomic publish, torn-state recovery, retention GC, async
    saves, shape refusal, restore onto the target's device and dtype, and a
    bfloat16 round trip with jax blocked;
  * two AdamW train steps on the reduced h2o-danube config (float32
    compute) equal the reference's within 1e-5 (normalized), and
    accum_steps equals the full batch;
  * the fault-tolerant loop: retry after a failure, resume, NaN loss,
    bounded retries, stragglers;
  * ``python -m repro_torch.launch.train``'s main on the CPU;
  * ``engine.opmodel.count_jaxpr_ops`` equals the reference's counts.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import training as jtraining  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import SyntheticTokens as JSyntheticTokens  # noqa: E402
from repro.data import global_batch_at as jglobal_batch_at  # noqa: E402
from repro.engine.opmodel import count_jaxpr_ops as jcount  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim.schedule import warmup_cosine as jwarmup  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.data import SyntheticTokens, global_batch_at  # noqa: E402
from repro_torch.engine.opmodel import count_jaxpr_ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.model import make_batch  # noqa: E402
from repro_torch.models.params import flatten, init_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.schedule import constant, warmup_cosine  # noqa: E402
from repro_torch.training import (TrainLoop, TrainLoopConfig,  # noqa: E402
                                  TrainState, make_train_step)

ROOT = Path(__file__).resolve().parents[1]
tree_leaves = torch.utils._pytree.tree_leaves
tree_map = torch.utils._pytree.tree_map


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5), (7, 117)])
def test_synthetic_tokens_equal_reference(seed, step):
    got = SyntheticTokens(1000, 4, 64, seed, device="cpu").batch_at(step)
    want = JSyntheticTokens(1000, 4, 64, seed).batch_at(step)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_steps_differ_rows_differ_and_range():
    ds = SyntheticTokens(vocab_size=257, batch=4, seq=512, seed=1,
                         device="cpu")
    b0, b1 = ds.batch_at(0).numpy(), ds.batch_at(1).numpy()
    assert (b0 != b1).any() and (b0[0] != b0[1]).any()
    assert b0.min() >= 0 and b0.max() < 257


@pytest.mark.parametrize("arch,key", [("internvl2-1b", "patches"),
                                      ("whisper-base", "frames"),
                                      ("h2o-danube-1.8b", None)])
def test_global_batch_equals_reference(arch, key):
    small = dataclasses.replace(SHAPES["train_4k"], seq_len=32,
                                global_batch=2)
    jsmall = dataclasses.replace(JSHAPES["train_4k"], seq_len=32,
                                 global_batch=2)
    got = global_batch_at(get_config(arch, reduced=True), small, step=3,
                          seed=2, device="cpu")
    want = jglobal_batch_at(jget_config(arch, reduced=True), jsmall, step=3,
                            seed=2)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    if key is not None:
        assert got[key].dtype == torch.float32


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def make_tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"params": {"w": torch.tensor(rng.randn(8, 4), dtype=torch.float32),
                       "b": torch.tensor(rng.randn(4), dtype=torch.float32)},
            "opt": {"m": {"w": torch.zeros(8, 4), "b": torch.ones(4)}},
            "step": torch.tensor(7, dtype=torch.int64)}


def assert_tree_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


def test_roundtrip(tmp_path):
    tree = make_tree()
    save_checkpoint(str(tmp_path), 7, tree)
    assert latest_step(str(tmp_path)) == 7
    out = restore_checkpoint(str(tmp_path), 7, make_tree(1))
    assert_tree_equal(tree, out)


def test_restore_onto_target_dtype_and_train_state(tmp_path):
    state = TrainState({"w": torch.arange(6.0).reshape(2, 3)},
                       {"m": {"w": torch.ones(2, 3)}},
                       torch.tensor(4, dtype=torch.int64), 11)
    save_checkpoint(str(tmp_path), 4, {"state": state})
    meta = json.loads((tmp_path / "step_4" / "meta.json").read_text())
    assert "['state'].params['w']" in meta["leaves"]
    target = TrainState({"w": torch.zeros(2, 3, dtype=torch.float64)},
                        {"m": {"w": torch.zeros(2, 3)}},
                        torch.tensor(0, dtype=torch.int64), 0)
    out = restore_checkpoint(str(tmp_path), 4, {"state": target})["state"]
    assert isinstance(out, TrainState) and out.rng == 11
    assert out.params["w"].dtype == torch.float64
    assert torch.equal(out.params["w"], state.params["w"].double())
    assert int(out.step) == 4


def test_atomicity_torn_tmp_ignored(tmp_path):
    save_checkpoint(str(tmp_path), 1, make_tree())
    # simulate a crash mid-save at step 2: leave only a .tmp dir
    os.makedirs(tmp_path / "step_2.tmp")
    (tmp_path / "step_2.tmp" / "meta.json").write_text("{}")
    assert latest_step(str(tmp_path)) == 1


def test_latest_pointer_torn_state(tmp_path):
    save_checkpoint(str(tmp_path), 3, make_tree())
    # LATEST points to a checkpoint dir that vanished -> treated as absent
    shutil.rmtree(tmp_path / "step_3")
    assert latest_step(str(tmp_path)) is None


def test_manager_gc_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        tree = make_tree(s)
        mgr.save_async(s, tree)
        # the next step writes the tensors in place right after the call
        tree["params"]["w"].add_(100.0)
    mgr.join()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [3, 4]
    assert mgr.latest() == 4
    assert_tree_equal(make_tree(4), mgr.restore(4, make_tree(0)))


def test_shape_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), 1, {"w": torch.zeros(5)})


def _blocked_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_bfloat16_roundtrip_with_jax_blocked(tmp_path):
    """No ml_dtypes through jax: the bfloat16 leaf goes through hostarray
    and comes back bit-exact, in bfloat16."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "from repro_torch.checkpoint import save_checkpoint, "
        "restore_checkpoint\n"
        "g = torch.Generator().manual_seed(0)\n"
        "x = torch.randn(5, 7, generator=g).to(torch.bfloat16)\n"
        "tree = {'a': x, 'b': torch.ones(3), 'n': 2}\n"
        f"save_checkpoint({str(tmp_path)!r}, 1, tree)\n"
        "out = restore_checkpoint(" + repr(str(tmp_path)) + ", 1, "
        "{'a': torch.zeros(5, 7, dtype=torch.bfloat16), "
        "'b': torch.zeros(3), 'n': 0})\n"
        "assert out['a'].dtype == torch.bfloat16\n"
        "assert torch.equal(out['a'].view(torch.int16), "
        "x.view(torch.int16))\n"
        "assert torch.equal(out['b'], tree['b']) and out['n'] == 2\n"
        "assert not [m for m, mod in sys.modules.items() if mod is not "
        "None and m.startswith(('jax', 'ml_dtypes'))]\n")
    out = subprocess.run([sys.executable, "-c", code], env=_blocked_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    meta = json.loads((tmp_path / "step_1" / "meta.json").read_text())
    assert meta["leaves"]["['a']"]["dtype"] == "bfloat16"


# ---------------------------------------------------------------------------
# the train step against the reference
# ---------------------------------------------------------------------------

ARCH = "h2o-danube-1.8b"


def _nerr(got: dict, want: dict) -> float:
    g = np.concatenate([np.asarray(got[k], np.float64).ravel()
                        for k in sorted(want)])
    w = np.concatenate([np.asarray(want[k], np.float64).ravel()
                        for k in sorted(want)])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def test_two_adamw_steps_equal_reference():
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              compute_dtype="float32")
    jcfg = dataclasses.replace(jget_config(ARCH, reduced=True),
                               compute_dtype="float32")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, jparams)
    params = convert.lm_params_from_numpy(host, device="cpu")
    opt = adamw(warmup_cosine(1e-2, 1, 4))
    jopt = jadamw(jwarmup(1e-2, 1, 4))
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int64), 1)
    jstate = jtraining.TrainState(jparams, jopt.init(jparams),
                                  jnp.zeros((), jnp.int32),
                                  jax.random.PRNGKey(1))
    step = make_train_step(cfg, None, opt)
    jstep = jtraining.make_train_step(jcfg, None, jopt)
    ds = SyntheticTokens(cfg.vocab_size, 2, 24, 0, device="cpu")
    jds = JSyntheticTokens(cfg.vocab_size, 2, 24, 0)
    for k in range(2):
        state, m = step(state, {"tokens": ds.batch_at(k)})
        jstate, jm = jstep(jstate, {"tokens": jds.batch_at(k)})
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
    assert int(state.step) == 2 and state.step.dtype == torch.int64
    got = {k: v.numpy() for k, v in flatten(state.params).items()}
    want = flatten(jax.tree.map(np.asarray, jstate.params))
    assert sorted(got) == sorted(want)
    assert _nerr(got, want) <= 1e-5
    for name in ("m", "v"):
        got = {k: v.numpy() for k, v in
               flatten(state.opt_state[name]).items()}
        want = flatten(jax.tree.map(np.asarray, jstate.opt_state[name]))
        assert _nerr(got, want) <= 1e-5, name


def test_grad_accumulation_matches_full_batch():
    cfg = get_config("qwen1.5-4b", reduced=True)
    opt = adamw(constant(1e-3))
    batch = make_batch(cfg, 8, 16, 0, device="cpu")

    def run(accum):
        params = init_params(cfg, 0, device="cpu")
        state = TrainState(params, opt.init(params),
                           torch.zeros((), dtype=torch.int64), 1)
        state, m = make_train_step(cfg, None, opt, accum_steps=accum)(state,
                                                                batch)
        return state, m["loss"].item()

    s1, l1 = run(1)
    s4, l4 = run(4)
    assert abs(l1 - l4) < 1e-2
    f1, f4 = flatten(s1.params), flatten(s4.params)
    for k in f1:
        # atol = 2.5x the LR: Adam normalizes gradients, so a bf16
        # reduction-order sign flip on a noise-level gradient moves a
        # barely-touched weight by up to ~2*lr
        np.testing.assert_allclose(f1[k].float().numpy(),
                                   f4[k].float().numpy(),
                                   rtol=2e-2, atol=2.5e-3, err_msg=k)


# ---------------------------------------------------------------------------
# the fault-tolerant loop
# ---------------------------------------------------------------------------

def build(tmp_path, total=10, ckpt_every=3, **loop_kw):
    cfg = get_config("minitron-4b", reduced=True)
    opt = adamw(constant(1e-3))
    params = init_params(cfg, 0, device="cpu")
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int64), 1)
    step = make_train_step(cfg, None, opt)

    def batch_fn(s):
        return make_batch(cfg, 2, 16, s, device="cpu")

    lc = TrainLoopConfig(total_steps=total, ckpt_dir=str(tmp_path),
                         ckpt_every=ckpt_every, async_ckpt=False, **loop_kw)
    return lc, step, batch_fn, state


def test_recovers_from_injected_failure(tmp_path):
    lc, step, batch_fn, state = build(tmp_path, total=6, ckpt_every=2)
    boom = {"armed": True}

    def flaky(s, b):
        if boom["armed"] and int(s.step) == 3:
            boom["armed"] = False
            raise RuntimeError("injected node failure")
        return step(s, b)

    res = TrainLoop(lc, flaky, batch_fn, state).run()
    assert res["final_step"] == 6
    assert not boom["armed"]
    # step 2 re-run after the restore of the step-2 checkpoint, then 3
    assert [m["step"] for m in res["metrics"]] == [0, 1, 2, 2, 3, 4, 5]


def test_resume_from_checkpoint(tmp_path):
    lc, step, batch_fn, state = build(tmp_path, total=4, ckpt_every=2)
    TrainLoop(lc, step, batch_fn, state).run()
    # new loop instance (fresh process semantics) resumes at 4, runs to 6
    lc2, step2, batch_fn2, state2 = build(tmp_path, total=6, ckpt_every=2)
    loop2 = TrainLoop(lc2, step2, batch_fn2, state2)
    start = loop2.maybe_resume()
    assert start == 4
    assert int(loop2.state.step) == 4
    assert loop2.run(start_step=start)["final_step"] == 6


def test_nan_loss_triggers_restore(tmp_path):
    lc, step, batch_fn, state = build(tmp_path, total=5, ckpt_every=2)
    poisoned = {"armed": True}

    def poison(s, b):
        trigger = poisoned["armed"] and int(s.step) == 3  # read BEFORE the
        s2, m = step(s, b)                                # step consumes s
        if trigger:
            poisoned["armed"] = False
            m = dict(m, loss=torch.tensor(float("nan")))
        return s2, m

    res = TrainLoop(lc, poison, batch_fn, state).run()
    assert res["final_step"] == 5
    losses = [m["loss"] for m in res["metrics"] if "loss" in m]
    assert losses and all(v == v for v in losses)  # no NaN in the log


def test_bounded_retries(tmp_path):
    lc, step, batch_fn, state = build(tmp_path, total=3, max_retries=2)

    def always_fails(s, b):
        raise RuntimeError("dead node")

    with pytest.raises(RuntimeError, match="dead node"):
        TrainLoop(lc, always_fails, batch_fn, state).run()


def test_straggler_detection_and_log(tmp_path):
    lc, step, batch_fn, state = build(
        tmp_path, total=6, straggler_factor=2.0,
        log_path=str(tmp_path / "metrics.jsonl"))
    seen = []
    holder = {}

    def slow_at_4(s, b):
        # sleep relative to the loop's own EMA so the test is robust to
        # machine-load variation
        if int(s.step) == 4 and holder["loop"]._ema is not None:
            time.sleep(5.0 * holder["loop"]._ema + 0.2)
        return step(s, b)

    loop = TrainLoop(lc, slow_at_4, batch_fn, state,
                     on_straggler=lambda st, dt, ema: seen.append(st))
    holder["loop"] = loop
    res = loop.run()
    assert 4 in [s for s, _ in res["stragglers"]]
    assert 4 in seen
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    rec = json.loads(lines[-1])
    assert rec["step"] == 5 and {"loss", "grad_norm", "lr"} <= set(rec)


# ---------------------------------------------------------------------------
# the entry point and the op count
# ---------------------------------------------------------------------------

def test_train_main_on_the_cpu(tmp_path, capsys):
    args = ["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--ckpt-every", "1",
            "--ckpt-dir", str(tmp_path), "--optimizer", "sophia_h"]
    res = train_cli.main(args)
    assert res["final_step"] == 2
    assert latest_step(str(tmp_path)) == 2
    assert "finished at step 2" in capsys.readouterr().out
    # a second run resumes at the end and takes no step
    assert train_cli.main(args)["metrics"] == []
    # whisper trains too (its batches carry the audio frames)
    res = train_cli.main(["--arch", "whisper-base", "--reduced",
                          "--steps", "2", "--batch", "2", "--seq", "16",
                          "--device", "cpu",
                          "--ckpt-dir", str(tmp_path / "whisper")])
    losses = [m["loss"] for m in res["metrics"] if "loss" in m]
    assert res["final_step"] == 2 and len(losses) == 2
    assert all(np.isfinite(x) for x in losses)


@pytest.mark.parametrize("arch,impl", [
    ("granite-moe-1b-a400m", "gspmd_sort"),
    ("granite-moe-1b-a400m", "shard_map_local"),
    ("mamba2-2.7b", None), ("zamba2-1.2b", None)])
def test_train_main_runs_the_moe_ssm_and_hybrid_families(tmp_path, capsys,
                                                         arch, impl):
    """The entry point trains the other ported families; on a world of
    one (``--data-mesh 1``) the sharded MoE runs every expert on the one
    rank."""
    args = ["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    if impl is not None:
        args += ["--moe-impl", impl, "--data-mesh", "1"]
    res = train_cli.main(args)
    assert res["final_step"] == 2
    assert all(np.isfinite(m["loss"]) for m in res["metrics"]
               if "loss" in m)
    assert "finished at step 2" in capsys.readouterr().out


@pytest.mark.parametrize("n,csize,n_mults", [(6, 3, 4), (8, 4, 7),
                                             (16, 8, 10), (4, 1, 3)])
def test_count_jaxpr_ops_equals_reference(n, csize, n_mults):
    """The aten count equals the reference's jaxpr count exactly: one hDual
    multiply is 6c+3 scalar mults, and at least 4c adds."""
    got = count_jaxpr_ops(n, csize, n_mults)
    assert got == jcount(n, csize, n_mults)
    assert got["mul"] == n_mults * (6 * csize + 3)
    assert got["add"] >= n_mults * 4 * csize
