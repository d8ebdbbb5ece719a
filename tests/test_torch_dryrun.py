"""repro_torch.launch.dryrun and its helpers against the JAX package.

* ``models.model.input_specs`` / ``batch_logical`` and
  ``models.params.abstract_params`` equal the reference's shapes, dtypes,
  logical axes and paths for every arch (and shape), every leaf on
  ``meta``;
* ``cost_probe_plan`` has the reference's probes and ``combine``; on each
  family's reduced config the probes extrapolate the single-device train
  step's flops and bytes to its full-depth count exactly;
* the counted flops against XLA's ``cost_analysis`` of the reference's
  step on a 1x1 CPU mesh (h2o-danube-1.8b at 2 layers, B = 2 x 512):
  the port counts matmuls and attention only (``torch.utils.flop_counter``
  formulas), XLA elementwise work too, and the two remat schemes differ;
  measured here 1.036 (train) and 0.9955 (prefill);
* the ring model equals ``repro.launch.hlo_analysis.parse_collectives``
  on synthetic HLO lines;
* ``run_cell`` at full width (2 layers) on the fake 16x16 and 2x16x16
  worlds: ``ok``, the reference's record keys (less the documented
  ones), the train cell's collectives as the step's design makes them,
  and no process group left behind.
"""

import ast
import dataclasses
import inspect
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import InputShape as JInputShape  # noqa: E402
from repro.launch.hlo_analysis import parse_collectives  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.params import abstract_params as jabstract  # noqa: E402
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.hlo_analysis import (COLLECTIVES,  # noqa: E402
                                             CollectiveStats,
                                             ring_wire_bytes)
from repro_torch.models import model  # noqa: E402
from repro_torch.models.params import abstract_params, flatten  # noqa: E402
from repro_torch.models.params import param_specs  # noqa: E402

dist = torch.distributed
ROOT = pathlib.Path(__file__).resolve().parents[1]
_JDTYPES = {jnp.dtype("int32"): torch.int32,
            jnp.dtype("float32"): torch.float32,
            jnp.dtype("bfloat16"): torch.bfloat16}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_and_batch_logical_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in SHAPES.items():
        jshape = JInputShape(name, shape.seq_len, shape.global_batch,
                             shape.kind)
        got, want = model.input_specs(cfg, shape), jmodel.input_specs(
            jcfg, jshape)
        assert list(got) == list(want)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape)
            assert v.dtype == _JDTYPES[want[k].dtype]
        assert model.batch_logical(cfg, shape) == jmodel.batch_logical(
            jcfg, jshape)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_params_equal_reference(arch):
    got = flatten(abstract_params(get_config(arch)))
    want = {"/".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                jabstract(jget_config(arch)))[0]}
    assert list(got) == list(want)        # sorted at every level, as JAX
    for p, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[p].shape), p
        assert t.dtype == _JDTYPES[want[p].dtype], p


FAMILY_ARCHS = {"dense": "h2o-danube-1.8b", "moe": "granite-moe-1b-a400m",
                "ssm": "mamba2-2.7b", "hybrid": "zamba2-1.2b",
                "encdec": "whisper-base", "vlm": "internvl2-1b"}


def _reference_probe_plan(jcfg):
    """The reference's ``cost_probe_plan``, read from its source and run
    on its own config (its module fakes 512 XLA devices when imported, so
    it is not imported here)."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    node = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef)
                and n.name == "cost_probe_plan")
    ns = {}
    exec(compile(ast.Module([node], []), "dryrun.py", "exec"), ns)
    return ns["cost_probe_plan"](jcfg)


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_cost_probe_plan_equals_reference(family):
    arch = FAMILY_ARCHS[family]
    cfg, jcfg = get_config(arch), jget_config(arch)
    probes, combine = dryrun.cost_probe_plan(cfg)
    jprobes, jcombine = _reference_probe_plan(jcfg)
    assert list(probes) == list(jprobes)
    fields = [f.name for f in dataclasses.fields(cfg)]
    for tag, p in probes.items():
        assert {f: getattr(p, f) for f in fields} == {
            f: getattr(jprobes[tag], f) for f in fields}, tag
    rng = np.random.RandomState(0)
    vecs = {t: rng.randn(3) * 1e12 for t in probes}
    np.testing.assert_allclose(combine(vecs), jcombine(vecs), rtol=1e-12)


def _train_counts(cfg, plan=dryrun.cost_probe_plan):
    """(full-depth [flops, bytes], the extrapolation of ``plan``'s probes)
    of the reduced config's single-device train step."""
    shape = InputShape("t", 32, 2, "train")
    full = dryrun.count_cell(cfg, shape)
    assert full["wire"] == 0.0 and not full["collectives"].ops
    probes, combine = plan(cfg)
    vecs = {}
    for tag, pcfg in probes.items():
        r = dryrun.count_cell(pcfg, shape)
        vecs[tag] = np.array([r["flops"], r["bytes"]], dtype=np.float64)
    return [full["flops"], full["bytes"]], combine(vecs).tolist()


@pytest.mark.parametrize("family", sorted(set(FAMILY_ARCHS) - {"hybrid"}))
def test_probes_extrapolate_the_train_count_exactly(family):
    """The reduced config's single-device train step: the probes' linear
    extrapolation of flops and bytes is the full-depth count."""
    full, extrapolated = _train_counts(
        get_config(FAMILY_ARCHS[family], reduced=True))
    assert full[0] > 0 and full[1] > 0
    assert extrapolated == full


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_linear_probes_extrapolate_the_train_count_exactly(family):
    """The probes past the one-layer edge hold every family, the hybrid
    one at its reduced every-2 block included."""
    full, extrapolated = _train_counts(
        get_config(FAMILY_ARCHS[family], reduced=True),
        dryrun.linear_probe_plan)
    assert extrapolated == full


def test_hybrid_probes_miss_only_the_shared_gradient_sum():
    """The hybrid family's shared block, every 3 layers over 6 (the reduced
    zamba2's every 2 cannot be probed: the next test): the flops
    extrapolate exactly; the bytes miss the second use's share of
    autograd's sum of the shared block's gradients over its uses (at most
    a read of two float32 copies and a write of one), which the one-use
    Lk probe never does."""
    base = get_config("zamba2-1.2b", reduced=True)
    shared = sum(t.numel() * 4 for p, t in flatten(abstract_params(
        base)).items() if p.startswith("shared/"))
    cfg = dataclasses.replace(base, attn_every=3, num_layers=6)  # 2 uses
    full, extrapolated = _train_counts(cfg)
    assert extrapolated[0] == full[0]
    assert 0 < full[1] - extrapolated[1] <= 3 * shared


def test_hybrid_probes_cannot_separate_a_block_shared_every_two_layers():
    """The reference's hybrid plan (L1, L2, Lk) at k = 2: Lk is L2, so the
    block's cost is read as zero and the extrapolation misses it -- the
    cross-check a record carries reports this, it does not hide it."""
    cfg = get_config("zamba2-1.2b", reduced=True)
    assert cfg.attn_every == 2
    probes, _ = dryrun.cost_probe_plan(cfg)
    assert probes["Lk"] == probes["L2"]
    full, extrapolated = _train_counts(cfg)
    assert extrapolated[0] > full[0]


def _xla_flops(jcfg, kind, B, S):
    """XLA's flop count of the reference's train step (AdamW) or prefill,
    lowered on a 1x1 CPU mesh as its dry run lowers them."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.models.params import param_specs as jparam_specs
    from repro.optim import adamw
    from repro.optim.schedule import warmup_cosine
    from repro.parallel.sharding import ACTIVATION_RULES, spec_for
    from repro.training.steps import TrainState, make_train_step

    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))

    def sds(a, spec):
        return jax.ShapeDtypeStruct(a.shape, a.dtype,
                                    sharding=NamedSharding(mesh, spec))

    shape = JInputShape("t", S, B, kind)
    batch = {k: sds(v, spec_for(v.shape, jmodel.batch_logical(
        jcfg, shape)[k], mesh, ACTIVATION_RULES))
        for k, v in jmodel.input_specs(jcfg, shape).items()}
    params = jax.tree.map(sds, jabstract(jcfg), jparam_specs(jcfg, mesh))
    if kind == "train":
        opt = adamw(warmup_cosine(3e-4, 100, 10_000))
        opt_abs = jax.eval_shape(opt.init, jabstract(jcfg))
        opt_sds = {k: jax.tree.map(sds, v, jparam_specs(jcfg, mesh))
                   for k, v in opt_abs.items()}
        state = TrainState(params, opt_sds, sds(jnp.zeros((), jnp.int32),
                                                P()),
                           sds(jnp.zeros((2,), jnp.uint32), P()))
        fn, args = make_train_step(jcfg, mesh, opt), (state, batch)
    else:
        ab = jax.eval_shape(lambda: jmodel.init_decode_state(jcfg, B, S))
        state = jax.tree.map(
            lambda a, ax: sds(a, spec_for(a.shape, ax, mesh,
                                          ACTIVATION_RULES)),
            ab, jmodel.decode_state_logical(jcfg, ab))
        fn = jax.jit(lambda p, b, s: jmodel.prefill(p, jcfg, b, s, mesh))
        args = (params, batch, state)
    cost = fn.lower(*args).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return float(cost["flops"])


@pytest.mark.parametrize("kind,band", [("train", (0.95, 1.10)),
                                       ("prefill", (0.95, 1.0))])
def test_flops_against_xla_cost_analysis(kind, band):
    """h2o-danube-1.8b at 2 layers, B = 2 x 512 (module docstring)."""
    over = {"num_layers": 2, "scan_layers": False}
    jcfg = dataclasses.replace(jget_config("h2o-danube-1.8b"), **over)
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), **over)
    xla = _xla_flops(jcfg, kind, 2, 512)
    ours = dryrun.count_cell(cfg, InputShape("t", 512, 2, kind))["flops"]
    assert band[0] <= ours / xla <= band[1], (ours, xla, ours / xla)


_HLO_TYPES = {"all-reduce": "f32[{n}]", "all-gather": "f32[{n}]",
              "reduce-scatter": "f32[{n}]", "all-to-all": "f32[{n}]",
              "collective-permute": "f32[{n}]"}


@pytest.mark.parametrize("group", [2, 16, 256])
@pytest.mark.parametrize("kind", COLLECTIVES)
def test_ring_model_equals_parse_collectives(kind, group):
    n = 4096 * group
    groups = ("source_target_pairs={{0,1}}" if kind == "collective-permute"
              else "replica_groups={{" + ",".join(map(str, range(group)))
              + "}}")
    line = (f"  %x.1 = {_HLO_TYPES[kind].format(n=n)} {kind}(f32[{n}] %p),"
            f" {groups}")
    want = parse_collectives(line, group)
    g = 2 if kind == "collective-permute" else group
    got = CollectiveStats()
    got.add(kind, 4 * n, g)
    assert got.ops == want.ops and got.by_kind == want.by_kind
    assert got.wire_bytes == want.wire_bytes
    assert ring_wire_bytes(kind, 4 * n, g) == want.details[0]["wire"]
    assert got.details == want.details


def _reference_record_keys():
    """Every key the reference's ``run_cell`` puts in an ok record, read
    from its source (``rec = {...}``, ``rec.update(...)``,
    ``rec["..."] = ...``)."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    keys = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", "") == "rec"):
            keys |= {k.value for k in node.value.keys}
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "update"):
            keys |= {k.arg for k in node.keywords}
        elif (isinstance(node, ast.Subscript)
              and getattr(node.value, "id", "") == "rec"
              and isinstance(node.ctx, ast.Store)):
            keys.add(node.slice.value)
    return keys - {"reason", "error", "traceback"}


def _design_wire(cfg):
    """The train step's collectives by its design, less the 4-byte
    scalars: each param leaf gathered whole (one all-gather per mesh axis
    that splits it, the minor axis first), each float32 gradient leaf
    all-reduced over the 16 data ranks."""
    sizes = {"data": 16, "model": 16}
    specs = flatten(param_specs(cfg, sizes))
    wire = 0.0
    for path, t in flatten(abstract_params(cfg)).items():
        nbytes = t.numel() * 4
        axes = [a for a in ("data", "model") if a in specs[path]]
        split = [sizes[a] for a in axes]
        for a in reversed(axes):
            split.pop()
            wire += ring_wire_bytes("all-gather",
                                    nbytes // int(np.prod(split or [1])),
                                    sizes[a])
        wire += ring_wire_bytes("all-reduce", nbytes, 16)
    return wire


@pytest.fixture(scope="module")
def cells():
    """run_cell at full width, 2 layers: three cells on 16x16, one on
    2x16x16; after each, no process group is left."""
    variant = {"cfg": {"num_layers": 2}}
    out = {}
    for shape, pod in (("train_4k", False), ("prefill_32k", False),
                       ("decode_32k", False), ("decode_32k", True)):
        out[shape, pod] = dryrun.run_cell("h2o-danube-1.8b", shape, pod,
                                          save=False, variant=variant)
        assert not dist.is_initialized()
    return out


@pytest.mark.parametrize("cell", [("train_4k", False),
                                  ("prefill_32k", False),
                                  ("decode_32k", False),
                                  ("decode_32k", True)])
def test_run_cell_records_ok_with_the_reference_keys(cells, cell):
    rec = cells[cell]
    assert rec["status"] == "ok", rec.get("traceback")
    want = _reference_record_keys() - set(dryrun.REFERENCE_ONLY_KEYS)
    assert want <= set(rec), want - set(rec)
    assert rec["n_devices"] == (512 if cell[1] else 256)
    assert rec["probe_check"]["agrees"], rec["probe_check"]
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["roofline_peak_flops"] == 989e12         # bf16 compute
    mem = rec["memory"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes", "alias_size_in_bytes"}
    assert 0 < mem["alias_size_in_bytes"] <= mem["output_size_in_bytes"]


def test_train_cell_collectives_follow_the_step_design(cells):
    rec = cells["train_4k", False]
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), num_layers=2)
    details = rec["collective_details"]
    big = [d for d in details if d["bytes"] > 4]
    scalars = [d for d in details if d["bytes"] <= 4]
    assert sum(d["wire"] for d in big) == pytest.approx(_design_wire(cfg),
                                                        rel=1e-12)
    # the loss and its metrics, and the global gradient norm's sums
    assert 2 <= len(scalars) <= 8
    assert all(d == {"kind": "all-reduce", "bytes": 4, "group": 16,
                     "wire": 7.5} for d in scalars)
    assert rec["collective_wire_bytes_per_device"] == pytest.approx(
        sum(d["wire"] for d in details), rel=1e-12)


def test_fake_world_refuses_another_size_and_cleans_up():
    with dryrun.fake_world(256):
        assert dist.get_world_size() == 256 and dist.get_rank() == 0
        with pytest.raises(ValueError, match="256"):
            with dryrun.fake_world(512):
                pass
        with dryrun.fake_world(256):        # the same size is reused
            assert dist.get_world_size() == 256
        assert dist.is_initialized()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="boom"):
        with dryrun.fake_world(16):
            raise RuntimeError("boom")
    assert not dist.is_initialized()


def test_skipped_and_error_records():
    rec = dryrun.run_cell("deepseek-67b", "long_500k", save=False)
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
    bad = dryrun.run_cell("h2o-danube-1.8b", "train_4k", save=False,
                          variant={"optimizer": "lion"})
    assert bad["status"] == "error" and "lion" in bad["error"]
    assert "Traceback" in bad["traceback"]
    assert not dist.is_initialized()


def test_run_cell_writes_and_rereads_its_record(tmp_path):
    rec = dryrun.run_cell("deepseek-67b", "long_500k", out_dir=str(tmp_path))
    again = dryrun.run_cell("deepseek-67b", "long_500k",
                            out_dir=str(tmp_path))
    assert again == rec
    assert (tmp_path / "deepseek-67b__long_500k__pod1.json").exists()


def test_donate_state_is_accepted_and_changes_nothing():
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), num_layers=1)
    shape = InputShape("d", 64, 2, "decode")
    a = dryrun.count_cell(cfg, shape)
    b = dryrun.count_cell(cfg, shape, donate_state=True)
    assert (a["flops"], a["bytes"], a["memory"]) == (
        b["flops"], b["bytes"], b["memory"])
    assert "donate_state" in inspect.signature(dryrun.build_step).parameters


def test_sophia_h_counts_on_meta_stand_ins():
    """SophiaH's step 0 estimates the Hessian diagonal: its probes draw
    from a host generator on meta trees, and the host step counter steers
    it; the estimate's HVPs cost more than AdamW's update."""
    cfg = get_config("h2o-danube-1.8b", reduced=True)
    shape = InputShape("t", 32, 2, "train")
    adamw = dryrun.count_cell(cfg, shape)
    sophia = dryrun.count_cell(cfg, shape, optimizer_name="sophia_h")
    assert sophia["flops"] > adamw["flops"] > 0


def test_roofline_terms_peak_keyword():
    from repro_torch.launch.hlo_analysis import (PEAK_BF16, PEAK_FLOPS,
                                                 roofline_terms)
    plain = roofline_terms(1e12, 1e9, 1e6)
    assert plain == roofline_terms(1e12, 1e9, 1e6, peak_flops=PEAK_FLOPS)
    assert plain["compute_s"] == 1e12 / 67e12 and PEAK_BF16 == 989e12
    bf16 = roofline_terms(1e12, 1e9, 1e6, peak_flops=PEAK_BF16)
    assert bf16["compute_s"] == 1e12 / 989e12
    assert bf16["memory_s"] == plain["memory_s"]
