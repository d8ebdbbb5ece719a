"""repro_torch.parallel.sharding and models.params.param_specs against the
JAX reference (tests/test_sharding.py is the template).

``spec_for`` and ``param_specs`` must equal the reference's exactly, for
every parameter of every architecture, on the reference's own
``AbstractMesh`` of the production layouts (16x16 and 2x16x16; the port
reads it as an ``{axis: size}`` dict).  A dim the reference shards over a
tuple of axes is split major to minor (``P(("pod", "data"))``: the device
at (pod p, data d) holds block p * |data| + d); one spawn of 8 gloo ranks
(tests/torch_dist_ranks.py) shows the DTensor placements ``NamedSharding``
gives put the same block on the same rank."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCH_NAMES as JARCH_NAMES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.params import param_specs as jparam_specs  # noqa: E402
from repro.models.params import param_table as jparam_table  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.models.params import flatten, param_specs  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from torch_dist_ranks import spawn  # noqa: E402

LAYOUTS = {"single_pod": ((16, 16), ("data", "model")),
           "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(layout):
    sizes, names = LAYOUTS[layout]
    return AbstractMesh(tuple(sizes), tuple(names)), dict(zip(names, sizes))


def _spec(p) -> tuple:
    """A reference PartitionSpec as the port's tuple."""
    return tuple(p)


def test_rule_tables_equal_reference():
    assert sharding.PARAM_RULES == jsharding.PARAM_RULES
    assert sharding.ACTIVATION_RULES == jsharding.ACTIVATION_RULES
    assert ARCH_NAMES == JARCH_NAMES


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_spec_for_equals_reference(layout):
    """The reference's own cases plus every logical axis of both tables on
    divisible, indivisible and tuple-axis dims."""
    jmesh, mesh = _meshes(layout)
    cases = [((8192, 64, 128), ("embed", "heads", "head_dim")),
             ((40, 1536, 512), ("experts", "embed", "expert_ffn")),
             ((32, 1024, 512), ("experts", "embed", "expert_ffn")),
             ((6, 32), ("batch", None)), ((64, 7), ("batch", "vocab")),
             ((256, 48, 8), ("batch", "kv_seq", "kv_heads"))]
    for rules, jrules in ((sharding.PARAM_RULES, jsharding.PARAM_RULES),
                          (sharding.ACTIVATION_RULES,
                           jsharding.ACTIVATION_RULES)):
        for name in rules:
            for dim in (1, 16, 40, 64, 512):
                cases.append(((dim, 32), (name, "ffn")))
        for shape, logical in cases:
            got = sharding.spec_for(shape, logical, mesh, rules)
            want = jsharding.spec_for(shape, logical, jmesh, jrules)
            assert got == _spec(want), (layout, shape, logical)
    assert sharding.data_axes(mesh) == jsharding.data_axes(jmesh)
    assert sharding.batch_spec(mesh) == _spec(jsharding.batch_spec(jmesh))
    for axis in ("data", "model", tuple(sharding.data_axes(mesh))):
        assert sharding.mesh_axis_size(mesh, axis) == \
            jsharding.mesh_axis_size(jmesh, axis)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_equal_reference(arch, layout):
    """Every parameter of every architecture, full size and reduced."""
    jmesh, mesh = _meshes(layout)
    for reduced in (False, True):
        got = flatten(param_specs(get_config(arch, reduced), mesh))
        want = jparam_specs(jget_config(arch, reduced), jmesh)
        want = {k: _spec(v) for k, v in _jflatten(want).items()}
        assert sorted(got) == sorted(jparam_table(
            jget_config(arch, reduced)))
        assert got == want, (arch, layout, reduced)


def _jflatten(tree, prefix=""):
    """The reference's spec tree flattened to {path: PartitionSpec}: its
    leaves are PartitionSpecs, which its own ``flatten`` would walk."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_jflatten(v, f"{prefix}{k}/"))
        else:
            assert isinstance(v, P), (k, v)
            out[f"{prefix}{k}"] = v
    return out


def test_constrain_returns_its_input():
    x = torch.randn(2, 3, 4)
    assert sharding.constrain(x, {"data": 2, "model": 4}, "batch", None,
                              "vocab") is x
    assert sharding.constrain(x, None, "batch", None, None) is x


def test_placements_refuse_axes_out_of_mesh_order():
    from types import SimpleNamespace
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    ns = sharding.NamedSharding(mesh, (("pod", "data"), "model"))
    assert [str(p) for p in ns.placements()] == ["S(0)", "S(0)", "S(1)"]
    with pytest.raises(ValueError, match="order"):
        sharding.NamedSharding(mesh, (("data", "pod"),)).placements()


def test_tuple_axes_split_major_to_minor_on_eight_ranks(tmp_path):
    """On a ("pod", "data", "model") = (2, 2, 2) mesh: the DTensor that
    ``NamedSharding(mesh, (("pod", "data"), "model")).shard`` builds, the
    block ``distribute_tensor`` gives the same placements, and the block
    the reference's major-to-minor rule names are one block on every
    rank; ``full_tensor`` gives the global tensor back; and
    ``param_specs`` places every reduced-config leaf as ``shard_like``
    cuts it."""
    x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    ranks = spawn("sharding", 8, tmp_path, {"x": x}, timeout=120)
    for rank, (got, info) in enumerate(ranks):
        p, d, m = info["coords"]
        rows = slice((p * 2 + d) * 2, (p * 2 + d + 1) * 2)   # pod major
        cols = slice(m * 3, (m + 1) * 3)
        for key in ("shard", "distribute"):
            np.testing.assert_array_equal(got[key], x[rows, cols],
                                          err_msg=f"{rank} {key}")
        np.testing.assert_array_equal(got["full"], x)
        assert info["placements"] == ["S(0)", "S(0)", "S(1)"]
        assert info["params_placed"] is True
