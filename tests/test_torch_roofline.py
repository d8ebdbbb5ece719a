"""repro_torch.launch.roofline --curvature: the sweep gate and its cell
accounting (tests/test_roofline.py is the template).

The gate is the tripwire that symmetric schedules never regress from
skipping (compacted cell lists) back to masking.  The static sharded_rows
rows must equal those the reference builds from its own ``cyclic_layout``
and ``rows_per_shard`` (the reference's ``curvature_records`` itself is not
called: it runs Pallas in interpret mode).  The measured rows are taken on
the CPU here; their times are nominal."""

import pytest

torch = pytest.importorskip("torch")

from repro.core import distributed as jdist  # noqa: E402
from repro.core.api import num_chunk_evals as jnum_chunk_evals  # noqa: E402
from repro_torch.core.api import num_chunk_evals  # noqa: E402
from repro_torch.kernels.chess_hvp import needed_work  # noqa: E402
from repro_torch.launch.roofline import (_executed_cells,  # noqa: E402
                                         _sweep_gate, curvature_records,
                                         render_curvature, run_curvature,
                                         sharded_rows_records)


def _rec(backend, sched, executed, minimum, **kw):
    r = {"backend": backend, "schedule": sched, "n": 8, "csize": 4,
         "cells_executed": executed, "cells_min": minimum}
    r.update(kw)
    return r


def test_sweep_gate_passes_exact_triangle():
    recs = [_rec("cuda", "sym", 12, 12), _rec("cuda", "full", 16, 16),
            _rec("vmap_l2", "sym", 12, 12)]
    assert _sweep_gate(recs) == []


def test_sweep_gate_catches_masked_ghosts():
    """A schedule that launches the full grid and masks the triangle must
    trip the gate."""
    fails = _sweep_gate([_rec("cuda", "sym", 16, 12)])
    assert fails and "cuda" in fails[0]


def test_sweep_gate_sharded_padding_slack():
    """The cyclic sharded layout pads every shard to the max kept count:
    executed may exceed the triangle by the declared allowance, but KEPT
    must equal the triangle exactly."""
    ok = _rec("sharded_rows", "sym", 96, 84, cells_allowed=156,
              cells_kept=84)
    assert _sweep_gate([ok]) == []
    assert _sweep_gate([_rec("sharded_rows", "sym", 96, 84,
                             cells_allowed=156, cells_kept=90)])
    assert _sweep_gate([_rec("sharded_rows", "sym", 200, 84,
                             cells_allowed=156, cells_kept=84)])


@pytest.mark.parametrize("n,csize,sym", [(12, 4, True), (12, 4, False),
                                         (13, 4, True), (8, 8, True),
                                         (64, 8, True)])
def test_executed_cells_match_schedule_enumeration(n, csize, sym):
    """Every backend column's cell count equals the schedule's own
    enumeration, the reference's included: the kernel's launch grid for
    cuda (each device form), the cell list for vmap_l2."""
    want = num_chunk_evals(n, csize, sym)
    assert want == jnum_chunk_evals(n, csize, sym)
    assert _executed_cells("vmap_l2", 8, n, csize, None, sym) == want
    for fn in ("rosenbrock", "ackley", "fletcher_powell"):
        assert _executed_cells("cuda", 8, n, csize, None, sym, fn) == want


def _reference_static_rows(n, csize, size):
    """The two rows as the reference's curvature_records builds them."""
    lay = jdist.cyclic_layout(n, csize, size)
    tri = jnum_chunk_evals(n, csize, True)
    nchunk = -(-n // csize)
    return [{"backend": "sharded_rows", "schedule": "sym", "m": 1, "n": n,
             "csize": csize, "shards": size,
             "cells_executed": size * lay.executed,
             "cells_kept": int(sum(lay.kept)), "cells_min": tri,
             "cells_allowed": tri + (size - 1) * lay.block_cells_bound,
             "status": "static"},
            {"backend": "sharded_rows", "schedule": "full", "m": 1, "n": n,
             "csize": csize, "shards": size,
             "cells_executed": size * jdist.rows_per_shard(n, size) * nchunk,
             "cells_min": jnum_chunk_evals(n, csize, False),
             "status": "static"}]


@pytest.mark.parametrize("n,csize,size", [(24, 4, 4), (48, 4, 4),
                                          (13, 4, 4), (64, 8, 8),
                                          (7, 3, 8)])
def test_static_sharded_rows_equal_reference(n, csize, size):
    assert sharded_rows_records(n, csize, size) == \
        _reference_static_rows(n, csize, size)


def test_curvature_records_on_the_cpu(tmp_path, capsys):
    """The quick report on the CPU: vmap_l2 both schedules plus the static
    rows, each measured row on its device, the gate passing (exit 0)."""
    recs = curvature_records(quick=True, device="cpu")
    measured = [r for r in recs if r["status"] == "measured"]
    assert [(r["backend"], r["schedule"]) for r in measured] == [
        ("vmap_l2", "full"), ("vmap_l2", "sym")]
    for r in measured:
        assert r["device"] == "cpu" and r["measured_s"] > 0
        assert r["flops"] == needed_work(
            "rosenbrock", r["m"], r["n"], r["csize"],
            r["schedule"] == "sym")[0]
        assert r["bytes"] == 3 * r["m"] * r["n"] * 4
    assert recs[2:] == _reference_static_rows(24, 4, 4)
    assert _sweep_gate(recs) == []
    assert run_curvature(quick=True, md=True, device="cpu",
                         json_out=str(tmp_path / "r.json")) == 0
    assert "sweep gate: all symmetric" in capsys.readouterr().out


def test_render_curvature_table_md():
    recs = [_rec("vmap_l2", "full", 16, 16, flops=1e6, bytes=1e5,
                 measured_s=2e-4, bound_s=1e-6, pct_roofline=0.5),
            _rec("vmap_l2", "sym", 12, 12, flops=6e5, bytes=6e4,
                 measured_s=1e-4, bound_s=6e-7, pct_roofline=0.6)]
    txt = render_curvature(recs, md=True)
    assert txt.startswith("| backend")
    assert "speedup = 2.00x" in txt
