"""Multi-pod dry run: count every (arch x shape x mesh) cell on fake tensors.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell's step on 512 fake XLA devices and reads the compiled program's
cost and memory analysis.  PyTorch compiles no such program; this port
runs one call of the step instead, as rank 0 of a fake world, on fake
tensors, and counts what it does.  For each cell it

  1. starts a ``"fake"`` process group of 256 (16x16) or 512 (2x16x16)
     ranks, unless the process already has one of that size, and builds
     the production mesh (``launch.mesh.make_production_mesh``);
  2. builds stand-ins for every input of the step as ``meta`` tensors
     (shapes, dtypes and storages, no data; nothing is allocated): the
     params (``models.params.abstract_params``) and the optimizer state
     (``optimizer.init``) as DTensors placed by ``param_specs``, as
     ``training.steps.state_shardings`` places them, the batch
     (``models.model.input_specs``) placed by ``ACTIVATION_RULES`` on
     ``batch_logical``, the caches (``init_decode_state``) by
     ``decode_state_logical``.  Not ``FakeTensorMode``: it gives the same
     counts at several times the host seconds per op, and a torch built
     without CUDA aborts the process when autograd meets a fake ``cuda``
     tensor; ``meta`` runs the same on the card's machine and on one
     without a card;
  3. runs the step once and counts, per device (rank 0's local tensors):
       flops   -- ``torch.utils.flop_counter``'s per-op formulas (those of
                  ``FlopCounterMode``) on every local op: matmuls and
                  attention, not elementwise work.  ``FlopCounterMode``
                  itself counts a DTensor op at its global shape, so the
                  counter applies its formulas below DTensor;
       bytes   -- every aten op's input and output bytes (views and bare
                  allocations move none): an UNFUSED upper bound on HBM
                  traffic, not XLA's post-fusion count;
       collectives -- every collective the step issues (DTensor's
                  functional collectives and the c10d calls of
                  ``training.steps``, ``parallel/`` and
                  ``models/moe_sharded.py``): kind, output bytes and group
                  size, turned into wire bytes by the ring model of
                  ``launch.hlo_analysis``;
       memory  -- from the live fake storages, the reference's four keys:
                  ``argument_size_in_bytes`` the inputs' local bytes,
                  ``output_size_in_bytes`` the storages the outputs hold,
                  ``alias_size_in_bytes`` those of them that are an
                  argument's (the in-place optimizer and cache writes), and
                  ``temp_size_in_bytes`` the peak of live bytes beyond the
                  arguments and the outputs' own new storages, so that
                  argument + temp + output - alias is the peak;
  4. destroys the process group it started, on an error too.

The steps, as in the reference:
  train    -> ``training.steps.make_train_step(cfg, mesh, opt)``: AdamW, or
              SophiaH, both on ``warmup_cosine(3e-4, 100, 10_000)``.  On a
              mesh it gathers the params whole on every rank, takes its
              rows' gradients and averages them over the data axes
  prefill  -> ``models.model.prefill``
  decode   -> ``models.model.decode_step`` (ONE token against a
              seq_len-sized cache)
The serving steps follow the train step's design: each rank gathers the
params whole and runs its own rows.  So its caches hold their rows whole:
the cache stand-ins are placed by the batch axis of
``decode_state_logical`` alone, where the reference also splits heads (or
the sequence) over ``model``; the port has no tensor-parallel attention.
``donate_state`` is accepted and recorded and changes nothing: the port's
prefill and decode write their caches in place anyway (the record's
``alias_size_in_bytes`` shows it).

The port runs every layer from Python (no scan), so the count of the
full-depth step is the cell's cost.  The probes are kept as cross-checks
of that count: the reference's ``cost_probe_plan`` (one- and two-layer
variants; its costs and extrapolation in ``probe_costs`` /
``probe_extrapolated``) and ``linear_probe_plan``, which starts at two
layers (``linear_probe_*``).  A step's cost is linear in depth from two
layers on, not from one (``linear_probe_plan``), so ``probe_check``'s
``agrees`` is the second plan's exact agreement on flops, bytes and wire
bytes; the reference plan's gaps are recorded beside it
(``reference_probes``), not hidden.

The record keeps every key of the reference's that has a meaning here,
under its name, but for ``lower_s`` / ``compile_s`` (one ``trace_s``, the
seconds of the counted call) and ``probe_compile_s`` (``probe_trace_s``).
``hlo_lines`` and ``scan_body_once_cost`` have no counterpart: there is
no HLO and no scanned body (``REFERENCE_ONLY_KEYS``).  The roofline's
compute term uses ``PEAK_BF16`` for bfloat16 compute, ``PEAK_FLOPS`` for
float32.

Usage:
  python -m repro_torch.launch.dryrun --arch minitron-4b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
      [--force] [--out DIR] [--jobs N]
``--arch`` and ``--shape`` also take comma-joined lists (every pair is a
cell); ``--jobs N`` counts N cells at once, one process each (a cell's
count is single-threaded host work).
Records land in ``artifacts/dryrun_torch/<cell>.json`` (``--out``);
``python -m repro_torch.launch.roofline --dir`` renders them.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed import ProcessGroup
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import SHAPES, all_cells, get_config
from repro_torch.configs.base import InputShape, shape_supported
from repro_torch.launch.hlo_analysis import (PEAK_BF16, PEAK_FLOPS,
                                             CollectiveStats, roofline_terms)
from repro_torch.models import model as model_lib
from repro_torch.models.params import (abstract_params, flatten,
                                       param_specs, unflatten)
from repro_torch.parallel.sharding import (ACTIVATION_RULES, NamedSharding,
                                           gather, spec_for)

__all__ = ["run_cell", "count_cell", "count_call", "peak_bytes",
           "cost_probe_plan",
           "linear_probe_plan", "build_step", "fake_world", "StepCounter",
           "ARTIFACT_DIR", "REFERENCE_ONLY_KEYS", "main"]

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")

# keys of the reference's record with no counterpart here (docstring)
REFERENCE_ONLY_KEYS = ("lower_s", "compile_s", "probe_compile_s",
                       "scan_body_once_cost", "hlo_lines")

# the serving steps' caches: rows over the data axes, the rest whole
CACHE_RULES = {"batch": ACTIVATION_RULES["batch"]}

_WORLDS = {False: 256, True: 512}


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------

def _fake_store():
    """A store for the ``"fake"`` backend.  Both live in the private
    ``torch.testing._internal.distributed.fake_pg`` (importing it registers
    the backend); this is the port's one import of it."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"launch.dryrun: torch {torch.__version__} has no "
            "torch.testing._internal.distributed.fake_pg.FakeStore; the dry "
            "run's fake process group needs it (checked on torch 2.11 and "
            "2.13)") from e
    return FakeStore()


@contextlib.contextmanager
def fake_world(size: int):
    """A process group of ``size`` ranks for the block: this process is
    rank 0 of a ``"fake"`` group (collectives return at once and move
    nothing) that the block's exit destroys, or the process's own group
    when it already has one of that size.  ValueError for a group of
    another size."""
    if dist.is_initialized():
        have = dist.get_world_size()
        if have != size:
            raise ValueError(f"dryrun: the process group has {have} ranks; "
                             f"the cell needs {size}")
        yield
        return
    dist.init_process_group("fake", store=_fake_store(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

# collective ops: name -> (kind, where the output is: "ret" or an arg
# index); any other op of the collective namespaces raises
_COLLECTIVE_OPS = {
    "_c10d_functional.all_reduce": ("all-reduce", "ret"),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "ret"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "ret"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "ret"),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allgather_": ("all-gather", 0),
    "c10d._allgather_base_": ("all-gather", 0),
    "c10d.reduce_scatter_": ("reduce-scatter", 0),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 0),
    "c10d.alltoall_base_": ("all-to-all", 0),
}
# collective-namespace ops that move no data of their own
_COLLECTIVE_NOOPS = {"_c10d_functional.wait_tensor",
                     "_c10d_functional._wrap_tensor_autograd"}
# ops that allocate, or set a tensor's storage, without moving data (views
# are skipped as such)
_NO_TRAFFIC = {"aten.empty", "aten.empty_strided", "aten.empty_like",
               "aten.new_empty", "aten.new_empty_strided", "aten.set_",
               "aten.resize_"}


def _tensors(x):
    """The tensors of an op's arguments or results (nested lists, tuples
    and dicts)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors(y)]
    return []


def _leaves(tree):
    """The tensors of a step's argument or result tree (any pytree)."""
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _classify(func):
    """How the counter treats ``func``: ("collective", kind, where),
    ("skip",), ("count", flop formula or None) or ("unknown", name)."""
    name = f"{func.namespace}.{func._schema.name.split('::')[-1]}"
    if name in _COLLECTIVE_OPS:
        return ("collective",) + _COLLECTIVE_OPS[name]
    if name in _COLLECTIVE_NOOPS:
        return ("skip",)
    if func.namespace in ("c10d", "_c10d_functional"):
        return ("unknown", name)
    if func.is_view or name in _NO_TRAFFIC:
        return ("skip",)
    return ("count", flop_registry.get(func._overloadpacket))


def _group_size(args) -> int:
    """The size of the group a collective's arguments name."""
    for a in args:
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(
                a._type()):
            return ProcessGroup.unbox(a).size()
    # functional collectives name their group last among the strings
    name = [a for a in args if isinstance(a, str)][-1]
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


class StepCounter(TorchDispatchMode):
    """Counts one call's flops, bytes, collectives and live storage bytes
    (module docstring, step 3).  Enter it after ``add_arguments``.  A
    DTensor op is handed back to DTensor (NotImplemented), so the counter
    sees its local ops and the collectives it issues, once each."""

    def __init__(self):
        super().__init__()
        self._how: dict = {}
        self.flops = 0
        self.bytes = 0
        self.collectives = CollectiveStats()
        self.argument_bytes = 0
        self._args: set = set()
        self._live: dict = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    # -- storages ----------------------------------------------------------
    @staticmethod
    def _storage(t):
        if isinstance(t, DTensor):
            t = t.to_local()
        return t.untyped_storage()

    def _track(self, st, argument=False):
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()

        def release(_ref, key=key, n=n):
            if self._live.pop(key, None) is not None:
                self.live_bytes -= n

        self._live[key] = weakref.ref(st, release)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        if argument:
            self._args.add(key)
            self.argument_bytes += n

    def add_arguments(self, tree):
        """Count the storages of every tensor in ``tree`` as arguments."""
        for t in _leaves(tree):
            self._track(self._storage(t), argument=True)

    def memory(self, outputs) -> dict:
        """The reference's four memory keys after the call (module
        docstring): ``outputs`` is the call's return value."""
        out = alias = 0
        seen = set()
        for t in _leaves(outputs):
            st = self._storage(t)
            if id(st) in seen:
                continue
            seen.add(id(st))
            out += st.nbytes()
            if id(st) in self._args:
                alias += st.nbytes()
        new = out - alias
        return {"argument_size_in_bytes": int(self.argument_bytes),
                "output_size_in_bytes": int(out),
                "alias_size_in_bytes": int(alias),
                "temp_size_in_bytes": int(max(
                    0, self.peak_bytes - self.argument_bytes - new))}

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation infers an op's global
            # shapes on fake tensors (once per op and shapes, cached): no
            # work of the step
            return out
        how = self._how.get(func)
        if how is None:
            how = self._how[func] = _classify(func)
        outs = _tensors(out)
        if how[0] == "count" and outs:
            self.bytes += sum(map(_nbytes, _tensors(args)))
            if kwargs:
                self.bytes += sum(map(_nbytes, _tensors(kwargs)))
            self.bytes += sum(map(_nbytes, outs))
            if how[1] is not None:
                self.flops += int(how[1](*args, **kwargs, out_val=out))
        elif how[0] == "collective":
            dest = outs if how[2] == "ret" else _tensors(args[how[2]])
            self.collectives.add(how[1], sum(map(_nbytes, dest)),
                                 _group_size(args))
        elif how[0] == "unknown":
            raise NotImplementedError(f"dryrun: no ring model for the "
                                      f"collective {how[1]}")
        for t in outs:
            self._track(t.untyped_storage())
        return out


def peak_bytes(memory: dict) -> int:
    """The bytes a device holds at the call's peak, from the four memory
    keys: argument + temp + output - alias (roofline's hbm_GiB)."""
    return (memory["argument_size_in_bytes"] + memory["temp_size_in_bytes"]
            + memory["output_size_in_bytes"] - memory["alias_size_in_bytes"])


def count_call(fn, args: tuple) -> dict:
    """Run ``fn(*args)`` once under a ``StepCounter``: flops, bytes, wire
    bytes, the collectives, memory (``args`` are the arguments) and the
    call's seconds."""
    counter = StepCounter()
    counter.add_arguments(args)
    t0 = time.perf_counter()
    with counter:
        outputs = fn(*args)
    seconds = time.perf_counter() - t0
    coll = counter.collectives
    rec = {"flops": float(counter.flops), "bytes": float(counter.bytes),
           "wire": float(coll.wire_bytes), "collectives": coll,
           "memory": counter.memory(outputs), "trace_s": seconds}
    del outputs
    return rec


# ---------------------------------------------------------------------------
# stand-ins and steps
# ---------------------------------------------------------------------------

def _standin(meta, sharding):
    """The stand-in of the ``meta`` tensor ``meta``: its local block as a
    DTensor placed by ``sharding`` (a NamedSharding), or itself (None)."""
    if sharding is None:
        return meta
    block = tuple(s.stop - s.start for s in sharding.local_slices(meta.shape))
    return sharding.wrap(torch.empty(block, dtype=meta.dtype, device="meta"),
                         meta.shape)


def _placed(meta_tree, logical_tree, mesh, rules):
    if mesh is None:
        return meta_tree
    return pytree.tree_map(
        lambda m, ax: _standin(m, NamedSharding(
            mesh, spec_for(m.shape, ax, mesh, rules))),
        meta_tree, logical_tree,
        is_leaf=lambda x: isinstance(x, torch.Tensor))


def _batch(cfg, shape, mesh):
    return _placed(model_lib.input_specs(cfg, shape),
                   model_lib.batch_logical(cfg, shape), mesh,
                   ACTIVATION_RULES)


def _decode_state(cfg, shape, mesh):
    meta = model_lib.init_decode_state(cfg, shape.global_batch,
                                       shape.seq_len, device="meta")
    return _placed(meta, model_lib.decode_state_logical(cfg, meta), mesh,
                   CACHE_RULES)


def _params(cfg, mesh):
    """The params placed by ``param_specs`` (``state_shardings``'
    params)."""
    meta = abstract_params(cfg)
    if mesh is None:
        return meta
    specs = flatten(param_specs(cfg, mesh))
    return unflatten({p: _standin(m, NamedSharding(mesh, specs[p]))
                      for p, m in flatten(meta).items()})


def _local(tree):
    return pytree.tree_map(
        lambda x: x.to_local() if isinstance(x, DTensor) else x, tree)


def _optimizer(optimizer_name, sophia_kw):
    from repro_torch.optim import adamw, sophia_h, warmup_cosine
    sched = warmup_cosine(3e-4, 100, 10_000)
    if optimizer_name == "sophia_h":
        return sophia_h(sched, **(sophia_kw or {}))
    if optimizer_name != "adamw":
        raise ValueError(f"dryrun: unknown optimizer {optimizer_name!r}")
    return adamw(sched)


def build_step(cfg, shape, mesh, *, optimizer_name="adamw", accum_steps=1,
               donate_state=False, sophia_kw=None):
    """(fn, args): the cell's step and its ``meta`` stand-ins, ready for
    ``count_call(fn, args)``; the counterpart of the reference's
    ``build_lowerable``.  ``mesh=None`` is the single-device step;
    ``donate_state`` changes nothing (module docstring)."""
    from repro_torch.training.steps import TrainState, make_train_step
    del donate_state
    params = _params(cfg, mesh)
    if shape.kind == "train":
        opt = _optimizer(optimizer_name, sophia_kw)
        # the step counter steers host control flow (SophiaH's estimate
        # steps), so it holds a value: step 0, a host tensor
        state = TrainState(params, opt.init(params),
                           torch.zeros((), dtype=torch.int64), 0)
        batch = _batch(cfg, shape, mesh)
        return (make_train_step(cfg, mesh, opt, accum_steps=accum_steps),
                (state, batch))

    state = _decode_state(cfg, shape, mesh)
    batch = _batch(cfg, shape, mesh)
    whole = gather if mesh is not None else (lambda t: t)

    if shape.kind == "prefill":
        def prefill_step(params, batch, state):
            with torch.no_grad():
                return model_lib.prefill(whole(params), cfg, _local(batch),
                                         _local(state), mesh)
        return prefill_step, (params, batch, state)

    def serve_step(params, tokens, pos, state):
        with torch.no_grad():
            return model_lib.decode_step(whole(params), cfg,
                                         _local(tokens), _local(pos),
                                         _local(state), mesh)
    return serve_step, (params, batch["tokens"], batch["pos"], state)


def count_cell(cfg, shape: InputShape, mesh=None, **build_kw) -> dict:
    """One counted call of the cell's step on ``meta`` stand-ins
    (``count_call``'s record): the dry run's counting function.  With
    ``mesh=None`` it needs no process group (a single card's step)."""
    fn, args = build_step(cfg, shape, mesh, **build_kw)
    return count_call(fn, args)


def cost_probe_plan(cfg):
    """Small-depth variants whose costs extrapolate linearly to the full
    depth, and how: (probes: {tag: cfg_variant}, combine: {tag: vec} ->
    vec), ``vec`` any per-device cost vector (flops, bytes, wire bytes).
    The reference needs them because XLA counts a scanned body once; the
    port counts every layer, and keeps the probes as a cross-check."""

    def mk(**kw):
        return dataclasses.replace(cfg, scan_layers=False, **kw)

    if cfg.family == "hybrid":
        from repro_torch.models.transformer import hybrid_attn_layout
        k = cfg.attn_every
        _, _, n_attn = hybrid_attn_layout(cfg)
        probes = {"L1": mk(num_layers=1), "L2": mk(num_layers=2),
                  "Lk": mk(num_layers=k)}

        def combine(c):
            a = 2 * c["L1"] - c["L2"]
            bm = c["L2"] - c["L1"]
            ba = c["Lk"] - a - k * bm
            return a + cfg.num_layers * bm + n_attn * ba

        return probes, combine

    if cfg.family == "encdec":
        probes = {"E1D1": mk(encoder_layers=1, num_layers=1),
                  "E2D1": mk(encoder_layers=2, num_layers=1),
                  "E1D2": mk(encoder_layers=1, num_layers=2)}

        def combine(c):
            be = c["E2D1"] - c["E1D1"]
            bd = c["E1D2"] - c["E1D1"]
            a = c["E1D1"] - be - bd
            return a + cfg.encoder_layers * be + cfg.num_layers * bd

        return probes, combine

    probes = {"L1": mk(num_layers=1), "L2": mk(num_layers=2)}

    def combine(c):
        return 2 * c["L1"] - c["L2"] + (c["L2"] - c["L1"]) * cfg.num_layers

    return probes, combine


def linear_probe_plan(cfg):
    """``cost_probe_plan``'s counterpart past the one-layer edge, as
    (probes, combine).  A step's cost is linear in the depth from two
    layers on, not from one: DTensor gathers a stacked leaf of ONE layer
    without the layout copy every deeper leaf needs (a leading dim of 1
    makes the gathered dim's blocks contiguous), and the hybrid shared
    block's first use skips the gradient sum every further use adds.  So
    these probes hold at least two layers (and the shared block once or
    twice): L2, L3; Lk, Lk+1, L2k (hybrid, every k-th layer, k >= 2);
    E2D2, E3D2, E2D3 (enc-dec)."""

    def mk(**kw):
        return dataclasses.replace(cfg, scan_layers=False, **kw)

    if cfg.family == "hybrid":
        from repro_torch.models.transformer import hybrid_attn_layout
        k = cfg.attn_every
        if k < 2:
            raise ValueError(f"linear_probe_plan: attn_every {k} < 2")
        _, _, n_attn = hybrid_attn_layout(cfg)
        probes = {"Lk": mk(num_layers=k), "Lk+1": mk(num_layers=k + 1),
                  "L2k": mk(num_layers=2 * k)}

        def combine(c):
            bm = c["Lk+1"] - c["Lk"]
            ba = c["L2k"] - c["Lk"] - k * bm
            a = c["Lk"] - k * bm - ba
            return a + cfg.num_layers * bm + n_attn * ba

        return probes, combine

    if cfg.family == "encdec":
        probes = {"E2D2": mk(encoder_layers=2, num_layers=2),
                  "E3D2": mk(encoder_layers=3, num_layers=2),
                  "E2D3": mk(encoder_layers=2, num_layers=3)}

        def combine(c):
            be = c["E3D2"] - c["E2D2"]
            bd = c["E2D3"] - c["E2D2"]
            a = c["E2D2"] - 2 * be - 2 * bd
            return a + cfg.encoder_layers * be + cfg.num_layers * bd

        return probes, combine

    probes = {"L2": mk(num_layers=2), "L3": mk(num_layers=3)}

    def combine(c):
        bm = c["L3"] - c["L2"]
        return c["L2"] - 2 * bm + cfg.num_layers * bm

    return probes, combine


# relative gap within which an extrapolation agrees with the count: the
# counts are integers (wire bytes sums of ring fractions), so this is
# float64 rounding
PROBE_RTOL = 1e-9


def _probe_check(total, extrapolated) -> dict:
    rel = [abs(e - t) / max(abs(t), 1.0)
           for t, e in zip(total, extrapolated)]
    return {"rel_err": dict(zip(("flops", "bytes", "wire"), rel)),
            "agrees": max(rel) <= PROBE_RTOL}


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             out_dir: str = ARTIFACT_DIR, force: bool = False,
             save: bool = True, variant: dict | None = None,
             tag: str = "") -> dict:
    """One cell's record (module docstring), written to
    ``<out_dir>/<cell>.json`` unless ``save`` is false; an existing record
    is returned as it is unless ``force``.  variant: the reference's
    overrides --
      {"cfg": {field: value, ...},            # ModelConfig knobs
       "accum_steps": int, "donate_state": bool,
       "optimizer": "sophia_h", "sophia_kw": {...}}
    """
    import numpy as np

    mesh_tag = "pod2" if multi_pod else "pod1"
    cell = f"{arch}__{shape_name}__{mesh_tag}" + (f"__{tag}" if tag else "")
    path = os.path.join(out_dir, cell + ".json")
    if save:
        os.makedirs(out_dir, exist_ok=True)
        if os.path.exists(path) and not force:
            with open(path) as f:
                return json.load(f)

    variant = variant or {}
    build_kw = {k: variant[k] for k in
                ("accum_steps", "donate_state", "optimizer_name",
                 "sophia_kw") if k in variant}
    if "optimizer" in variant:
        build_kw["optimizer_name"] = variant["optimizer"]

    cfg = get_config(arch)
    if variant.get("cfg"):
        cfg = dataclasses.replace(cfg, **variant["cfg"])
    shape = SHAPES[shape_name]
    ok, why = shape_supported(cfg, shape)
    n_dev = _WORLDS[multi_pod]
    rec = {"cell": cell, "arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "n_devices": n_dev, "variant": dict(variant)}
    if not ok:
        rec.update(status="skipped", reason=why)
        _save(rec, path, save)
        return rec

    try:
        from repro_torch.launch.mesh import make_production_mesh
        with fake_world(n_dev):
            mesh = make_production_mesh(multi_pod=multi_pod)
            full = count_cell(cfg, shape, mesh, **build_kw)
            # probe config -> (vector, seconds); the port never reads
            # scan_layers, so the cell's own config is a probe's too
            counted = {dataclasses.replace(cfg, scan_layers=False): (
                np.array([full["flops"], full["bytes"], full["wire"]]),
                round(full["trace_s"], 2))}

            def probe(plan):
                probes, combine = plan(cfg)
                for pcfg in probes.values():
                    if pcfg not in counted:
                        pc = count_cell(pcfg, shape, mesh, **build_kw)
                        counted[pcfg] = (np.array([
                            pc["flops"], pc["bytes"], pc["wire"]]),
                            round(pc["trace_s"], 2))
                vecs = {t: counted[p][0] for t, p in probes.items()}
                return ({t: v.tolist() for t, v in vecs.items()},
                        {t: counted[p][1] for t, p in probes.items()},
                        [float(x) for x in combine(vecs)])

            probe_costs, probe_times, extrapolated = probe(cost_probe_plan)
            linear_costs, linear_times, linear = probe(linear_probe_plan)
        flops, bytes_, wire = full["flops"], full["bytes"], full["wire"]
        total = (flops, bytes_, wire)
        check = _probe_check(total, linear)
        peak = PEAK_BF16 if cfg.compute_dtype == "bfloat16" else PEAK_FLOPS
        coll = full["collectives"]
        rec.update(
            status="ok", trace_s=round(full["trace_s"], 2),
            flops_per_device=flops, bytes_per_device=bytes_,
            collective_wire_bytes_per_device=wire,
            collective_ops=coll.ops, collective_bytes_by_kind=coll.by_kind,
            collective_details=coll.details,
            probe_costs=probe_costs, probe_trace_s=probe_times,
            probe_extrapolated=extrapolated,
            linear_probe_costs=linear_costs,
            linear_probe_trace_s=linear_times,
            linear_probe_extrapolated=linear,
            probe_check={"agrees": check["agrees"],
                         "linear_probes": check,
                         "reference_probes": _probe_check(total,
                                                          extrapolated)},
            memory=full["memory"],
            roofline=roofline_terms(flops, bytes_, wire, peak_flops=peak),
            roofline_peak_flops=peak,
        )
        # model-FLOPs context (6*N*D for train, 2*N*D prefill and decode)
        n_active = cfg.active_params()
        if shape.kind == "train":
            model_flops = 6 * n_active * shape.global_batch * shape.seq_len
        elif shape.kind == "prefill":
            model_flops = 2 * n_active * shape.global_batch * shape.seq_len
        else:
            model_flops = 2 * n_active * shape.global_batch
        rec["model_flops_total"] = float(model_flops)
        rec["model_flops_per_device"] = float(model_flops) / n_dev
        rec["useful_flop_ratio"] = (rec["model_flops_per_device"]
                                    / flops) if flops else None
    except Exception as e:  # noqa: BLE001 -- record the failure verbatim
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-3000:])
    _save(rec, path, save)
    return rec


def _save(rec, path, save):
    if save:
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)


def _report(rec) -> bool:
    """Print a record's line(s) as the reference does; True on an error."""
    status = rec["status"]
    if status == "ok":
        r = rec["roofline"]
        print(f"[{rec['cell']}] OK bound={r['bound']}"
              f" t=({r['compute_s']:.3e},{r['memory_s']:.3e},"
              f"{r['collective_s']:.3e})s trace={rec['trace_s']}s"
              f" probes agree={rec['probe_check']['agrees']}", flush=True)
        print(f"    memory: {rec['memory']}", flush=True)
    elif status == "skipped":
        print(f"[{rec['cell']}] SKIP ({rec['reason'][:60]})", flush=True)
    else:
        print(f"[{rec['cell']}] ERROR {rec['error'][:200]}", flush=True)
    return status == "error"


# the shapes' cost order, dearest first (attention over 32k tokens)
_COST_ORDER = {"prefill_32k": 0, "train_4k": 1, "decode_32k": 2,
               "long_500k": 3}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="an arch, or several joined by commas")
    ap.add_argument("--shape", default=None,
                    help="a shape, or several joined by commas")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at once, one process each")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(name, shape.name) for name, _, shape, _, _ in all_cells()]
    elif args.arch and args.shape:
        cells = [(a, sh) for a in args.arch.split(",")
                 for sh in args.shape.split(",")]
    else:
        ap.error("--arch/--shape or --all")

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    work = [(arch, shape_name, mp, args.out, args.force)
            for arch, shape_name in cells for mp in meshes]
    if args.jobs > 1:
        import concurrent.futures as cf
        import multiprocessing as mp_
        work.sort(key=lambda w: _COST_ORDER.get(w[1], 0))
        with cf.ProcessPoolExecutor(
                args.jobs, mp_context=mp_.get_context("spawn")) as pool:
            recs = [f.result() for f in cf.as_completed(
                [pool.submit(run_cell, *w) for w in work])]
        recs.sort(key=lambda r: r["cell"])
    else:
        recs = (run_cell(*w) for w in work)
    failures = sum(_report(rec) for rec in recs)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
