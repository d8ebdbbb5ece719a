"""One cell of an hmath-written f, traced into a static graph for
``chess_hvp``'s generated device form.

Counterpart of the trace that ``chess_hvp_pallas`` makes of f when it builds
its body (``repro.kernels.chess_hvp._kernel`` calls ``f(y, *consts)`` on the
dense seeded hDual y): the Pallas kernel is generic over any f written
against ``hmath`` / ``HDual`` ops by trace-time polymorphism, and so is the
``cuda`` backend through this module and ``codegen.py``.

``traced_form(kf, consts, n)`` traces ``kf(HDual(val, di, dj, dij),
*consts)`` for value shape (n,) on real CPU tensors (fake tensors reject
the tensors a closure captures) into a ``torch.fx`` graph of aten ops
(``trace_cell``), and rewrites it into ``codegen.Graph``.  The trace
records every aten op under a ``TorchDispatchMode``: the ops that
``make_fx(..., tracing_mode="real")`` records, with a tensor that f did
not make (a closure's) as a ``get_attr`` node, as make_fx has it; make_fx
itself builds a fake tensor and a stack trace for every node, ~1.3 ms an
op on the CPU (2.4 s for the 547 ops of the CPU tests' all-ops function
at two lane counts), for metadata this module does not read.  Then:

* the chunk axis: the cell is traced at two lane counts (``PROBES``, neither
  equal to n) and a dimension is the chunk axis where its extents are the
  same multiple of the two counts; one that is equal in both is static.  So
  n = C, or a slice of length C, is never misread;
* constants: every node whose value depends on no seed -- ``kernel_consts``,
  a tensor f did not make (a closure's, a ``get_attr`` node), a factory
  (``full``, ``arange``, ``zeros_like`` ...) and what is computed from
  them -- becomes a slice of one float32 constant buffer that the kernel
  reads from device memory (never the source), or, where it depends on no
  tensor from outside f and its elements are all equal, a literal.  The
  slices that ``kernel_consts`` or a captured tensor reach are computed
  again, on the host, from the consts a launch is given and the captured
  tensors' current values whenever one of them is another tensor or was
  written in place (its ``_version``) since (``TracedForm.constants``), as
  the Pallas kernel takes its constants as inputs at every call;
* refusals (``TraceRefused``, a ValueError, with the reason): the trace
  raises (a Python branch or ``float()`` on a value, which JAX's tracer
  refuses too), f does not return an hDual scalar, an op has no lowering
  (``codegen.EW_OPS`` and the views, sums and products below), a value is
  not float32 or bool, or a constant varies along the chunk axis.  Whether
  the form fits the card at a lane count is ``chess_hvp.supports``'s
  question.

The result is cached per (kf, n, the consts' shapes and dtypes, the
objects kf's closure cells and defaults hold) -- by identity, holding them,
as the engine caches plans -- so tracing runs once, on the host, at plan
resolution, never inside a launch, and a closure variable rebound to
another tensor traces anew.  A global name or an object's attribute that
is rebound is not seen (as a jitted JAX function bakes them in): make a
new function.
"""

from __future__ import annotations

import collections
import functools
import inspect
import threading

import numpy as np
import torch

from repro_torch.core.api import chunk_pairs
from repro_torch.core.hdual import HDual

from . import codegen
from .codegen import Dim, Graph, Node

__all__ = ["TraceRefused", "TracedForm", "PROBES", "trace_cell",
           "traced_form", "lower", "clear_forms"]

PROBES = (5, 7, 11, 13)     # lane counts the cell is traced at (two of them)
_CACHE_MAX = 128

# ops whose value depends only on their arguments' shapes
_SHAPE_ONLY = frozenset({"zeros_like", "ones_like", "full_like", "new_zeros",
                         "new_ones", "new_full", "empty_like", "new_empty"})
# ops that pass their argument through
_IDENTITY = frozenset({"alias", "clone", "detach", "lift_fresh_copy",
                       "contiguous"})
_UNARY = {"neg", "sin", "cos", "tan", "exp", "log", "sqrt", "rsqrt", "tanh",
          "sigmoid", "abs", "sign", "asin", "acos", "atan", "sinh", "cosh",
          "erf", "log1p", "expm1", "reciprocal", "logical_not", "square"}
_BINARY = {"mul", "div", "pow", "maximum", "minimum", "lt", "le", "gt", "ge",
           "eq", "ne", "logical_and", "logical_or"}
_RENAME = {"sgn": "sign", "special_erf": "erf", "true_divide": "div",
           "multiply": "mul", "subtract": "sub", "negative": "neg"}


class TraceRefused(ValueError):
    """f has no generated device form; the message says why."""


class TracedForm:
    """The generated device form of one (f, n): the graph, its lowering
    and source, its constants and its costs, with the interface
    ``kernels/chess_hvp.py`` reads of every device form (its ``HandForm``
    of a hand-written one): ``rows``/``scalars`` of the shared slot of an
    instance (a, v, out and the values the instance pass stores,
    ``codegen.Lowering``), ``code`` and ``grouped`` (the C entry's form and
    lane groups, which a generated form has not), ``n`` (the one it
    serves), ``refusal``, the counts, the launch ``arguments`` and the
    ``launcher``.  ``program`` computes the buffer's ``slots`` (offset,
    size) that ``kernel_consts`` or the ``captured`` tensors reach, from
    the seeds of the trace (``seeds``, whose shapes factories read) and the
    consts."""

    code, grouped, traced = 0, False, True
    entry = None        # its C entry, once loaded (``launcher``)

    def __init__(self, graph: Graph, name: str, program=None, slots=(),
                 seeds=(), captured=()):
        self.graph = graph
        self.n = graph.n
        self.name = name
        self.program, self.slots = program, tuple(slots)
        self.seeds, self.captured = tuple(seeds), tuple(captured)
        self.lowering = codegen.lowering(graph)
        self.rows, self.scalars = self.lowering.rows, self.lowering.scalars
        self._source = None
        self._buffers: dict = {}
        self._lock = threading.Lock()

    def __repr__(self):
        return f"TracedForm({self.name}, n={self.n})"

    @property
    def source(self) -> str:
        if self._source is None:
            self._source = codegen.source(self.graph)
        return self._source

    def local_bytes(self, lanes: int) -> int:
        return 4 * codegen.local_floats(self.graph, lanes)

    def refusal(self, n: int, lanes: int):
        """Why the form cannot take n at ``lanes`` besides shared memory:
        another n, or local arrays past ``codegen.LOCAL_MAX``; or None."""
        if n != self.n:
            return f"the traced form of {self.name} serves n={self.n} only"
        if self.local_bytes(lanes) > codegen.LOCAL_MAX:
            return (f"the traced form of {self.name} at n={self.n} needs "
                    f"{self.local_bytes(lanes)} bytes of local memory a "
                    f"thread at {lanes} lanes, past the kernel's "
                    f"{codegen.LOCAL_MAX}")
        return None

    def _cells(self, n: int, csize: int, symmetric: bool):
        """(rows, starts, widths) of the sub-cells the kernel runs: chunks
        wider than ``codegen.LANES[-1]`` split, columns past n left out."""
        step = codegen.LANES[-1]
        pairs = chunk_pairs(n, csize, symmetric)
        parts = []
        for off in range(0, csize, step):
            starts = pairs[:, 1] + off
            keep = starts < n
            parts.append((pairs[keep, 0], starts[keep], np.minimum(
                min(step, csize - off), n - starts[keep])))
        return tuple(np.concatenate(a) for a in zip(*parts))

    def cell_counts(self, n: int, csize: int, symmetric: bool):
        """The operations of each sub-cell the kernel runs at csize (the
        lane instantiation ``lanes_for(csize)``): its ``eval``'s
        (``codegen.cell_operations``) and 3 a column for its scatter."""
        rows, starts, widths = self._cells(n, csize, symmetric)
        return (codegen.cell_operations(self.graph, codegen.lanes_for(csize),
                                        rows, starts, widths) + 3 * widths)

    def cell_operations(self, n: int, lanes: int) -> int:
        """The most operations one cell of the form's code runs at
        ``lanes`` lanes (its scatter included), over the full schedule."""
        return int(self.cell_counts(n, lanes, False).max())

    def operations(self, m: int, n: int, csize: int, symmetric: bool) -> int:
        """The count of a launch as the form's code runs it: every
        sub-cell's, and the instance pass once an instance."""
        return m * (int(self.cell_counts(n, csize, symmetric).sum())
                    + codegen.instance_operations(self.graph))

    def needed_operations(self, m: int, n: int, csize: int,
                          symmetric: bool) -> int:
        """The count of a launch that the seeds' structural zeros leave
        (``codegen.needed_operations``, each sub-cell at its lanes), with
        3 a column for the cell's scatter, as the hand-written forms'."""
        rows, starts, widths = self._cells(n, csize, symmetric)
        cells = once = 0
        for C in sorted(set(widths.tolist())):      # no padding lanes
            at = widths == C
            c, o = codegen.needed_operations(self.graph, rows[at], starts[at],
                                             widths[at], C)
            cells, once = cells + c, max(once, o)
        return m * (cells + once + 3 * int(widths.sum()))

    def const_floats(self, n: int) -> int:
        return int(self.graph.consts.size)

    def arguments(self, consts, device, n: int) -> list:
        """The launch's constant tensors: the buffer, read at this launch."""
        return [self.constants(consts, device), None, None]

    def launcher(self):
        """The C entry of the form's library, built at its first launch
        (under ``build.LOCK``; a failed build raises with nvcc's log)."""
        if self.entry is None:
            import ctypes
            from . import build
            with build.LOCK:
                if self.entry is None:
                    fn = build.load_generated(self.source).chess_hvp_traced_launch
                    p, i = ctypes.c_void_p, ctypes.c_int
                    fn.argtypes = [p, p, p, i, p, p, i, i, i, i, i, i, i, i,
                                   i, i, ctypes.c_longlong, p, p, p, p]
                    fn.restype = ctypes.c_int
                    self.entry = fn
        return self.entry

    def host_constants(self, consts=()) -> np.ndarray:
        """The float32 constant buffer for these kernel_consts and the
        captured tensors' current values (one element at least, so that
        its pointer is valid)."""
        host = self.graph.consts.copy()
        if self.slots:
            with torch.no_grad():
                outs = self.program(*self.seeds, *(
                    c.detach().to("cpu") for c in consts))
            for (off, size), t in zip(self.slots, outs):
                host[off:off + size] = t.detach().to(
                    "cpu", torch.float32).reshape(-1).numpy()
        return host if host.size else np.zeros(1, np.float32)

    def constants(self, consts, device) -> torch.Tensor:
        """The constant buffer on ``device`` (``host_constants``), made
        again whenever a const or a captured tensor is another tensor or
        was written in place since the last one; an inference tensor, which
        keeps no version, makes it again at every call."""
        device = torch.device(device)
        consts = tuple(consts)
        key = tuple((id(t), t._version) if not t.is_inference() else object()
                    for t in (*consts, *self.captured))
        with self._lock:
            hit = self._buffers.get(device)
            if hit is None or hit[0] != key:
                buf = torch.from_numpy(self.host_constants(consts)).to(device)
                # the entry holds the consts, so their ids stay theirs
                hit = self._buffers[device] = (key, buf, consts)
        return hit[1]


def _cell(kf):
    def cell(val, di, dj, dij, *consts):
        r = kf(HDual(val, di, dj, dij), *consts)
        if not isinstance(r, HDual):
            raise TypeError(f"f returned {type(r).__name__}, not an hDual; "
                            f"write it against repro_torch.core.hmath")
        return r.val, r.di, r.dj, r.dij
    return cell


def _inputs(n: int, lanes: int):
    rng = np.random.RandomState(n * 131 + lanes)
    val = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32))
    k = torch.arange(n)
    di = (k == 0).float()
    dj = (k[:, None] == torch.arange(lanes)[None, :]).float()
    return val, di, dj, torch.zeros(n, lanes)


class _DataDependent(RuntimeError):
    pass


def _record(fn, args):
    """Run fn(*args) on real tensors under a dispatch mode that records
    every aten call: [(op, args, kwargs, out)] and fn's outputs.  Reading a
    tensor's value on the host (``_local_scalar_dense``: a Python branch,
    ``float()``, ``.item()``) or writing one in place raises."""
    from torch.utils._python_dispatch import TorchDispatchMode
    calls = []

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is torch.ops.aten._local_scalar_dense.default:
                raise _DataDependent(
                    "f reads a traced value on the host (a Python branch, "
                    "float() or .item() on a value)")
            if func._schema.is_mutable:
                raise _DataDependent(f"f writes a tensor in place ({func})")
            out = func(*args, **kwargs)
            calls.append((func, args, kwargs, out))
            return out

    with torch.no_grad(), Recorder():
        outs = fn(*args)
    return calls, outs


def trace_cell(kf, consts, n: int, lanes: int):
    """The aten graph (a ``GraphModule`` taking val, di, dj, dij and the
    constants, returning the result's four components) of one cell of
    ``kf`` at value shape (n,) and ``lanes`` chunk lanes; raises
    TraceRefused where the trace raises."""
    import operator
    inputs = (*_inputs(n, lanes), *consts)
    try:
        calls, outs = _record(_cell(kf), inputs)
    except Exception as e:    # f is user code: any failure is a refusal
        msg = str(e).strip().splitlines()[0][:300] if str(e).strip() else ""
        raise TraceRefused(f"tracing f raised {type(e).__name__}: {msg} (a "
                           f"Python branch or float() on a value does not "
                           f"trace)") from None
    root = torch.nn.Module()
    g = torch.fx.Graph()
    env: dict = {}           # id(tensor) -> fx node
    keep = []                # every tensor named in env stays alive
    names = ("val", "di", "dj", "dij")
    for k, t in enumerate(inputs):
        env[id(t)] = g.placeholder(names[k] if k < 4 else f"const{k - 4}")
        keep.append(t)

    def node_of(a):
        if isinstance(a, torch.Tensor):
            if id(a) not in env:          # made outside f: a constant
                name = f"_tensor_constant{len(keep)}"
                root.register_buffer(name, a)
                env[id(a)] = g.get_attr(name)
                keep.append(a)
            return env[id(a)]
        if isinstance(a, (list, tuple)):
            return type(a)(node_of(b) for b in a)
        return a

    for func, args, kwargs, out in calls:
        node = g.call_function(func, node_of(args),
                               {k: node_of(v) for k, v in kwargs.items()})
        if isinstance(out, torch.Tensor):
            env[id(out)] = node
            keep.append(out)
        elif isinstance(out, (list, tuple)):
            for j, t in enumerate(out):
                if isinstance(t, torch.Tensor):
                    env[id(t)] = g.call_function(operator.getitem, (node, j))
                    keep.append(t)
    g.output(tuple(node_of(t) for t in outs))
    return torch.fx.GraphModule(root, g)


def _run(gm, args) -> dict:
    """Each fx node's value on args."""
    vals: dict = {}

    class Rec(torch.fx.Interpreter):
        def run_node(self, node):
            out = super().run_node(node)
            vals[node] = out
            return out

    with torch.no_grad():
        Rec(gm).run(*args)
    return vals


class _Lower:
    """The aten graph of two probe traces -> ``codegen.Graph``."""

    def __init__(self, n: int, probes):
        self.n = n
        self.L1, self.L2 = probes
        self.nodes: list = []
        self.interned: dict = {}
        self.consts: list = []
        self.nconst = 0
        self.slots: list = []    # (fx node, offset, size) outside tensors reach

    # -- graph building ----------------------------------------------------
    def add(self, node: Node) -> Node:
        key = (node.kind, node.op, node.shape, node.dtype,
               tuple(("n", a.id) if isinstance(a, Node) else ("s", a)
                     for a in node.args),
               node.value if node.kind == "scalar" else None,
               node.offset if node.kind == "const" else None,
               node.spec, node.dims)
        hit = self.interned.get(key)
        if hit is not None:
            return hit
        node.id = len(self.nodes)
        self.nodes.append(node)
        self.interned[key] = node
        return node

    def sym(self, s1, s2) -> tuple:
        if len(s1) != len(s2):
            raise TraceRefused(f"the two probe traces disagree on a rank "
                               f"({tuple(s1)} vs {tuple(s2)})")
        dims = []
        for d1, d2 in zip(s1, s2):
            if d1 == d2:
                dims.append(Dim(0, int(d1)))
            elif (d1 % self.L1 == 0 and d2 % self.L2 == 0
                  and d1 // self.L1 == d2 // self.L2):
                dims.append(Dim(d1 // self.L1, 0))
            else:
                raise TraceRefused(
                    f"a shape {tuple(s1)} / {tuple(s2)} at lanes {self.L1} / "
                    f"{self.L2} depends on the chunk width other than as a "
                    f"multiple of it")
        if sum(d.chunk for d in dims) > 1:
            raise TraceRefused(f"a value {tuple(s1)} has more than one chunk "
                               f"axis")
        return tuple(dims)

    @staticmethod
    def dtype(v) -> str:
        if v.dtype == torch.float32:
            return "f"
        if v.dtype == torch.bool:
            return "b"
        raise TraceRefused(f"f computes a value in {v.dtype}; the generated "
                           f"form takes float32 and bool")

    def fold(self, v1, v2, shape, source=None) -> Node:
        """A value that depends on no seed: a literal where its elements are
        all equal (in both traces) and no tensor from outside f reaches it,
        else a slice of the constant buffer.  ``source``: the fx node of a
        value that such a tensor reaches, whose slice is one of ``slots``,
        computed again from it at launch."""
        flat1, flat2 = v1.reshape(-1), v2.reshape(-1)
        dt = "b" if v1.dtype == torch.bool else "f"
        if source is None and flat1.numel() and bool(
                (flat1 == flat1[0]).all()) and bool((flat2 == flat1[0]).all()):
            x = flat1[0].item()
            return self.add(Node("scalar", shape, dt, value=bool(x) if dt ==
                                 "b" else float(x)))
        if any(d.chunk for d in shape):
            what = "varies" if source is None else "from outside f is laid"
            raise TraceRefused(f"a constant of shape {tuple(v1.shape)} {what} "
                               f"along the chunk axis")
        arr = v1.detach().to("cpu", torch.float32).numpy().reshape(-1).copy()
        node = self.add(Node("const", shape, dt, offset=self.nconst))
        if source is not None:
            self.slots.append((source, self.nconst, arr.size))
        self.consts.append(arr)
        self.nconst += arr.size
        return node

    def ew(self, op, args, shape, dtype) -> Node:
        if op not in codegen.EW_OPS:
            raise TraceRefused(f"no lowering for the elementwise op {op!r}")
        ins = tuple(self.expand(a, shape) if isinstance(a, Node) else a
                    for a in args)
        return self.add(Node("ew", shape, dtype, op=op, args=ins))

    def view(self, src: Node, spec, shape) -> Node:
        if shape == src.shape and spec[0] in ("reshape", "expand"):
            return src
        return self.add(Node("view", shape, src.dtype, args=(src,),
                             spec=spec))

    def expand(self, src: Node, shape) -> Node:
        if src.shape == shape:
            return src
        if len(src.shape) > len(shape):
            raise TraceRefused("a broadcast to fewer dims")
        return self.view(src, ("expand",), shape)

    # -- one aten node -------------------------------------------------------
    def call(self, target, args, kwargs, shape, v1) -> Node:
        name = str(target)
        parts = name.split(".")
        if parts[0] != "aten" or len(parts) < 2:
            raise TraceRefused(f"no lowering for {name}")
        op = _RENAME.get(parts[1], parts[1])
        ov = parts[2] if len(parts) > 2 else "default"
        dtype = self.dtype(v1)
        x = args[0] if args else None

        if op in _IDENTITY:
            return x
        if op == "_to_copy":
            if x.dtype == dtype:
                return x
            return self.ew("to_float" if dtype == "f" else "to_bool", (x,),
                           shape, dtype)
        if op in ("add", "sub", "rsub"):
            a, b = args[0], args[1]
            alpha = kwargs.get("alpha", args[2] if len(args) > 2 else 1)
            if op == "rsub":
                a, b = b, a
                op = "sub"
                if alpha != 1:
                    b = (self.ew("mul", (b, alpha), b.shape, "f")
                         if isinstance(b, Node) else b * alpha)
            elif alpha != 1:
                b = (self.ew("mul", (b, alpha), b.shape, "f")
                     if isinstance(b, Node) else b * alpha)
            return self.ew(op, (a, b), shape, dtype)
        if op in _UNARY and len(args) == 1:
            return self.ew(op, (x,), shape, dtype)
        if op in _BINARY and len(args) == 2 and not kwargs:
            return self.ew(op, tuple(args), shape, dtype)
        if op == "where" and len(args) == 3:
            return self.ew("where", tuple(args), shape, dtype)
        if op in ("unsqueeze", "squeeze", "view", "_unsafe_view", "reshape",
                  "permute", "t", "transpose", "expand", "select", "slice",
                  "numpy_T"):
            return self.view_op(op, ov, x, args[1:], kwargs, shape)
        if op in ("sum", "mean"):
            return self.reduce(op, x, args[1:], kwargs, shape, dtype)
        if op == "mm":
            return self.add(Node("mm", shape, dtype, args=tuple(args)))
        if op in ("mv", "dot"):
            A, b = args
            if op == "dot":
                A = self.view(A, ("reshape",), (Dim(0, 1),) + A.shape)
            col = self.view(b, ("reshape",), b.shape + (Dim(0, 1),))
            out = self.add(Node("mm", (A.shape[0], Dim(0, 1)), dtype,
                                args=(A, col)))
            return self.view(out, ("reshape",), shape)
        raise TraceRefused(f"no lowering for {name}")

    def view_op(self, op, ov, x, rest, kwargs, shape) -> Node:
        rank = len(x.shape)
        if op == "unsqueeze":
            return self.view(x, ("unsqueeze", rest[0] % (rank + 1)), shape)
        if op == "squeeze":
            if ov == "default":
                dims = range(rank)
            else:
                d = rest[0]
                dims = d if isinstance(d, (list, tuple)) else [d]
            gone = tuple(sorted(d % rank for d in dims
                                if x.shape[d % rank] == Dim(0, 1)))
            return self.view(x, ("squeeze", gone), shape) if gone else x
        if op in ("view", "_unsafe_view", "reshape"):
            return self.view(x, ("reshape",), shape)
        if op == "expand":
            return self.expand(x, shape)
        if op in ("permute", "t", "transpose", "numpy_T"):
            if op == "permute":
                perm = [p % rank for p in rest[0]]
            elif op == "transpose":
                perm = list(range(rank))
                a, b = rest[0] % rank, rest[1] % rank
                perm[a], perm[b] = perm[b], perm[a]
            else:
                perm = list(reversed(range(rank)))
            if perm == list(range(rank)):
                return x
            return self.view(x, ("permute", tuple(perm)), shape)
        if op == "select":
            d, i = rest[0] % rank, rest[1]
            if x.shape[d].chunk:
                raise TraceRefused("a select along the chunk axis")
            return self.view(x, ("select", d, i % x.shape[d].b), shape)
        # slice.Tensor(x, dim=0, start=None, end=None, step=1)
        d = (rest[0] if len(rest) > 0 else kwargs.get("dim", 0)) % rank
        start = rest[1] if len(rest) > 1 else kwargs.get("start")
        step = rest[3] if len(rest) > 3 else kwargs.get("step", 1)
        if shape == x.shape and (start in (None, 0)) and step == 1:
            return x
        if x.shape[d].chunk:
            raise TraceRefused("a slice of the chunk axis")
        size = x.shape[d].b
        start = 0 if start is None else (start + size if start < 0
                                         else start)
        start = max(0, min(start, size))
        return self.view(x, ("slice", d, start, step), shape)

    def reduce(self, op, x, rest, kwargs, shape, dtype) -> Node:
        rank = len(x.shape)
        dims = rest[0] if rest else kwargs.get("dim")
        if dims is None or (isinstance(dims, (list, tuple)) and not dims):
            dims = list(range(rank))
        elif not isinstance(dims, (list, tuple)):
            dims = [dims]
        dims = tuple(sorted({d % rank for d in dims}))
        out_shape = tuple(s for j, s in enumerate(x.shape) if j not in dims)
        node = self.add(Node("sum", out_shape, dtype, args=(x,), dims=dims))
        if op == "mean":
            count = 1
            for d in dims:
                if x.shape[d].chunk:
                    raise TraceRefused("a mean over the chunk axis")
                count *= x.shape[d].b
            node = self.ew("mul", (node, 1.0 / count), out_shape, dtype)
        return self.view(node, ("reshape",), shape)

    # -- the whole graph ----------------------------------------------------
    def run(self, gm1, gm2, args1, args2) -> Graph:
        vals1, vals2 = _run(gm1, args1), _run(gm2, args2)
        fx1, fx2 = list(gm1.graph.nodes), list(gm2.graph.nodes)
        if len(fx1) != len(fx2) or any((a.op, a.target) != (b.op, b.target)
                                       for a, b in zip(fx1, fx2)):
            raise TraceRefused("the traces at two chunk widths differ in "
                               "their ops (f depends on the chunk width)")
        env: dict = {}         # fx node -> Node
        const_only: set = set()
        outside: set = set()   # const-only nodes kernel_consts or a captured
        #                        tensor reach
        folded: dict = {}      # a const-only computation -> its folded Node
        keys: dict = {}

        def key(a):
            """A const-only fx node's computation (its op and operands'
            keys): two nodes with one key hold one value at every launch,
            and share a slice (each mm of Fletcher-Powell reads the matrix
            through its own identity permute).  A random op (tagged
            ``nondeterministic_seeded``: rand, normal, bernoulli, dropout,
            ...) is its own: two draws are two values."""
            if a not in keys:
                def k(x):
                    if isinstance(x, torch.fx.Node):
                        return key(x)
                    if isinstance(x, (list, tuple)):
                        return tuple(k(y) for y in x)
                    return repr(x)
                if a.op in ("placeholder", "get_attr"):
                    keys[a] = (a.op, a.target)
                elif (torch.Tag.nondeterministic_seeded
                      in getattr(a.target, "tags", ())):
                    keys[a] = ("node", a.name)
                else:
                    keys[a] = (str(a.target), k(a.args), tuple(sorted(
                        (name, k(v)) for name, v in a.kwargs.items())))
            return keys[a]
        twin = dict(zip(fx1, fx2))
        seeds = ("val", "di", "dj", "dij")
        k = 0
        out = None
        for node in fx1:
            if node.op == "placeholder":
                if k < 4:
                    v = vals1[node]
                    env[node] = self.add(Node(
                        "in", self.sym(v.shape, vals2[twin[node]].shape),
                        op=seeds[k]))
                else:
                    const_only.add(node)
                    outside.add(node)
                k += 1
                continue
            if node.op == "get_attr":
                const_only.add(node)
                outside.add(node)
                continue
            if node.op == "output":
                out = node.args[0]
                continue
            if node.op != "call_function":
                raise TraceRefused(f"no lowering for a {node.op} node")
            name = str(node.target).split(".")
            deps = [a for a in node.all_input_nodes]
            shape_only = len(name) > 1 and name[1] in _SHAPE_ONLY
            if shape_only or all(a in const_only for a in deps):
                const_only.add(node)
                if not shape_only and any(a in outside for a in deps):
                    outside.add(node)
                continue
            v1, v2 = vals1[node], vals2[twin[node]]
            if not isinstance(v1, torch.Tensor):
                raise TraceRefused(f"no lowering for {node.target} (it "
                                   f"returns {type(v1).__name__})")
            shape = self.sym(v1.shape, v2.shape)

            def arg(a):
                if isinstance(a, torch.fx.Node):
                    if a in const_only:
                        b = vals1[a]
                        if not isinstance(b, torch.Tensor):
                            return b
                        if key(a) not in folded:
                            folded[key(a)] = self.fold(
                                b, vals2[twin[a]], self.sym(
                                    b.shape, vals2[twin[a]].shape),
                                a if a in outside else None)
                        return folded[key(a)]
                    return env[a]
                if isinstance(a, (list, tuple)):
                    return type(a)(arg(b) for b in a)
                return a

            args = tuple(arg(a) for a in node.args)
            kwargs = {key: arg(a) for key, a in node.kwargs.items()}
            env[node] = self.call(node.target, args, kwargs, shape, v1)
        dij = out[3]
        if dij in const_only:
            v = vals1[dij]
            res = self.fold(v, vals2[twin[dij]],
                            self.sym(v.shape, vals2[twin[dij]].shape),
                            dij if dij in outside else None)
        else:
            res = env[dij]
        if res.shape != (Dim(1, 0),):
            raise TraceRefused(f"f returns an hDual of value shape "
                               f"{tuple(vals1[out[0]].shape)}, not a scalar")
        if res.kind != "ew" and res.kind not in ("sum", "mm"):
            res = self.ew("add", (res, 0.0), res.shape, res.dtype)
        consts = (np.concatenate(self.consts) if self.consts
                  else np.zeros(0, np.float32)).astype(np.float32)
        return Graph(self.nodes, res, consts, self.n)

    def program(self, gm):
        """The part of gm (a probe trace) that computes the ``slots``' values
        from its inputs: a GraphModule returning them, or None."""
        if not self.slots:
            return None
        g = torch.fx.Graph()
        env: dict = {}
        for node in gm.graph.nodes:
            if node.op != "output":
                env[node] = g.node_copy(node, lambda a: env[a])
        g.output(tuple(env[src] for src, _, _ in self.slots))
        g.eliminate_dead_code()
        return torch.fx.GraphModule(gm, g)


def lower(kf, consts, n: int) -> TracedForm:
    """The generated form of one cell of kf at n, uncached (see the module
    note); raises TraceRefused."""
    consts = tuple(c.detach().to("cpu") if isinstance(c, torch.Tensor) else c
                   for c in consts)
    probes = [p for p in PROBES if p != n][:2]
    gms = [trace_cell(kf, consts, n, p) for p in probes]
    args = [(*_inputs(n, p), *consts) for p in probes]
    low = _Lower(n, probes)
    graph = low.run(gms[0], gms[1], args[0], args[1])
    program = low.program(gms[0])
    captured = () if program is None else tuple(
        getattr(program, nd.target) for nd in program.graph.nodes
        if nd.op == "get_attr")
    return TracedForm(graph, getattr(kf, "__qualname__", repr(kf)), program,
                      [(off, size) for _, off, size in low.slots],
                      args[0][:4], captured)


def _bindings(f, depth: int = 0) -> tuple:
    """The objects f reads that a caller can rebind without making a new
    function: its closure cells' contents and its defaults, through the
    functions among them (a partial's function and arguments, a method's
    function and instance)."""
    if depth > 4:
        return ()
    if isinstance(f, functools.partial):
        parts = (f.func, *f.args, *f.keywords.values())
    elif inspect.ismethod(f):
        parts = (f.__func__, f.__self__)
    elif inspect.isfunction(f):
        parts = (*(c.cell_contents for c in f.__closure__ or ()
                   if _filled(c)), *(f.__defaults__ or ()),
                 *(f.__kwdefaults__ or {}).values())
    else:
        return ()
    out = []
    for p in parts:
        out.append(p)
        out.extend(_bindings(p, depth + 1))
    return tuple(out)


def _filled(cell) -> bool:
    try:
        cell.cell_contents
    except ValueError:          # a cell not yet bound
        return False
    return True


_FORMS: collections.OrderedDict = collections.OrderedDict()
_FORMS_LOCK = threading.RLock()


def traced_form(kf, consts=(), n: int = 0) -> TracedForm:
    """The generated device form of kf (for constants of these shapes) at
    n, traced once and cached by identity (see the module note); raises
    TraceRefused with the reason."""
    consts = tuple(consts)
    bound = _bindings(kf)
    key = (id(kf), int(n), tuple(
        (tuple(c.shape), c.dtype) if isinstance(c, torch.Tensor) else repr(c)
        for c in consts), tuple(map(id, bound)))
    with _FORMS_LOCK:
        hit = _FORMS.get(key)
        if hit is None:
            try:
                form = lower(kf, consts, int(n))
            except TraceRefused as e:
                form = e
            # the entry holds kf and its bindings, so their ids stay theirs
            hit = _FORMS[key] = (kf, bound, form)
            while len(_FORMS) > _CACHE_MAX:
                _FORMS.popitem(last=False)
        _FORMS.move_to_end(key)
    form = hit[2]
    if isinstance(form, TraceRefused):
        raise TraceRefused(str(form))
    return form


def clear_forms() -> None:
    """Drop every cached form (and what it holds: its constant buffers, its
    f); a library already loaded stays loaded, and the next
    ``traced_form`` of an (f, n) traces anew."""
    with _FORMS_LOCK:
        _FORMS.clear()
