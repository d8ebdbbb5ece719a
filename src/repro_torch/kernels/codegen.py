"""A traced cell of f as a CUDA C++ device form of ``chess_hvp``.

``kernels/trace.py`` traces one cell of a kernel form ``kf(y, *consts)`` --
a dense hDual vector y over all n variables, as the Pallas body seeds it --
into a static aten graph, and rewrites it into the small graph of this
module (``Node``): the four seeded inputs (val, di, dj, dij), folded
constants, elementwise maps, views, ``sum`` reductions and ``mm``.  Every
shape is static except the hDual chunk axis, whose extent is the lane count
C (a dimension ``Dim(a, 0)`` is a*C; ``Dim(0, b)`` is b).  ``source`` emits
the graph as one translation unit: a struct ``Traced`` with the interface
of the hand-written forms of ``csrc/chess_hvp.cu`` (``table``, ``instance``,
``eval<C>``, and ``cells``, its cell loop), so that the kernel template of
``csrc/chess_hvp.cuh`` runs it -- its seeding, sub-cells, scatter and mirror,
dtype conversion, instances per CTA and shared output row -- and an
``extern "C"`` entry per route: ``chess_hvp_traced_launch`` under nvcc,
``chess_hvp_traced_host`` (every cell on the host) under a host compiler.

The lowering.  Elementwise chains are fused into the loop that consumes
them; a reduction (``sum``, ``mm``) is a loop nest of its own whose body is
its fused producers, with the static dimensions outside and the chunk
dimension innermost (unrolled at C lanes), so that a primal-only term
(val or di of a coordinate) is computed once per coordinate and not once per
lane: every temporary is hoisted to the outermost loop whose variables it
reads.  A node is materialized, as a local array, only where it is a
reduction's result or where more than one loop reads it.  The hmath maps
arrive as their g, dg and d2g, spelled by the aten graph, and are emitted as
IEEE float32 functions (``sinf``, ``expf``, ...): no fast-math intrinsic.
The evaluation is dense, as the Pallas body's: every lane of every
coordinate's hDual (the hand-written forms carry hDuals only for a cell's
active coordinates).

``cell_operations`` counts the graph's dense operations for one cell: one
per output element of an elementwise node, the input elements of a sum,
2 r k cols of an mm.  ``local_floats`` is the floats the materialized nodes
hold per thread.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Dim", "Node", "Graph", "EW_OPS", "source", "cell_operations",
           "local_floats", "lanes_that_fit", "extent", "numel", "LANES",
           "LOCAL_MAX", "needed_operations"]

LANES = (1, 2, 4, 8, 16, 32, 64)   # the kernel's hDual<C> instantiations
# local memory a thread of a generated form may hold (its materialized
# values): what the CPU tests' all-ops function needs at 8 lanes (30,544
# bytes).  The driver sizes local memory for every thread the card can
# hold, 2,048 on each of 132 SMs, and keeps it for the process's life: a
# 32 KB form takes up to 8.9 GB of 80 (chip_smoke.py phase 18 reads it)
LOCAL_MAX = 32768


@dataclass(frozen=True)
class Dim:
    """A dimension's extent a*C + b, with a or b zero: C is the lane count."""
    a: int
    b: int

    def at(self, C: int) -> int:
        return self.a * C + self.b

    @property
    def chunk(self) -> bool:
        return self.a > 0

    def code(self) -> str:
        if self.a == 0:
            return str(self.b)
        return "C" if self.a == 1 else f"({self.a} * C)"


def extent(shape) -> tuple:
    """(static factor, chunk dims) of a shape's element count."""
    s, k = 1, 0
    for d in shape:
        if d.chunk:
            s, k = s * d.a, k + 1
        else:
            s *= d.b
    return s, k


def numel(shape, C: int) -> int:
    return math.prod(d.at(C) for d in shape)


@dataclass(eq=False)
class Node:
    """One value of the traced cell.

    kind  ``in`` (op: val, di, dj or dij), ``scalar`` (value, broadcast to
          shape), ``const`` (offset into the constant buffer, row-major),
          ``ew`` (op of ``EW_OPS`` on args: Nodes of the same shape or
          Python numbers), ``view`` (spec, args[0]: the source), ``sum``
          (dims reduced, args[0]), ``mm`` (args: (r, k) and (k, cols))
    dtype ``f`` (float32) or ``b`` (bool)
    """
    kind: str
    shape: tuple
    dtype: str = "f"
    op: str = ""
    args: tuple = ()
    value: float = 0.0
    offset: int = 0
    spec: tuple = ()
    dims: tuple = ()
    id: int = field(default=-1)


@dataclass
class Graph:
    """The traced cell: its nodes in topological order, the dij output
    (shape (C,)), the float32 constant buffer, and n."""
    nodes: list
    out: Node
    consts: np.ndarray
    n: int


# ---------------------------------------------------------------------------
# elementwise ops: name -> (arity, C++ template over the operands' code)
# ---------------------------------------------------------------------------

EW_OPS = {
    "add": (2, "({0} + {1})"), "sub": (2, "({0} - {1})"),
    "mul": (2, "({0} * {1})"), "div": (2, "({0} / {1})"),
    "neg": (1, "(-{0})"), "reciprocal": (1, "(1.f / {0})"),
    "sin": (1, "sinf({0})"), "cos": (1, "cosf({0})"),
    "tan": (1, "tanf({0})"), "exp": (1, "expf({0})"),
    "log": (1, "logf({0})"), "sqrt": (1, "sqrtf({0})"),
    "rsqrt": (1, "(1.f / sqrtf({0}))"), "tanh": (1, "tanhf({0})"),
    "sigmoid": (1, "(1.f / (1.f + expf(-{0})))"),
    "abs": (1, "fabsf({0})"),
    "sign": (1, "(({0} > 0.f) ? 1.f : (({0} < 0.f) ? -1.f : 0.f))"),
    "asin": (1, "asinf({0})"), "acos": (1, "acosf({0})"),
    "atan": (1, "atanf({0})"), "sinh": (1, "sinhf({0})"),
    "cosh": (1, "coshf({0})"), "erf": (1, "erff({0})"),
    "log1p": (1, "log1pf({0})"), "expm1": (1, "expm1f({0})"),
    "pow": (2, "powf({0}, {1})"), "square": (1, "({0} * {0})"),
    "maximum": (2, "fmaxf({0}, {1})"), "minimum": (2, "fminf({0}, {1})"),
    "where": (3, "({0} ? {1} : {2})"),
    "lt": (2, "({0} < {1})"), "le": (2, "({0} <= {1})"),
    "gt": (2, "({0} > {1})"), "ge": (2, "({0} >= {1})"),
    "eq": (2, "({0} == {1})"), "ne": (2, "({0} != {1})"),
    "logical_not": (1, "(!{0})"), "logical_and": (2, "({0} && {1})"),
    "logical_or": (2, "({0} || {1})"),
    "to_float": (1, "({0} ? 1.f : 0.f)"), "to_bool": (1, "({0} != 0.f)"),
}


def literal(x, dtype: str = "f") -> str:
    """A Python number as a C++ literal: float32-rounded, or a bool."""
    if dtype == "b":
        return "true" if x else "false"
    v = float(np.float32(x))
    if math.isnan(v):
        return "NAN"
    if math.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    return repr(v) + "f"


# ---------------------------------------------------------------------------
# the dense operation count and local memory of a graph
# ---------------------------------------------------------------------------

def live(graph: Graph) -> list:
    """The nodes the dij output reads, in topological order."""
    need = {graph.out.id}
    for node in reversed(graph.nodes):
        if node.id in need:
            need.update(a.id for a in node.args if isinstance(a, Node))
    return [nd for nd in graph.nodes if nd.id in need]


def cell_operations(graph: Graph, C: int) -> int:
    """fp32 operations of one cell at C lanes, counted from the graph:
    an elementwise node one per output element, a sum its input elements,
    an mm 2 r k cols.  Views, seeds and constants cost nothing."""
    ops = 0
    for node in live(graph):
        if node.kind == "ew":
            ops += numel(node.shape, C)
        elif node.kind == "sum":
            ops += numel(node.args[0].shape, C)
        elif node.kind == "mm":
            a, b = node.args
            ops += 2 * numel(a.shape, C) * b.shape[1].at(C)
    return ops


# maps with g(0) = 0: an element that is a structural zero stays one
_KEEPS_ZERO = frozenset({"neg", "sin", "tan", "sqrt", "tanh", "abs", "sign",
                         "asin", "atan", "sinh", "erf", "log1p", "expm1",
                         "square", "to_float", "to_bool"})


def _nonzero(op: str, args):
    """Where an elementwise node may be nonzero, from where its operands
    may be (boolean arrays; a Python number is its own)."""
    a = args[0]
    if op in ("add", "sub", "maximum", "minimum", "logical_or"):
        return a | args[1]
    if op in ("mul", "logical_and"):
        return a & args[1]
    if op == "div":
        return a
    if op == "where":
        return args[1] | args[2]
    if op in _KEEPS_ZERO:
        return a
    return np.ones_like(np.broadcast_arrays(*[
        x for x in args if isinstance(x, np.ndarray)])[0])


def _view_mask(node: Node, x, C: int):
    """A view node's elements, from its source's, on a leading cell axis."""
    spec, shape = node.spec, tuple(d.at(C) for d in node.shape)
    kind = spec[0]
    if kind == "unsqueeze":
        return np.expand_dims(x, spec[1] + 1)
    if kind == "squeeze":
        return np.squeeze(x, axis=tuple(d + 1 for d in spec[1]))
    if kind == "select":
        return np.take(x, spec[2], axis=spec[1] + 1)
    if kind == "slice":
        _, d, start, step = spec
        return np.take(x, start + step * np.arange(shape[d]), axis=d + 1)
    if kind == "permute":
        return x.transpose((0, *[p + 1 for p in spec[1]]))
    if kind == "expand":
        lead = len(shape) - (x.ndim - 1)
        x = x.reshape(x.shape[:1] + (1,) * lead + x.shape[1:])
        return np.broadcast_to(x, x.shape[:1] + shape)
    return x.reshape(x.shape[:1] + shape)


def needed_operations(graph: Graph, rows, starts, widths, C: int) -> tuple:
    """The graph's operations that the seeds' structural zeros leave, for
    the cells (row i, columns start .. start + width - 1, at C >= width
    lanes): (their sum over the cells, the operations no seed reaches, once
    per instance).  The seeds are the Pallas body's (di one-hot at i, dj
    at the cell's columns, dij zero); an element is needed where it may be
    nonzero -- a sum or product of structural zeros, or a map with g(0) =
    0 of one, is one -- and costs what ``cell_operations`` charges it: an
    elementwise node one per needed output element, a sum its needed input
    elements, an mm 2 per pair of needed factors.  A node that reads no
    di or dj is the same in every cell of an instance and is counted
    once.  A constant's zeros are structural."""
    rows, starts, widths = (np.asarray(a).reshape(-1, 1) for a in
                            (rows, starts, widths))
    nodes = live(graph)
    last = {}
    for j, node in enumerate(nodes):
        for a in node.args:
            if isinstance(a, Node):
                last[a.id] = j
    k = np.arange(graph.n)[None, :]
    lanes = np.arange(C)[None, None, :]
    mask, cellwise = {}, {}
    per_cell = per_instance = 0
    for j, node in enumerate(nodes):
        shape = tuple(d.at(C) for d in node.shape)
        ins = [a for a in node.args if isinstance(a, Node)]
        dep = any(cellwise[a.id] for a in ins)
        ops = None
        if node.kind == "in":
            dep = node.op in ("di", "dj")
            if node.op == "val":
                m = np.ones((1,) + shape, bool)
            elif node.op == "di":
                m = k == rows
            elif node.op == "dj":
                m = ((k[..., None] == starts[..., None] + lanes)
                     & (lanes < widths[..., None]))
            else:
                m = np.zeros((1,) + shape, bool)
        elif node.kind == "scalar":
            m = np.full((1,) + shape, bool(node.value))
        elif node.kind == "const":
            size = math.prod(shape)
            m = (graph.consts[node.offset:node.offset + size] != 0).reshape(
                (1,) + shape)
        elif node.kind == "ew":
            args = [mask[a.id] if isinstance(a, Node) else np.bool_(a != 0)
                    for a in node.args]
            if node.op == "pow" and not isinstance(node.args[1], Node):
                m = args[0] if node.args[1] > 0 else np.ones_like(args[0])
            else:
                m = _nonzero(node.op, args)
            m = np.broadcast_to(m, m.shape[:1] + shape)
            ops = m
        elif node.kind == "view":
            m = _view_mask(node, mask[node.args[0].id], C)
        elif node.kind == "sum":
            x = mask[node.args[0].id]
            m = x.any(axis=tuple(d + 1 for d in node.dims))
            ops = x
        else:                                   # mm
            a, b = (mask[x.id] for x in node.args)
            m = np.matmul(a.astype(np.float32), b.astype(np.float32)) > 0
            pairs = 2 * (a.sum(axis=1) * b.sum(axis=2)).sum()
            per_cell, per_instance = ((per_cell + int(pairs), per_instance)
                                      if dep else
                                      (per_cell, per_instance + int(pairs)))
        if ops is not None:
            count = int(np.count_nonzero(ops))
            if dep:
                per_cell += count
            else:
                per_instance += count
        mask[node.id], cellwise[node.id] = m, dep
        for i in {a.id for a in ins}:
            if last.get(i) == j:
                del mask[i]
    return per_cell, per_instance


def _roots(graph: Graph) -> set:
    """Ids of the nodes that get a loop nest and a local array: the output,
    every reduction, and every elementwise node more than one loop reads
    (its readers through fused elementwise and view nodes)."""
    nodes = live(graph)
    users: dict = {}
    for node in nodes:
        for a in node.args:
            if isinstance(a, Node):
                users.setdefault(a.id, []).append(node)
    roots = {graph.out.id} | {nd.id for nd in nodes
                              if nd.kind in ("sum", "mm")}
    readers: dict = {}
    for node in reversed(nodes):
        r = set()
        for u in users.get(node.id, ()):
            r |= {u.id} if u.id in roots else readers[u.id]
        if node.kind == "ew" and len(r) > 1:
            roots.add(node.id)
        readers[node.id] = r
    return roots


def local_floats(graph: Graph, C: int) -> int:
    """Floats per thread of the materialized nodes at C lanes (their local
    arrays) and of the reductions' accumulators."""
    roots = _roots(graph)
    total = 0
    for node in live(graph):
        if node.id in roots and node is not graph.out:
            total += numel(node.shape, C)
            if node.kind in ("sum", "mm"):
                total += C if any(d.chunk for d in node.shape) else 1
    return total


def lanes_that_fit(graph: Graph) -> tuple:
    """The lane instantiations whose local arrays fit ``LOCAL_MAX``."""
    return tuple(C for C in LANES if 4 * local_floats(graph, C) <= LOCAL_MAX)


# ---------------------------------------------------------------------------
# emission
# ---------------------------------------------------------------------------

class _Block:
    """A C++ scope: a loop body (``var`` its loop variable) or the eval
    body.  Temporaries are memoized per block by (node, index code)."""

    def __init__(self, parent=None, var=None, header=""):
        self.parent, self.var, self.header = parent, var, header
        self.items: list = []
        self.memo: dict = {}
        self.vars = (parent.vars if parent else frozenset()) | (
            {var} if var else frozenset())

    def render(self, depth: int) -> list:
        pad = "  " * depth
        out = []
        for item in self.items:
            if isinstance(item, _Block):
                out.append(pad + item.header + " {")
                out.extend(item.render(depth + 1))
                out.append(pad + "}")
            else:
                out.append(pad + item)
        return out


class _Emitter:
    def __init__(self, graph: Graph):
        self.g = graph
        self.roots = _roots(graph)
        self.nvar = 0
        self.ntmp = 0
        self.top = _Block()

    # -- scopes ------------------------------------------------------------
    def loop(self, parent: _Block, dim: Dim):
        """A new loop over dim inside parent (unrolled over C lanes)."""
        if dim == Dim(0, 1):
            return parent, ("0", frozenset())
        var = f"i{self.nvar}"
        self.nvar += 1
        if dim.a == 1:
            parent.items.append("#pragma unroll")
        blk = _Block(parent, var,
                     f"for (int {var} = 0; {var} < {dim.code()}; ++{var})")
        parent.items.append(blk)
        return blk, (var, frozenset({var}))

    @staticmethod
    def home(blk: _Block, deps) -> _Block:
        """The outermost enclosing scope that defines every variable of
        ``deps``."""
        while blk.parent is not None and deps <= blk.parent.vars:
            blk = blk.parent
        return blk

    def temp(self, blk: _Block, key, code: str, deps, dtype: str):
        at = self.home(blk, deps)
        name = f"t{self.ntmp}"
        self.ntmp += 1
        ctype = "bool" if dtype == "b" else "float"
        line = f"const {ctype} {name} = {code};"
        if at is blk:
            at.items.append(line)
        else:
            # hoisted: before the loop now being built (at's last item)
            pos = len(at.items) - 1
            if pos > 0 and at.items[pos - 1] == "#pragma unroll":
                pos -= 1
            at.items.insert(pos, line)
        at.memo[key] = name
        return name, deps

    @staticmethod
    def lookup(blk: _Block, key):
        while blk is not None:
            if key in blk.memo:
                return blk.memo[key]
            blk = blk.parent
        return None

    # -- index arithmetic ----------------------------------------------------
    @staticmethod
    def flat(shape, idx) -> tuple:
        """Row-major offset of idx in shape, and its variables."""
        code, deps, stride = [], frozenset(), ""
        for d, (e, dv) in reversed(list(zip(shape, idx))):
            deps |= dv
            code.append(f"{e} * {stride}" if stride else e)
            stride = d.code() if not stride else f"{stride} * {d.code()}"
        return ("(" + " + ".join(reversed(code)) + ")") if code else "0", deps

    def view_index(self, node: Node, idx) -> list:
        """The source index of a view node's element idx."""
        spec, src = node.spec, node.args[0]
        kind = spec[0]
        if kind == "unsqueeze":
            return [e for j, e in enumerate(idx) if j != spec[1]]
        if kind == "squeeze":
            it = iter(idx)
            return [("0", frozenset()) if j in spec[1] else next(it)
                    for j in range(len(src.shape))]
        if kind == "select":
            out = list(idx)
            out.insert(spec[1], (str(spec[2]), frozenset()))
            return out
        if kind == "slice":
            _, d, start, step = spec
            out = list(idx)
            e, dv = out[d]
            if (start, step) != (0, 1):
                out[d] = (f"({start} + {step} * {e})" if step != 1
                          else f"({start} + {e})", dv)
            return out
        if kind == "permute":
            out = [None] * len(idx)
            for j, p in enumerate(spec[1]):
                out[p] = idx[j]
            return out
        if kind == "expand":
            lead = len(node.shape) - len(src.shape)
            return [("0", frozenset()) if (s.a == 0 and s.b == 1
                                           and node.shape[lead + j] != s)
                    else idx[lead + j] for j, s in enumerate(src.shape)]
        if kind == "reshape":
            so = [d for d in src.shape if d != Dim(0, 1)]
            no = [d for d in node.shape if d != Dim(0, 1)]
            if so == no:            # only size-1 dims inserted or removed
                it = iter(e for d, e in zip(node.shape, idx)
                          if d != Dim(0, 1))
                return [("0", frozenset()) if d == Dim(0, 1) else next(it)
                        for d in src.shape]
            f, deps = self.flat(node.shape, idx)
            out, stride = [], ""
            for d in reversed(src.shape):
                q = f"({f} / ({stride}))" if stride else f
                out.append((f"({q} % {d.code()})", deps))
                stride = d.code() if not stride else f"{stride} * {d.code()}"
            return list(reversed(out))
        raise ValueError(f"unknown view {spec}")

    # -- values -------------------------------------------------------------
    def value(self, blk: _Block, node: Node, idx, inline: bool = False):
        """(code, variables) of node's element idx in scope blk; a root is
        read from its array unless ``inline`` (its own loop computes it)."""
        if node.id in self.roots and not inline:
            f, deps = self.flat(node.shape, idx)
            return f"b{node.id}[{f}]", deps
        k = node.kind
        if k == "scalar":
            return literal(node.value, node.dtype), frozenset()
        if k == "in" and node.op == "dij":
            return "0.f", frozenset()
        if k == "view":
            return self.value(blk, node.args[0], self.view_index(node, idx))
        key = (node.id, tuple(e for e, _ in idx))
        hit = self.lookup(blk, key)
        if hit is not None:
            return hit, frozenset().union(*(d for _, d in idx))
        if k == "in":
            code, deps = self.seed(node.op, idx)
            return self.temp(blk, key, code, deps, node.dtype)
        if k == "const":
            f, deps = self.flat(node.shape, idx)
            code = f"CHESS_LDG(k + {node.offset} + {f})"
            code = f"({code} != 0.f)" if node.dtype == "b" else code
            return self.temp(blk, key, code, deps, node.dtype)
        if k == "ew":
            args, deps = [], frozenset()
            for a in node.args:
                if isinstance(a, Node):
                    code, dv = self.value(blk, a, idx)
                    deps |= dv
                else:
                    code = literal(a)
                args.append(code)
            code = self.ew_code(node.op, args)
            return self.temp(blk, key, code, deps, node.dtype)
        raise ValueError(f"node kind {k} is read through its array only")

    @staticmethod
    def ew_code(op: str, args) -> str:
        if op == "pow" and args[1] in ("2.0f", "1.0f", "0.5f", "-1.0f"):
            return {"2.0f": "({0} * {0})", "1.0f": "({0})",
                    "0.5f": "sqrtf({0})",
                    "-1.0f": "(1.f / {0})"}[args[1]].format(args[0])
        return EW_OPS[op][1].format(*args)

    @staticmethod
    def seed(which: str, idx):
        """The dense seeds of the cell (paper Alg. 4), as the Pallas body
        writes them: di one-hot at i, dj one-hot at the carried columns
        sub + l (l < width), dij zero."""
        if which == "val":
            (e, d), = idx
            return f"s[{e}]", d
        if which == "di":
            (e, d), = idx
            return f"({e} == c.i ? 1.f : 0.f)", d
        (e, d), (l, dl) = idx
        return (f"(({l} < c.width && {e} == c.sub + {l}) ? 1.f : 0.f)",
                d | dl)

    # -- loop nests ---------------------------------------------------------
    def nest(self, blk: _Block, shape, order):
        """Loops over shape's dims in ``order``; returns the innermost scope
        and the index (by dim position)."""
        idx = [None] * len(shape)
        for j in order:
            blk, idx[j] = self.loop(blk, shape[j])
        return blk, idx

    @staticmethod
    def order(shape, first=()):
        """Static dims outside (in order), chunk dims innermost."""
        st = [j for j in range(len(shape)) if not shape[j].chunk
              and j not in first]
        ch = [j for j in range(len(shape)) if shape[j].chunk
              and j not in first]
        return list(first) + st + ch

    def declare(self, node: Node) -> None:
        s, k = extent(node.shape)
        size = f"{s} * C" if k else str(s)
        self.top.items.append(f"float b{node.id}[{size}];")

    def emit_root(self, node: Node) -> None:
        self.declare(node)
        if node.kind in ("sum", "mm"):
            self.emit_reduction(node)
            return
        blk, idx = self.nest(self.top, node.shape, self.order(node.shape))
        f, _ = self.flat(node.shape, idx)
        code, _ = self.value(blk, node, idx, inline=True)
        blk.items.append(f"b{node.id}[{f}] = {code};")

    def emit_reduction(self, node: Node) -> None:
        """out[o] = sum over r of body(o, r): static out dims, then static
        reduced dims, then the chunk dim (out or reduced) innermost; the
        out chunk dim's partial sums in an accumulator array."""
        if node.kind == "sum":
            src = node.args[0]
            red = list(node.dims)
            keep = [j for j in range(len(src.shape)) if j not in red]
            full = list(src.shape)

            def body(b, fidx):
                return self.value(b, src, fidx)
        else:
            A, B = node.args
            r, kd, cols = A.shape[0], A.shape[1], B.shape[1]
            full, keep, red = [r, cols, kd], [0, 1], [2]

            def body(b, fidx):
                ea, da = self.value(b, A, [fidx[0], fidx[2]])
                eb, db = self.value(b, B, [fidx[2], fidx[1]])
                return f"({ea} * {eb})", da | db
        out_static = [j for j in keep if not full[j].chunk]
        out_chunk = [j for j in keep if full[j].chunk]
        red_static = [j for j in red if not full[j].chunk]
        red_chunk = [j for j in red if full[j].chunk]
        acc = f"a{node.id}"
        blk, fidx = self.top, [None] * len(full)
        for j in out_static:
            blk, fidx[j] = self.loop(blk, full[j])
        if out_chunk:
            (j,) = out_chunk
            blk.items.append(f"float {acc}[{full[j].code()}];")
            z, zi = self.loop(blk, full[j])
            z.items.append(f"{acc}[{zi[0]}] = 0.f;")
        else:
            blk.items.append(f"float {acc} = 0.f;")
        inner = blk
        for j in red_static + red_chunk + out_chunk:
            inner, fidx[j] = self.loop(inner, full[j])
        code, _ = body(inner, fidx)
        tgt = f"{acc}[{fidx[out_chunk[0]][0]}]" if out_chunk else acc
        inner.items.append(f"{tgt} += {code};")
        oidx = [fidx[j] for j in keep]
        if out_chunk:
            (j,) = out_chunk
            st, si = self.loop(blk, full[j])
            oidx = [si if jj == j else fidx[jj] for jj in keep]
            f, _ = self.flat(node.shape, oidx)
            st.items.append(f"b{node.id}[{f}] = {acc}[{si[0]}];")
        else:
            f, _ = self.flat(node.shape, oidx)
            blk.items.append(f"b{node.id}[{f}] = {acc};")

    def body(self) -> list:
        out = self.g.out
        for node in live(self.g):
            if node.id in self.roots and node is not out:
                self.emit_root(node)
        reduced = out.kind in ("sum", "mm")
        if reduced:
            self.emit_root(out)
        self.top.items.append("HDual<C> r = constant<C>(0.f);")
        blk, idx = self.loop(self.top, out.shape[0])
        code, _ = self.value(blk, out, [idx], inline=not reduced)
        blk.items.append(f"r.dij[{idx[0]}] = {code};")
        self.top.items.append("return r;")
        return self.top.render(2)


_TEMPLATE = """\
// Generated by repro_torch/kernels/codegen.py from a traced cell of f at
// n = {n}: the dense hDual evaluation of the Pallas body, as a device form
// of csrc/chess_hvp.cuh's kernel template.  {ops}
#include "chess_hvp.cuh"

namespace chessfad {{

struct Traced {{
  static constexpr bool kOwnCells = true;  // its cells read the constants k
  static constexpr bool kStages = false;   // nothing staged but the rows
  static constexpr int kRows = 3, kScalars = 0;  // a, v, out
  static constexpr int kN = {n};
  // the lane widths built: {lanes} (the others' local arrays pass
  // LOCAL_MAX = {local_max} bytes a thread)
  static constexpr unsigned kLaneMask = {mask}u;

  template <int C>
  __host__ __device__ static constexpr int table_floats() {{ return 0; }}

  __device__ static void table(float, float*, int, int) {{}}
  template <bool S>
  __device__ static void instance(float*, int, int, int, int, const float*,
                                  const float*, int, const float*) {{}}

  // f's hDual on one cell: s holds the instance's a, k the constants
  template <int C>
  __device__ static HDual<C> eval(const float* s, const float* k,
                                  const Cell& c) {{
{body}
  }}

#ifdef __CUDACC__
  template <int C, bool S>
  __device__ static void cells(float* inst, int slot, int ld, int nin,
                               float*, const int* rows, const int* starts,
                               int P, int n, int csize, int symmetric,
                               const float* k, const float*, int) {{
    const_cells<Traced, C>(inst, slot, ld, nin, rows, starts, P, n, csize,
                           symmetric, k);
  }}
#endif
}};

}}  // namespace chessfad

#ifdef __CUDACC__
// the kernel on the card, with the arguments of csrc/chess_hvp.cu's
// chess_hvp_launch: its one form (fn 0), nothing staged, k the float32
// constants ({nconst} floats)
extern "C" int chess_hvp_traced_launch(const void* A, const void* V,
                                       void* out, int dtype, const int* rows,
                                       const int* starts, int P, int m, int n,
                                       int csize, int cmax, int symmetric,
                                       int fn, int ipb, int warps, int staged,
                                       long long smem_bytes, const float* k,
                                       const float*, const float*,
                                       void* stream) {{
  using namespace chessfad;
  if (n != Traced::kN || fn != 0 || staged != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_entry<Traced>(A, V, out, dtype, rows, starts, P, m, n, csize,
                              cmax, symmetric, ipb, warps, 0, smem_bytes,
                              Consts{{k, nullptr, nullptr}}, stream);
}}
#else
// every cell on the host, float32 A, V and out (the CPU check)
extern "C" int chess_hvp_traced_host(const float* A, const float* V,
                                     float* out, const int* rows,
                                     const int* starts, int P, int m, int n,
                                     int csize, int cmax, int symmetric,
                                     const float* k) {{
  using namespace chessfad;
  if (n != Traced::kN) return 1;
  return host_lanes<Traced>(cmax, A, V, out, rows, starts, P, m, n, csize,
                            symmetric, k);
}}
#endif
"""


def source(graph: Graph) -> str:
    """The translation unit of the graph's device form."""
    body = "\n".join(_Emitter(graph).body())
    ops = (f"Dense operations per cell at C lanes: "
           f"{cell_operations(graph, 1)} at C = 1, "
           f"{cell_operations(graph, 8)} at C = 8.")
    lanes = lanes_that_fit(graph)
    mask = sum(1 << LANES.index(C) for C in lanes)
    return _TEMPLATE.format(n=graph.n, body=body, ops=ops,
                            nconst=int(graph.consts.size),
                            lanes=", ".join(map(str, lanes)) or "none",
                            local_max=LOCAL_MAX, mask=hex(mask))
