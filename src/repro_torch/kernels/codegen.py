"""A traced cell of f as a CUDA C++ device form of ``chess_hvp``: the
structural evaluation of its graph.

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
``chess_hvp_traced_host`` (the instance pass and every cell on the host)
under a host compiler.

The lowering (``Lowering``) splits the live graph in two, as the
hand-written forms are split by hand:

* the instance part, the nodes no di or dj seed reaches (``cellwise``
  False): the same in every cell of an instance.  ``Traced::instance``
  computes them once an instance, after the kernel stages a and v: a node
  the cell part reads that is not a cheap map of the point (a transcendental,
  a reduction) is stored in the instance's shared slot, a row of n|1 floats
  (``kRows`` past a, v, out) or a scalar (``kScalars``), in levels a thread
  per element with a barrier between levels; the rest is recomputed where it
  is read;
* the cell part, evaluated in ``eval<C>`` once a cell.  For each of its
  nodes a support (``Sup``) says, per static dimension, where the node may
  be nonzero, as an expression in the cell: the i-window {i+a..i+b}, the
  J-window {sub+a..sub+width-1+b} of the carried columns, their union, the
  whole dimension, or nothing; and ``diag`` where an element is nonzero only
  on its lane's column (dj, and what multiplies it).  Slices shift the
  windows, products meet them, sums and ``mm`` drop or spread them.
  Loops run over supports only: a slot loop over a window, a lane loop that
  derives a diagonal coordinate from its lane; the seeds are selections
  (1 or 0 by the loop's own proof, a ternary elsewhere).  A value read where
  the reader cannot prove it lies in its support is guarded to 0, so a
  structural zero is exactly 0 (``0 * inf`` of the dense evaluation is not
  computed).  A node is an array (``b<id>``, its support's slots by its
  lanes) only where it is small and read by two loops or inside a fused
  reduction; a node that is dense along a static dimension, and a
  reduction that is, is fused into its reader's loop (an ``mm`` of a dense
  constant with a sparse operand becomes a short loop over the operand's
  support at each row, Fletcher-Powell's res_r = p_r + sum_{k in S} ...).

``needed_operations`` is the bound: the graph's operations that the seeds'
structural zeros leave (boolean masks carried through the graph).  It is
the oracle of the supports: every node's support contains its mask
(``Lowering.support_mask``).  ``cell_operations`` counts what the emitted
code runs at each cell (an elementwise node one where it is computed, a
sum one per term, an mm two), from the loops around each computation and
their valid trips at the cell; ``instance_operations`` the instance pass.
``local_floats`` is the floats of the arrays and accumulators a thread
holds.  The hmath maps arrive as their g, dg and d2g, spelled by the aten
graph, and are emitted as IEEE float32 functions (``sinf``, ``expf``, ...):
no fast-math intrinsic.

The same source compiles as host C++ (``g++ -std=c++17 -shared -fPIC -I
src/repro_torch/kernels/csrc``): its ``chess_hvp_traced_host`` runs each
instance's instance pass and then its cells on one thread, which is how the
CPU tests hold a form against the plain version
(``tests/test_torch_chess_structural.py``, ``test_torch_chess_traced.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Dim", "Node", "Graph", "EW_OPS", "source", "cell_operations",
           "instance_operations", "local_floats", "lanes_that_fit",
           "lanes_for", "LANES", "LOCAL_MAX", "needed_operations",
           "structural_masks", "lowering", "Lowering", "Win", "Sup"]

LANES = (1, 2, 4, 8, 16, 32, 64)   # the kernel's hDual<C> instantiations
# local memory a thread of a generated form may hold (its arrays and
# accumulators).  The driver sizes local memory for every thread the card
# can hold, 2,048 on each of 132 SMs, and keeps it for the process's life:
# a 32 KB form takes up to 8.9 GB of 80 (chip_smoke.py phase 18 reads it)
LOCAL_MAX = 32768


def lanes_for(csize: int) -> int:
    """The lane instantiation for ``csize`` columns: the smallest that holds
    them, or the widest, whose sub-cells then split the chunk."""
    return next((c for c in LANES if c >= csize), LANES[-1])


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


def static_numel(shape) -> int:
    return math.prod(d.b for d in shape if not d.chunk)


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

# maps an instance value may be recomputed by where it is read (at most
# four of them deep) instead of being stored in the instance's slot
_CHEAP = frozenset({"add", "sub", "mul", "neg", "abs", "sign", "square",
                    "maximum", "minimum", "where", "lt", "le", "gt", "ge",
                    "eq", "ne", "logical_not", "logical_and", "logical_or",
                    "to_float", "to_bool"})


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


def _pm(k: int) -> str:
    """`` + k`` / `` - k`` / nothing: an integer offset in C++."""
    return f" + {k}" if k > 0 else (f" - {-k}" if k < 0 else "")


def live(graph: Graph) -> list:
    """The nodes the dij output reads, in topological order."""
    need = {graph.out.id}
    for node in reversed(graph.nodes):
        if node.id in need:
            need.update(a.id for a in node.args if isinstance(a, Node))
    return [nd for nd in graph.nodes if nd.id in need]


# ---------------------------------------------------------------------------
# the structural zeros of the seeds, and the bound they leave
# ---------------------------------------------------------------------------

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


def structural_masks(graph: Graph, rows, starts, widths, C: int):
    """For each live node, in order: (node, where it may be nonzero at each
    cell -- a boolean array of the cells by its shape at C lanes --, the
    elements its operations are charged on (None for none; a pair count
    for an mm), and whether it reads a di or dj seed).  The seeds are the
    Pallas body's (di one-hot at i, dj at the cell's columns start ..
    start + width - 1, dij zero); an element may be nonzero where a sum or
    product of possible nonzeros, or a map with g(0) = 0 of one, is.  A
    constant's zeros are structural.  A mask is dropped after its last
    reader."""
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
            ops = 2 * int((a.sum(axis=1) * b.sum(axis=2)).sum())
        mask[node.id], cellwise[node.id] = m, dep
        yield node, m, ops, dep
        for i in {a.id for a in ins}:
            if last.get(i) == j:
                del mask[i]


def needed_operations(graph: Graph, rows, starts, widths, C: int) -> tuple:
    """The graph's operations that the seeds' structural zeros leave, for
    the cells (row i, columns start .. start + width - 1, at C >= width
    lanes): (their sum over the cells, the operations no seed reaches, once
    per instance).  An element is needed where it may be nonzero
    (``structural_masks``) and costs one operation per needed output
    element of an elementwise node, a sum its needed input elements, an mm
    2 per pair of needed factors.  A node that reads no di or dj is the
    same in every cell of an instance and is counted once."""
    per_cell = per_instance = 0
    for _, _, ops, dep in structural_masks(graph, rows, starts, widths, C):
        if ops is None:
            continue
        count = ops if isinstance(ops, int) else int(np.count_nonzero(ops))
        if dep:
            per_cell += count
        else:
            per_instance += count
    return per_cell, per_instance


# ---------------------------------------------------------------------------
# supports: where a node may be nonzero, as expressions in the cell
# ---------------------------------------------------------------------------

FULL = "full"      # a static dimension: anywhere
LANE = "lane"      # the chunk dimension: every lane


def _hull(x, y):
    if x is None:
        return y
    if y is None:
        return x
    return (min(x[0], y[0]), max(x[1], y[1]))


def _inside(x, y) -> bool:
    """Interval x (None: empty) inside interval y."""
    return x is None or (y is not None and y[0] <= x[0] and x[1] <= y[1])


@dataclass(frozen=True)
class Win:
    """Where a static dimension may be nonzero: the i-window {i + a .. i +
    b} (``iw`` = (a, b)) and the J-window {sub + a .. sub + width - 1 + b}
    of the carried columns (``jw``), either absent; both absent: nowhere.
    Its slots: the J-window's C + b - a, then the i-window's b - a + 1."""
    iw: tuple = None
    jw: tuple = None

    @property
    def empty(self) -> bool:
        return self.iw is None and self.jw is None

    def shift(self, s: int) -> "Win":
        """The window of e + s, e in this one."""
        return Win(*(None if w is None else (w[0] + s, w[1] + s)
                     for w in (self.iw, self.jw)))

    def jslots(self) -> str:
        s = self.jw[1] - self.jw[0]
        return "C" if s == 0 else f"(C{_pm(s)})"

    def islots(self) -> int:
        return self.iw[1] - self.iw[0] + 1 if self.iw else 0

    def slots(self) -> str:
        parts = ([self.jslots()] if self.jw else []) + (
            [str(self.islots())] if self.iw else [])
        return " + ".join(parts) if len(parts) > 1 else parts[0]

    def slots_at(self, C: int) -> int:
        j = max(0, C + self.jw[1] - self.jw[0]) if self.jw else 0
        return j + self.islots()


def win_union(u, v):
    if u == FULL or v == FULL:
        return FULL
    return Win(_hull(u.iw, v.iw), _hull(u.jw, v.jw))


def win_meet(u, v):
    """A window holding the intersection of u and v: exact for two
    i-windows or two J-windows; an i-window met with a J-window is kept."""
    if u == FULL:
        return v
    if v == FULL:
        return u
    if u.empty or v.empty:
        return Win()
    iw = None
    if u.iw and v.iw:
        lo, hi = max(u.iw[0], v.iw[0]), min(u.iw[1], v.iw[1])
        iw = (lo, hi) if lo <= hi else None
    if u.iw and v.jw:
        iw = _hull(iw, u.iw)
    if v.iw and u.jw:
        iw = _hull(iw, v.iw)
    jw = ((max(u.jw[0], v.jw[0]), min(u.jw[1], v.jw[1]))
          if u.jw and v.jw else None)
    return Win(iw, jw)


@dataclass(frozen=True)
class Sup:
    """A node's support: per dimension a ``Win``, ``FULL`` or ``LANE`` (the
    chunk dimension); ``diag`` (p, d): an element is nonzero only where its
    dimension p is sub + lane + d; ``zero``: nowhere."""
    dims: tuple
    diag: tuple = None
    zero: bool = False


def _mk(shape, dims, diag=None) -> Sup:
    dims = tuple(LANE if d.chunk else (FULL if w == LANE else w)
                 for d, w in zip(shape, dims))
    if any(isinstance(w, Win) and w.empty for w in dims):
        return Sup(dims, None, True)
    if diag is not None and not (any(d == Dim(1, 0) for d in shape)
                                 and isinstance(dims[diag[0]], (Win, str))
                                 and dims[diag[0]] != LANE):
        diag = None
    return Sup(dims, diag)


def _full(shape, zero=False) -> Sup:
    return Sup(tuple(LANE if d.chunk else FULL for d in shape), None, zero)


def sup_union(u: Sup, v: Sup) -> Sup:
    if u.zero:
        return v
    if v.zero:
        return u
    return Sup(tuple(w if w == LANE else win_union(w, x)
                     for w, x in zip(u.dims, v.dims)),
               u.diag if u.diag == v.diag else None)


def sup_meet(u: Sup, v: Sup, shape) -> Sup:
    if u.zero:
        return u
    if v.zero:
        return v
    return _mk(shape, tuple(w if w == LANE else win_meet(w, x)
                            for w, x in zip(u.dims, v.dims)),
               u.diag or v.diag)


def _simple_reshape(src, dst) -> bool:
    """Only size-1 dimensions inserted or removed."""
    return ([d for d in src if d != Dim(0, 1)]
            == [d for d in dst if d != Dim(0, 1)])


def _view_sup(node: Node, x: Sup) -> Sup:
    shape, src, spec = node.shape, node.args[0], node.spec
    if x.zero:
        return _full(shape, True)
    kind = spec[0]
    dims = list(x.dims)
    p, dd = x.diag if x.diag else (None, 0)
    if kind == "unsqueeze":
        dims.insert(spec[1], FULL)
        p = p + 1 if p is not None and p >= spec[1] else p
    elif kind == "squeeze":
        keep = [j for j in range(len(dims)) if j not in spec[1]]
        p = keep.index(p) if p in keep else None
        dims = [dims[j] for j in keep]
    elif kind == "select":
        d = spec[1]
        del dims[d]
        p = None if p == d else (p - 1 if p is not None and p > d else p)
    elif kind == "slice":
        _, d, start, step = spec
        if step == 1:
            dims[d] = dims[d] if dims[d] == FULL else dims[d].shift(-start)
            dd = dd - start if p == d else dd
        else:
            dims[d] = FULL
            p = None if p == d else p
    elif kind == "permute":
        perm = list(spec[1])
        dims = [x.dims[q] for q in perm]
        p = perm.index(p) if p is not None else None
    elif kind == "expand":
        lead = len(shape) - len(src.shape)
        dims = [FULL] * lead + [w if src.shape[j] == shape[lead + j] else FULL
                                for j, w in enumerate(dims)]
        p = (p + lead if p is not None and src.shape[p] == shape[lead + p]
             else None)
    elif _simple_reshape(src.shape, shape):
        so = [j for j, d in enumerate(src.shape) if d != Dim(0, 1)]
        no = [j for j, d in enumerate(shape) if d != Dim(0, 1)]
        new = [FULL] * len(shape)
        for a, b in zip(so, no):
            new[b] = dims[a]
        p = no[so.index(p)] if p in so else None
        dims = new
    else:
        return _full(shape)
    return _mk(shape, dims, (p, dd) if p is not None else None)


def _support(node: Node, sup: dict) -> Sup:
    """A node's support from its operands' (the rules of
    ``structural_masks``, on windows)."""
    shape, kind = node.shape, node.kind
    if kind == "in":
        if node.op == "di":
            return Sup((Win(iw=(0, 0)),))
        if node.op == "dj":
            return Sup((Win(jw=(0, 0)), LANE), (0, 0))
        return _full(shape, node.op == "dij")
    if kind == "scalar":
        return _full(shape, not node.value)
    if kind == "const":
        return _full(shape)
    if kind == "ew":
        args = [sup[a.id] if isinstance(a, Node) else _full(shape, a == 0)
                for a in node.args]
        op = node.op
        if op in ("add", "sub", "maximum", "minimum", "logical_or"):
            return sup_union(args[0], args[1])
        if op in ("mul", "logical_and"):
            return sup_meet(args[0], args[1], shape)
        if op == "where":
            return sup_union(args[1], args[2])
        if op == "div" or op in _KEEPS_ZERO or (
                op == "pow" and not isinstance(node.args[1], Node)
                and node.args[1] > 0):
            return args[0]
        return _full(shape)
    if kind == "view":
        return _view_sup(node, sup[node.args[0].id])
    if kind == "sum":
        x = sup[node.args[0].id]
        if x.zero:
            return _full(shape, True)
        return _mk(shape, [w for j, w in enumerate(x.dims)
                           if j not in node.dims])
    A, B = (sup[a.id] for a in node.args)
    if A.zero or B.zero:
        return _full(shape, True)
    k = LANE if A.dims[1] == LANE else win_meet(A.dims[1], B.dims[0])
    if isinstance(k, Win) and k.empty:
        return _full(shape, True)
    return _mk(shape, (A.dims[0], B.dims[1]))


def _member_np(w, e, i, sub, width):
    """Whether elements e (arrays broadcast against the cells' i, sub and
    width) lie in window w."""
    if w == FULL:
        return np.ones(np.broadcast(e, i).shape, bool)
    m = np.zeros(np.broadcast(e, i).shape, bool)
    if w.jw:
        m |= (e >= sub + w.jw[0]) & (e <= sub + width - 1 + w.jw[1])
    if w.iw:
        m |= (e >= i + w.iw[0]) & (e <= i + w.iw[1])
    return m


# ---------------------------------------------------------------------------
# the lowering: supports, what each node becomes, the instance slot
# ---------------------------------------------------------------------------

class Lowering:
    """The analysis of a graph and its emitted code.

    ``sup``       node id -> ``Sup``
    ``cellwise``  node id -> whether a di or dj seed reaches it
    ``mode``      node id -> free (val, dij, a literal, a constant), view,
                  seed (di, dj), stored (an instance value in the slot),
                  inline (computed where read), fused (a reduction computed
                  where read), root (an array of the cell, or the output's
                  reduction), out (the output, computed in its lane loop)
    ``off``       stored node id -> its float offset in the slot
    ``level``     stored node id -> its instance-pass level (1, 2, ...)
    ``rows``, ``scalars``: the slot's rows of n|1 floats (a, v, out, then
    the stored rows) and scalars"""

    def __init__(self, graph: Graph):
        self.g = graph
        self.nodes = live(graph)
        self.ld = graph.n | 1
        self.sup, self.cellwise = {}, {}
        for nd in self.nodes:
            self.sup[nd.id] = _support(nd, self.sup)
            self.cellwise[nd.id] = (nd.op in ("di", "dj") if nd.kind == "in"
                                    else any(self.cellwise[a.id]
                                             for a in nd.args
                                             if isinstance(a, Node)))
        self._modes()
        self._layout()
        eva = _Emitter(self)
        self.eval_lines = eva.eval_body()
        ins = _Emitter(self)
        self.instance_lines = ins.instance_body()
        self._eval, self._ins = eva, ins

    def dense(self, nd: Node) -> bool:
        """Whether the node may be nonzero along a whole static dimension
        of more than one element (it is then fused into its readers)."""
        s = self.sup[nd.id]
        return any(w == FULL and d.b > 1
                   for w, d in zip(s.dims, nd.shape) if not d.chunk)

    def _modes(self):
        mode, inv, cost, users = {}, {}, {}, {}
        for nd in self.nodes:
            for a in nd.args:
                if isinstance(a, Node):
                    users.setdefault(a.id, []).append(nd)
        for nd in self.nodes:                     # the instance part
            if self.cellwise[nd.id]:
                continue
            args = [a for a in nd.args if isinstance(a, Node)]
            if nd.kind in ("in", "scalar", "const"):
                mode[nd.id], inv[nd.id], cost[nd.id] = "free", True, 0
                continue
            if nd.kind == "view":
                src = args[0]
                mode[nd.id], cost[nd.id] = "view", cost[src.id]
                inv[nd.id] = inv[src.id] and (
                    nd.spec[0] != "reshape" or _simple_reshape(
                        src.shape, nd.shape)
                    or not any(d.chunk for d in src.shape))
                continue
            inv[nd.id] = (all(inv[a.id] for a in args) and not (
                nd.kind == "sum" and any(nd.args[0].shape[d].chunk
                                         for d in nd.dims)) and not (
                nd.kind == "mm" and nd.args[0].shape[1].chunk))
            storable = (inv[nd.id] and all(d == Dim(1, 0) for d in nd.shape
                                           if d.chunk)
                        and static_numel(nd.shape) <= 4 * self.g.n)
            c = 1 + sum(cost[a.id] for a in args)
            if nd.kind == "ew" and nd.op in _CHEAP and c <= 4:
                mode[nd.id], cost[nd.id] = "inline", c
            elif storable:
                mode[nd.id], cost[nd.id] = "stored", 0
            else:
                mode[nd.id] = "inline" if nd.kind == "ew" else "fused"
                cost[nd.id] = 99
        loops = {}
        for nd in reversed(self.nodes):           # the cell part
            if not self.cellwise[nd.id]:
                continue
            rd = set()
            for u in users.get(nd.id, ()):
                if mode[u.id] in ("root", "fused", "out"):
                    rd.add(u.id)
                else:
                    rd |= loops[u.id]
            loops[nd.id] = rd
            if nd is self.g.out:
                mode[nd.id] = "root" if nd.kind in ("sum", "mm") else "out"
            elif nd.kind in ("view",):
                mode[nd.id] = "view"
            elif nd.kind == "in":
                mode[nd.id] = "seed"
            elif nd.kind in ("sum", "mm"):
                mode[nd.id] = "fused" if self.dense(nd) else "root"
            else:
                mode[nd.id] = ("root" if not self.dense(nd) and (
                    len(rd) > 1 or any(mode[r] == "fused" for r in rd))
                    else "inline")
        self.mode = mode

    def _layout(self):
        """Which values the slot holds: a storable instance value the cell
        part reads (through views and values recomputed where read), and
        one an instance-part reduction reads (else its body would compute
        it once per element of the reduction).  Any other is computed
        where the instance pass reads it (once an instance: no row)."""
        out, mode = self.g.out, self.mode
        keep, seen = set(), set()
        # (value, inside an instance reduction's body, read by the cells)
        stack = [(a, False, True) for nd in self.nodes if self.cellwise[nd.id]
                 for a in nd.args
                 if isinstance(a, Node) and not self.cellwise[a.id]]
        if not self.cellwise[out.id]:
            stack.append((out, False, True))
        while stack:
            x, under, cell = stack.pop()
            if (x.id, under, cell) in seen or x.id in keep:
                continue
            seen.add((x.id, under, cell))
            red = x.kind in ("sum", "mm")
            if mode[x.id] == "stored" and (cell or under):
                keep.add(x.id)
                cell = under = False            # its operands: the pass's
            stack.extend((a, under or red, cell) for a in x.args
                         if isinstance(a, Node))
        for nd in self.nodes:
            if mode.get(nd.id) == "stored" and nd.id not in keep:
                mode[nd.id] = "inline" if nd.kind == "ew" else "fused"
        rows = scalars = 0
        where, self.level, avail = {}, {}, {}
        self.stored = []
        for nd in self.nodes:
            if self.cellwise[nd.id]:
                continue
            below = max((avail.get(a.id, 0) for a in nd.args
                         if isinstance(a, Node)), default=0)
            if nd.id in keep:
                E = static_numel(nd.shape)
                if E == 1:
                    where[nd.id] = ("s", scalars)
                    scalars += 1
                else:
                    where[nd.id] = ("r", rows)
                    rows += -(-E // self.ld)
                self.level[nd.id] = avail[nd.id] = below + 1
                self.stored.append(nd)
            else:
                avail[nd.id] = below
        self.rows, self.scalars = 3 + rows, scalars
        self.off = {i: (3 + k) * self.ld if w == "r" else
                    self.rows * self.ld + k for i, (w, k) in where.items()}

    # -- what the emitted code costs -----------------------------------------
    def cell_operations(self, C: int, rows, starts, widths) -> np.ndarray:
        """Operations of ``eval<C>`` at each cell (row i, columns start ..
        start + width - 1 below n)."""
        return self._eval.count(C, rows, starts, widths)

    def instance_operations(self) -> int:
        """Operations of the instance pass, once an instance."""
        return int(self._ins.count(1, [0], [0], [1])[0])

    def local_floats(self, C: int) -> int:
        return sum(f(C) for f in self._eval.arrays)

    def support_mask(self, node: Node, rows, starts, widths, C: int):
        """The cells-by-shape boolean array of where ``sup`` says the node
        may be nonzero (the oracle test holds ``structural_masks`` inside
        it)."""
        i, sub, w = (np.asarray(a).reshape((-1,) + (1,) * len(node.shape))
                     for a in (rows, starts, widths))
        s = self.sup[node.id]
        shape = tuple(d.at(C) for d in node.shape)
        m = np.full((len(i),) + shape, not s.zero)
        for j, (d, win) in enumerate(zip(node.shape, s.dims)):
            if isinstance(win, Win):
                e = np.arange(shape[j]).reshape(
                    (1,) + tuple(-1 if q == j else 1
                                 for q in range(len(shape))))
                m &= _member_np(win, e, i, sub, w)
        if s.diag:
            p, dd = s.diag
            jc = next(j for j, d in enumerate(node.shape) if d.chunk)
            sh = [1] * len(shape)
            sh[p] = shape[p]
            e = np.arange(shape[p]).reshape((1,) + tuple(sh))
            sh = [1] * len(shape)
            sh[jc] = shape[jc]
            lane = np.arange(shape[jc]).reshape((1,) + tuple(sh))
            m &= (e == sub + lane + dd) & (lane < w)
        return m


# ---------------------------------------------------------------------------
# emission
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Ix:
    """One index of a value being read: its code and loop variables, the
    window it is known to lie in (``dom``), ``tie`` (lane code, d) where it
    is sub + lane + d with the lane below the width, and ``slot`` (window,
    slot code) where it is that slot of a loop over the window."""
    code: str
    deps: frozenset = frozenset()
    dom: object = FULL
    tie: tuple = None
    slot: tuple = None


_ZERO = Ix("0")


class _Block:
    """A C++ scope: a loop body (``var`` its loop variable, ``loop`` its
    trip count's description for the counts) or a function body.
    Temporaries are memoized per block by (node, index code)."""

    def __init__(self, parent=None, var=None, header="", loop=None):
        self.parent, self.var, self.header, self.loop = (parent, var, header,
                                                         loop)
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


def _member(code: str, w: Win) -> str:
    """C++: whether element ``code`` lies in window w."""
    parts = []
    if w.jw:
        parts.append(f"({code} >= c.sub{_pm(w.jw[0])} && {code} < c.sub + "
                     f"cw{_pm(w.jw[1])})")
    if w.iw:
        a, b = w.iw
        parts.append(f"({code} == c.i{_pm(a)})" if a == b else
                     f"({code} >= c.i{_pm(a)} && {code} <= c.i{_pm(b)})")
    return parts[0] if len(parts) == 1 else "(" + " || ".join(parts) + ")"


class _Emitter:
    def __init__(self, low: Lowering):
        self.low = low
        self.top = _Block()
        self.ledger: list = []          # (operations, block)
        self.arrays: list = []          # floats of each array at C lanes
        self.sdeps = frozenset()        # what a read of the slot s needs
        self.count_ = 0

    def name(self, prefix: str) -> str:
        self.count_ += 1
        return f"{prefix}{self.count_}"

    # -- scopes ------------------------------------------------------------
    @staticmethod
    def home(blk: _Block, deps) -> _Block:
        """The outermost enclosing scope that defines every variable of
        ``deps``."""
        while blk.parent is not None and deps <= blk.parent.vars:
            blk = blk.parent
        return blk

    @staticmethod
    def place(at: _Block, blk: _Block, item) -> None:
        """Put item in ``at``: at its end where ``at`` is ``blk``, else just
        before its child that holds ``blk`` (and that child's pragma)."""
        if at is blk:
            at.items.append(item)
            return
        child = blk
        while child.parent is not at:
            child = child.parent
        pos = next(j for j, x in enumerate(at.items) if x is child)
        if pos > 0 and isinstance(at.items[pos - 1], str) and \
                at.items[pos - 1].startswith("#pragma"):
            pos -= 1
        at.items.insert(pos, item)

    @staticmethod
    def lookup(blk: _Block, key):
        while blk is not None:
            if key in blk.memo:
                return blk.memo[key]
            blk = blk.parent
        return None

    def temp(self, blk: _Block, key, code: str, deps, dtype: str, ops=0):
        at = self.home(blk, deps)
        name = self.name("t")
        ctype = "bool" if dtype == "b" else "float"
        self.place(at, blk, f"const {ctype} {name} = {code};")
        at.memo[key] = (name, deps)
        if ops:
            self.ledger.append((ops, at))
        return name, deps

    def scope(self, parent, path, header, var, loop, pragma) -> _Block:
        blk = _Block(parent, var, header, loop)
        if pragma:
            self.place(parent, path, pragma)
        self.place(parent, path, blk)
        return blk

    # -- loops ---------------------------------------------------------------
    def loop_full(self, parent, path, dim: Dim):
        """A loop over a whole dimension (unrolled over lanes)."""
        if dim == Dim(0, 1):
            return parent, _ZERO
        v = self.name("i")
        blk = self.scope(parent, path,
                         f"for (int {v} = 0; {v} < {dim.code()}; ++{v})", v,
                         ("lanes", dim.a) if dim.chunk else ("full", dim.b),
                         "#pragma unroll" if dim.chunk else None)
        return blk, Ix(v, frozenset({v}), LANE if dim.chunk else FULL,
                       slot=(FULL, v))

    def loop_slots(self, parent, path, w: Win, ext: int):
        """A loop over window w's slots, skipping those outside [0, ext) and
        an i-window element the J-window holds (a J-window element is below
        n + its offset: cw <= n - sub)."""
        v, e = self.name("i"), self.name("e")
        T = w.slots()
        blk = self.scope(parent, path, f"for (int {v} = 0; {v} < {T}; ++{v})",
                         v, ("slots", w, ext),
                         f"#pragma unroll (C <= 8 && {T} > 0 ? {T} : 1)")
        jw, iw = w.jw, w.iw
        TJ = w.jslots() if jw else "0"
        if jw and iw:
            expr = (f"({v} < {TJ} ? c.sub + {v}{_pm(jw[0])} : "
                    f"c.i + {v} - {TJ}{_pm(iw[0])})")
        elif jw:
            expr = f"c.sub + {v}{_pm(jw[0])}"
        else:
            expr = f"c.i + {v}{_pm(iw[0])}"
        bad = []
        if not ((jw is None or jw[0] >= 0) and (iw is None or iw[0] >= 0)):
            bad.append(f"{e} < 0")
        if iw or ext < self.low.g.n + jw[1]:
            bad.append(f"{e} >= {ext}")
        span = jw[1] - jw[0] if jw else 0
        if jw and iw:
            bad.append(f"({v} < {TJ} ? {v} >= cw{_pm(span)} : "
                       f"{_member(e, Win(jw=jw))})")
        elif jw:
            bad.append(f"{v} >= cw{_pm(span)}")
        blk.items.append(f"const int {e} = {expr};")
        blk.items.append(f"if ({' || '.join(bad)}) continue;")
        return blk, Ix(e, frozenset({v}), w, slot=(w, v))

    def loop_diag(self, parent, path, w, dd: int, ext: int):
        """A lane loop that derives the diagonal coordinate sub + lane + dd
        (skipping lanes past the width, and coordinates outside [0, ext) or
        window w).  Where w is an i-window only, the loop sits in an ``if``
        that skips it in a cell whose columns miss the window (all cells
        but the diagonal block's)."""
        v, e = self.name("i"), self.name("e")
        if isinstance(w, Win) and w.jw is None:
            a, b = w.iw
            parent = self.scope(
                parent, path, f"if (c.i{_pm(b - dd)} >= c.sub && "
                f"c.i{_pm(a - dd)} < c.sub + cw)", None, None, None)
            path = parent
        blk = self.scope(parent, path, f"for (int {v} = 0; {v} < C; ++{v})",
                         v, ("diag", w, dd, ext), "#pragma unroll")
        bad = ([f"{v} >= cw"] + ([f"{e} >= {ext}"] if ext < self.low.g.n + dd
                                 else []) + ([f"{e} < 0"] if dd < 0 else []))
        if not (w == FULL or (w.jw and w.jw[0] <= dd <= w.jw[1])):
            bad.append(f"!{_member(e, w)}")
        blk.items.append(f"const int {e} = c.sub + {v}{_pm(dd)};")
        blk.items.append(f"if ({' || '.join(bad)}) continue;")
        deps = frozenset({v})
        return (blk, Ix(v, deps, LANE, slot=(FULL, v)),
                Ix(e, deps, win_meet(w, Win(jw=(dd, dd))), (v, dd)))

    # -- what an index proves ----------------------------------------------
    @staticmethod
    def within(ix: Ix, w) -> bool:
        if w == FULL:
            return True
        if ix.tie and w.jw and w.jw[0] <= ix.tie[1] <= w.jw[1]:
            return True
        d = ix.dom
        return (isinstance(d, Win) and _inside(d.iw, w.iw)
                and _inside(d.jw, w.jw))

    @staticmethod
    def disjoint(ix: Ix, w: Win) -> bool:
        d = ix.dom
        return (isinstance(d, Win) and d.jw is None and d.iw is not None
                and w.jw is None and (w.iw is None or d.iw[1] < w.iw[0]
                                      or w.iw[1] < d.iw[0]))

    def guard(self, node: Node, idx):
        """(condition, its variables) under which node may be nonzero at
        idx beyond what idx proves ("" where it proves all), or (None, None)
        where it proves node zero there."""
        s = self.low.sup[node.id]
        conds, deps = [], frozenset()
        for ix, w in zip(idx, s.dims):
            if not isinstance(w, Win) or self.within(ix, w):
                continue
            if self.disjoint(ix, w):
                return None, None
            conds.append(_member(ix.code, w))
            deps |= ix.deps
        if s.diag:
            p, dd = s.diag
            jc = next(j for j, d in enumerate(node.shape) if d.chunk)
            ix, lane = idx[p], idx[jc]
            if ix.tie and ix.tie[0] == lane.code:
                if ix.tie[1] != dd:
                    return None, None
            else:
                conds.append(f"({lane.code} < cw && {ix.code} == c.sub + "
                             f"{lane.code}{_pm(dd)})")
                deps |= ix.deps | lane.deps
        return " && ".join(conds), deps

    # -- index arithmetic ----------------------------------------------------
    @staticmethod
    def flat(shape, idx, static_only=False) -> tuple:
        """Row-major offset of idx in shape (its static dims only), and its
        variables."""
        code, deps, stride = [], frozenset(), ""
        for d, ix in reversed(list(zip(shape, idx))):
            if static_only and d.chunk:
                continue
            deps |= ix.deps
            if ix.code != "0":
                code.append(f"{ix.code} * {stride}" if stride else ix.code)
            size = str(d.b) if static_only else d.code()
            stride = size if not stride else f"{stride} * {size}"
        return ("(" + " + ".join(reversed(code)) + ")") if code else "0", deps

    def view_index(self, node: Node, idx) -> list:
        """The source index of a view node's element idx."""
        spec, src = node.spec, node.args[0]
        kind = spec[0]
        if kind == "unsqueeze":
            return [e for j, e in enumerate(idx) if j != spec[1]]
        if kind == "squeeze":
            it = iter(idx)
            return [_ZERO if j in spec[1] else next(it)
                    for j in range(len(src.shape))]
        if kind == "select":
            out = list(idx)
            out.insert(spec[1], Ix(str(spec[2])))
            return out
        if kind == "slice":
            _, d, start, step = spec
            out = list(idx)
            ix = out[d]
            if (start, step) != (0, 1):
                if step == 1:
                    out[d] = Ix(f"({ix.code}{_pm(start)})", ix.deps,
                                ix.dom.shift(start) if isinstance(ix.dom, Win)
                                else ix.dom,
                                (ix.tie[0], ix.tie[1] + start) if ix.tie
                                else None)
                else:
                    out[d] = Ix(f"({start} + {step} * {ix.code})", ix.deps)
            return out
        if kind == "permute":
            out = [None] * len(idx)
            for j, p in enumerate(spec[1]):
                out[p] = idx[j]
            return out
        if kind == "expand":
            lead = len(node.shape) - len(src.shape)
            return [_ZERO if (s == Dim(0, 1) and node.shape[lead + j] != s)
                    else idx[lead + j] for j, s in enumerate(src.shape)]
        if kind == "reshape":
            if _simple_reshape(src.shape, node.shape):
                it = iter(e for d, e in zip(node.shape, idx)
                          if d != Dim(0, 1))
                return [_ZERO if d == Dim(0, 1) else next(it)
                        for d in src.shape]
            f, deps = self.flat(node.shape, idx)
            out, stride = [], ""
            for d in reversed(src.shape):
                q = f"({f} / ({stride}))" if stride else f
                out.append(Ix(f"({q} % {d.code()})", deps))
                stride = d.code() if not stride else f"{stride} * {d.code()}"
            return list(reversed(out))
        raise ValueError(f"unknown view {spec}")

    # -- values -------------------------------------------------------------
    def value(self, blk: _Block, node: Node, idx, own: bool = False):
        """(code, variables) of node's element idx in scope blk.  ``own``:
        compute a root or stored node (its own loop does) instead of reading
        its array or slot."""
        low = self.low
        zero = ("false" if node.dtype == "b" else "0.f"), frozenset()
        if low.sup[node.id].zero:
            return zero
        mode = low.mode[node.id]
        if mode == "view":
            return self.value(blk, node.args[0], self.view_index(node, idx))
        if mode == "free":
            return self.free(blk, node, idx)
        if not own and mode == "stored":
            return self.stored(blk, node, idx)
        if not own and mode == "root":
            return self.read_root(blk, node, idx)
        cond, gdeps = (self.guard(node, idx) if low.cellwise[node.id]
                       else ("", frozenset()))
        if cond is None:
            return zero
        alldeps = frozenset().union(*(ix.deps for ix in idx))
        if node.kind == "in":                       # di, dj: selections
            return (f"({cond} ? 1.f : 0.f)", gdeps) if cond else ("1.f",
                                                                  alldeps)
        key = (node.id, tuple(ix.code for ix in idx))
        hit = self.lookup(blk, key)
        if hit is not None:
            return hit
        if node.kind == "ew":
            args, deps = [], gdeps
            for a in node.args:
                if isinstance(a, Node):
                    code, dv = self.value(blk, a, idx)
                    deps |= dv
                else:
                    code = literal(a)
                args.append(code)
            code = self.ew_code(node.op, args)
            if cond:
                code = f"({cond} ? {code} : {zero[0]})"
            return self.temp(blk, key, code, deps, node.dtype, ops=1)
        code, deps = self.fused(blk, node, idx)
        if cond:
            return self.temp(blk, key, f"({cond} ? {code} : 0.f)",
                             deps | gdeps, node.dtype)
        return code, deps

    def free(self, blk, node, idx):
        if node.kind == "scalar":
            return literal(node.value, node.dtype), frozenset()
        f, deps = self.flat(node.shape, idx)
        key = ("free", node.id, f)
        hit = self.lookup(blk, key)
        if hit is not None:
            return hit
        if node.kind == "in":                           # val
            return self.temp(blk, key, f"s[{f}]", deps | self.sdeps, "f")
        code = f"CHESS_LDG(k + {node.offset} + {f})"
        code = f"({code} != 0.f)" if node.dtype == "b" else code
        return self.temp(blk, key, code, deps, node.dtype)

    def stored(self, blk, node, idx):
        f, deps = self.flat(node.shape, idx, static_only=True)
        key = ("slot", node.id, f)
        hit = self.lookup(blk, key)
        if hit is not None:
            return hit
        return self.temp(blk, key, f"s[{self.low.off[node.id]} + {f}]",
                         deps | self.sdeps, node.dtype)

    @staticmethod
    def ew_code(op: str, args) -> str:
        if op == "pow" and args[1] in ("2.0f", "1.0f", "0.5f", "-1.0f"):
            return {"2.0f": "({0} * {0})", "1.0f": "({0})",
                    "0.5f": "sqrtf({0})",
                    "-1.0f": "(1.f / {0})"}[args[1]].format(args[0])
        args = ["0.f" if a == "0.0f" else "1.f" if a == "1.0f" else a
                for a in args]
        if op == "add" and "0.f" in args:
            return args[1] if args[0] == "0.f" else args[0]
        if op == "sub" and args[1] == "0.f":
            return args[0]
        if op == "mul" and "0.f" in args:
            return "0.f"
        if op == "mul" and "1.f" in args:
            return args[1] if args[0] == "1.f" else args[0]
        return EW_OPS[op][1].format(*args)

    # -- arrays of the cell ---------------------------------------------------
    def axes(self, node: Node):
        """The array axes of a root: (dim position, size code, size at C)
        for each static dim but the diagonal one (a window's slots, or the
        extent), and the chunk dim."""
        s = self.low.sup[node.id]
        p = s.diag[0] if s.diag else None
        out = []
        for j, (d, w) in enumerate(zip(node.shape, s.dims)):
            if j == p:
                continue
            if d.chunk:
                out.append((j, d.code(), d.at))
            elif isinstance(w, Win):
                out.append((j, f"({w.slots()})", w.slots_at))
            else:
                out.append((j, str(d.b), lambda C, b=d.b: b))
        return out

    def declare(self, node: Node) -> None:
        axes = self.axes(node)
        size = " * ".join(c for _, c, _ in axes) or "1"
        self.top.items.append(f"float b{node.id}[{size}];")
        self.arrays.append(lambda C, a=axes: math.prod(f(C) for _, _, f in a))

    @staticmethod
    def offset(parts) -> str:
        """Row-major offset from (slot code, size code) pairs."""
        code, stride = [], ""
        for slot, size in reversed(parts):
            if slot != "0":
                code.append(f"{slot} * {stride}" if stride else slot)
            stride = size if not stride else f"{stride} * {size}"
        return "(" + " + ".join(reversed(code)) + ")" if code else "0"

    def slot_of(self, ix: Ix, w: Win):
        """(slot code, validity or None) of element ix in window w's
        slots, as the loop over w numbers them."""
        if ix.slot and ix.slot[0] == w:
            return ix.slot[1], None
        jw, iw = w.jw, w.iw
        proven = self.within(ix, w)
        in_j = ((isinstance(ix.dom, Win) and ix.dom.iw is None
                 and _inside(ix.dom.jw, jw))
                or (ix.tie and jw and jw[0] <= ix.tie[1] <= jw[1]))
        if jw:
            tj = f"({ix.code} - c.sub{_pm(jw[0])})"
            okj = f"({tj} >= 0 && {tj} < cw{_pm(jw[1] - jw[0])})"
        if iw:
            ti = f"({ix.code} - c.i{_pm(iw[0])})"
            oki = f"({ti} >= 0 && {ti} <= {iw[1] - iw[0]})"
        if jw and (in_j or not iw):
            return tj, None if (proven or in_j) else okj
        if not jw:
            return ti, None if proven else oki
        return (f"({okj} ? {tj} : {w.jslots()} + {ti})",
                None if proven else f"({okj} || {oki})")

    def read_root(self, blk, node: Node, idx):
        s = self.low.sup[node.id]
        parts, conds, deps = [], [], frozenset()
        for j, size, _ in self.axes(node):
            ix = idx[j]
            deps |= ix.deps
            w = s.dims[j]
            if isinstance(w, Win):
                slot, ok = self.slot_of(ix, w)
                if ok:
                    conds.append(ok)
            else:
                slot = ix.code
            parts.append((slot, size))
        if s.diag:
            cond, gdeps = self.guard(node, idx)
            if cond is None:
                return "0.f", frozenset()
            if cond:
                conds.append(cond)
            deps |= gdeps
        code = f"b{node.id}[{self.offset(parts)}]"
        if conds:
            code = f"({' && '.join(conds)} ? {code} : 0.f)"
        key = ("root", node.id, tuple(ix.code for ix in idx))
        hit = self.lookup(blk, key)
        if hit is not None:
            return hit
        return self.temp(blk, key, code, deps, node.dtype)

    def emit_root(self, node: Node) -> None:
        """An array of the cell: its loop nest over its own support."""
        if node.kind in ("sum", "mm"):
            self.reduction(node, self.top, self.top, None)
            return
        self.declare(node)
        s = self.low.sup[node.id]
        blk, idx = self.top, [None] * len(node.shape)
        p = s.diag[0] if s.diag else None
        for j, (d, w) in enumerate(zip(node.shape, s.dims)):
            if d.chunk or j == p:
                continue
            blk, idx[j] = (self.loop_slots(blk, blk, w, d.b)
                           if isinstance(w, Win) else
                           self.loop_full(blk, blk, d))
        for j, d in enumerate(node.shape):
            if d.chunk:
                if p is not None:
                    blk, idx[j], idx[p] = self.loop_diag(
                        blk, blk, s.dims[p], s.diag[1], node.shape[p].b)
                else:
                    blk, idx[j] = self.loop_full(blk, blk, d)
        code, _ = self.value(blk, node, idx, own=True)
        parts = [(idx[j].slot[1] if idx[j].slot else idx[j].code, size)
                 for j, size, _ in self.axes(node)]
        blk.items.append(f"b{node.id}[{self.offset(parts)}] = {code};")

    def fused(self, blk, node: Node, idx):
        """A reduction at its reader's static index: its accumulator,
        computed once in the scope that defines that index."""
        stat = [j for j, d in enumerate(node.shape) if not d.chunk]
        deps = frozenset().union(self.sdeps, *(idx[j].deps for j in stat))
        key = ("acc", node.id, tuple(idx[j].code for j in stat))
        hit = self.lookup(blk, key)
        acc = hit[0] if hit else self.reduction(
            node, self.home(blk, deps), blk, idx)
        jc = [j for j, d in enumerate(node.shape) if d.chunk]
        if jc:
            return f"{acc}[{idx[jc[0]].code}]", deps | idx[jc[0]].deps
        return acc, deps

    def reduction(self, node: Node, at: _Block, path: _Block, bound,
                  into=None):
        """A sum or mm: a root (``bound`` None: loops over its support,
        written to its array, or, for the output, added straight ``into``
        the returned hDual's dij lanes) or fused at ``bound`` (the reader's
        index; the accumulator placed in ``at``).  Reduced static dims loop
        over the operand's support; a reduced dim the operand ties to the
        output lane is derived from the lane."""
        low = self.low
        if node.kind == "sum":
            X = node.args[0]
            xs = low.sup[X.id]
            full, fsup = list(X.shape), list(xs.dims)
            red = list(node.dims)
            keep = [j for j in range(len(full)) if j not in red]
            tie = None
            oc = [j for j in keep if full[j].chunk]
            if xs.diag and xs.diag[0] in red and oc:
                tie = (xs.diag[0], oc[0], xs.diag[1])

            def body(b, fidx):
                return self.value(b, X, fidx)
            nops = 1
        else:
            A, B = node.args
            As, Bs = low.sup[A.id], low.sup[B.id]
            full = [A.shape[0], B.shape[1], A.shape[1]]
            fsup = [As.dims[0], Bs.dims[1],
                    LANE if As.dims[1] == LANE else win_meet(As.dims[1],
                                                             Bs.dims[0])]
            keep, red = [0, 1], [2]
            tie = None
            if Bs.diag and Bs.diag[0] == 0 and full[1].chunk:
                tie = (2, 1, Bs.diag[1])
            elif As.diag and As.diag[0] == 1 and full[0].chunk:
                tie = (2, 0, As.diag[1])

            def body(b, fidx):
                ea, da = self.value(b, A, [fidx[0], fidx[2]])
                eb, db = self.value(b, B, [fidx[2], fidx[1]])
                if "0.f" in (ea, eb):
                    return "0.f", da | db
                return self.ew_code("mul", [ea, eb]), da | db
            nops = 2
        oc = [j for j in keep if full[j].chunk]
        fidx = [None] * len(full)
        blk = at
        if bound is None and into is None:
            self.declare(node)
        if bound is None:
            s = low.sup[node.id]
            for q, j in enumerate(keep):
                if full[j].chunk:
                    continue
                w = s.dims[q]
                blk, fidx[j] = (self.loop_slots(blk, blk, w, full[j].b)
                                if isinstance(w, Win) else
                                self.loop_full(blk, blk, full[j]))
            path = blk
        else:
            for q, j in enumerate(keep):
                fidx[j] = bound[q]
        acc = into or self.name("a")
        if into:
            pass
        elif oc:
            self.place(blk, path, f"float {acc}[{full[oc[0]].code()}] = {{}};")
            self.arrays.append(full[oc[0]].at)
        else:
            self.place(blk, path, f"float {acc} = 0.f;")
            self.arrays.append(lambda C: 1)
        inner = blk

        def nest(parent, make):
            return make(parent, path if parent is blk else parent)
        for j in red:
            if full[j].chunk or (tie and tie[0] == j):
                continue
            w = fsup[j]
            inner, fidx[j] = nest(inner, lambda p, q, w=w, j=j: (
                self.loop_slots(p, q, w, full[j].b) if isinstance(w, Win)
                else self.loop_full(p, q, full[j])))
        for j in red:
            if full[j].chunk:
                inner, fidx[j] = nest(inner, lambda p, q, j=j:
                                      self.loop_full(p, q, full[j]))
        if oc:
            jc = oc[0]
            if tie and tie[1] == jc:
                inner, fidx[jc], fidx[tie[0]] = nest(
                    inner, lambda p, q: self.loop_diag(
                        p, q, fsup[tie[0]], tie[2], full[tie[0]].b))
            else:
                inner, fidx[jc] = nest(inner, lambda p, q:
                                       self.loop_full(p, q, full[jc]))
        code, _ = body(inner, fidx)
        if code != "0.f":
            tgt = f"{acc}[{fidx[oc[0]].code}]" if oc else acc
            inner.items.append(f"{tgt} += {code};")
            self.ledger.append((nops, inner))
        if bound is not None:
            stat = [j for j, d in enumerate(node.shape) if not d.chunk]
            at.memo[("acc", node.id, tuple(bound[j].code for j in stat))] = (
                acc, frozenset())
            return acc
        if into:
            return None
        oidx = [fidx[j] for j in keep]
        if oc:
            q = keep.index(oc[0])
            cp, oidx[q] = self.loop_full(blk, blk, full[oc[0]])
            src = f"{acc}[{oidx[q].code}]"
        else:
            cp, src = blk, acc
        parts = [(oidx[j].slot[1] if oidx[j].slot else oidx[j].code, size)
                 for j, size, _ in self.axes(node)]
        cp.items.append(f"b{node.id}[{self.offset(parts)}] = {src};")
        return None

    # -- the two functions ----------------------------------------------------
    def eval_body(self) -> list:
        low, g = self.low, self.low.g
        out = g.out
        self.top.items.append(f"const int cw = min(c.width, {g.n} - c.sub);")
        for nd in low.nodes:
            if (nd is not out and low.cellwise[nd.id]
                    and low.mode[nd.id] == "root"
                    and not low.sup[nd.id].zero):
                self.emit_root(nd)
        mode = low.mode[out.id]
        self.top.items.append("HDual<C> r = constant<C>(0.f);")
        if mode == "root":              # a sum or mm, added into r.dij
            if not low.sup[out.id].zero:
                self.reduction(out, self.top, self.top, None, into="r.dij")
        else:
            blk, ix = self.loop_full(self.top, self.top, out.shape[0])
            code, _ = self.value(blk, out, [ix], own=(mode == "out"))
            blk.items.append(f"r.dij[{ix.code}] = {code};")
        self.top.items.append("return r;")
        return self.top.render(2)

    def instance_body(self) -> list:
        """Each stored node, a thread per (instance, element), in levels
        with a barrier after each."""
        low = self.low
        for L in sorted(set(low.level.values())):
            for x in (x for x in low.stored if low.level[x.id] == L):
                E = static_numel(x.shape)
                t = self.name("i")
                blk = _Block(self.top, t, f"for (int {t} = CHESS_TID; {t} < "
                             f"nin * {E}; {t} += CHESS_NTHREADS)",
                             ("full", E))
                self.top.items.append(blk)
                deps = frozenset({t})
                if E == 1:
                    blk.items.append(f"float* s = inst + {t} * slot;")
                    e = "0"
                else:
                    blk.items += [f"const int q = {t} / {E};",
                                  f"const int e = {t} - q * {E};",
                                  "float* s = inst + q * slot;"]
                    e = "e"
                self.sdeps = deps
                idx, stride = [None] * len(x.shape), 1
                for j in reversed(range(len(x.shape))):
                    d = x.shape[j]
                    if d.chunk or d.b == 1:
                        idx[j] = _ZERO
                        continue
                    q = e if stride == 1 else f"({e} / {stride})"
                    idx[j] = Ix(q if stride * d.b == E else f"({q} % {d.b})",
                                deps)
                    stride *= d.b
                code, _ = self.value(blk, x, idx, own=True)
                blk.items.append(f"s[{low.off[x.id]} + {e}] = {code};")
            self.top.items.append("CHESS_SYNC();")
        return self.top.render(2)

    # -- counts ---------------------------------------------------------------
    def count(self, C: int, rows, starts, widths) -> np.ndarray:
        """Operations of this function's code at each cell: every ledger
        entry times the valid trips of the loops around it."""
        i, sub, w = (np.asarray(a, np.int64).reshape(-1, 1)
                     for a in (rows, starts, widths))
        trips: dict = {}

        def mult(blk):
            if blk is None:
                return np.ones(len(i))
            key = id(blk)
            if key not in trips:
                trips[key] = mult(blk.parent) * self.trips(blk.loop, C, i,
                                                           sub, w)
            return trips[key]
        total = np.zeros(len(i))
        for ops, blk in self.ledger:
            total += ops * mult(blk)
        return total.astype(np.int64)

    @staticmethod
    def trips(loop, C, i, sub, w):
        if loop is None:
            return 1
        kind = loop[0]
        if kind == "full":
            return loop[1]
        if kind == "lanes":
            return loop[1] * C
        if kind == "slots":
            _, win, ext = loop
            e = np.arange(ext)[None, :]
            return _member_np(win, e, i, sub, w).sum(axis=1)
        _, win, dd, ext = loop                      # diag
        lane = np.arange(C)[None, :]
        e = sub + lane + dd
        ok = (lane < w) & (e >= 0) & (e < ext) & _member_np(win, e, i, sub, w)
        return ok.sum(axis=1)


def lowering(graph: Graph) -> Lowering:
    """The graph's lowering, made once per graph."""
    low = graph.__dict__.get("_lowering")
    if low is None:
        low = graph.__dict__["_lowering"] = Lowering(graph)
    return low


def cell_operations(graph: Graph, C: int, rows, starts, widths):
    """fp32 operations the generated ``eval<C>`` runs at each cell (row i,
    columns start .. start + width - 1 below n), counted from the graph
    where the code computes it: an elementwise node one, a sum one per
    term, an mm two; views, seeds, constants, slot reads and guards
    nothing."""
    return lowering(graph).cell_operations(C, rows, starts, widths)


def instance_operations(graph: Graph) -> int:
    """fp32 operations of the instance pass, once an instance."""
    return lowering(graph).instance_operations()


def local_floats(graph: Graph, C: int) -> int:
    """Floats per thread of the cell's arrays and accumulators at C
    lanes."""
    return lowering(graph).local_floats(C)


def lanes_that_fit(graph: Graph) -> tuple:
    """The lane instantiations whose local arrays fit ``LOCAL_MAX``."""
    return tuple(C for C in LANES if 4 * local_floats(graph, C) <= LOCAL_MAX)


_TEMPLATE = """\
// Generated by repro_torch/kernels/codegen.py from a traced cell of f at
// n = {n}: the structural evaluation of the Pallas body's graph (an
// instance pass, then each cell over its seeds' support only), as a device
// form of csrc/chess_hvp.cuh's kernel template.  Operations: {ops}.
#include "chess_hvp.cuh"

namespace chessfad {{

struct Traced {{
  static constexpr bool kOwnCells = true;  // its cells read the constants k
  static constexpr bool kStages = false;   // nothing staged but the rows
  // a, v, out, then {stored} rows of f's values once an instance; scalars
  static constexpr int kRows = {rows}, kScalars = {scalars};
  static constexpr int kN = {n};
  // the lane widths built: {lanes} (the others' local arrays pass
  // LOCAL_MAX = {local_max} bytes a thread)
  static constexpr unsigned kLaneMask = {mask}u;

  template <int C>
  __host__ __device__ static constexpr int table_floats() {{ return 0; }}

  __device__ static void table(float, float*, int, int) {{}}

  // the values no seed reaches, into each instance's slot, once an instance
  template <bool S>
  __device__ static void instance(float* inst, int slot, int, int nin, int,
                                  const float* k, const float*, int,
                                  const float*) {{
{instance}
  }}

  // f's hDual on one cell: s holds the instance's slot, k the constants
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
// the instance pass and every cell on the host, float32 A, V and out (the
// CPU check)
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
    low = lowering(graph)
    lanes = lanes_that_fit(graph)
    mask = sum(1 << LANES.index(C) for C in lanes)
    ops = (f"{low.instance_operations()} an instance, at most "
           f"{int(low.cell_operations(1, [0], [0], [1]).max())} a cell at "
           f"C = 1 (row 0, column 0)")
    return _TEMPLATE.format(
        n=graph.n, body="\n".join(low.eval_lines),
        instance="\n".join(low.instance_lines), ops=ops,
        stored=low.rows - 3, rows=low.rows, scalars=low.scalars,
        nconst=int(graph.consts.size),
        lanes=", ".join(map(str, lanes)) or "none", local_max=LOCAL_MAX,
        mask=hex(mask))
