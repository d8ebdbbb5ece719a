"""LM-scale curvature engine: chunked Hessian-vector products on parameter
trees (dicts of tensors).

Counterpart of ``repro.core.curvature``, on ``torch.func``.  The paper's
workload is "many HVPs at many data points, computed in chunks"; at LM
scale the probe batch plays the chunk role:

  - ``pytree_hvp``      : one HVP, forward-over-reverse (``jvp`` of
                          ``grad``);
  - ``pytree_hvp_fwd``  : PURE-FORWARD w^T H v (``jvp`` of ``jvp``), the
                          hDual-equivalent path with no reverse sweep;
  - ``hutchinson_diag`` : diag(H) ~ E[v * Hv] over Rademacher probes,
                          ``csize`` probes at a time vmapped through one
                          linearization (the primal pass is shared by the
                          chunk: ``vmap`` batches only the tangents);
  - ``ggn_hvp`` / ``ggn_diag`` / ``empirical_fisher_vp`` : the structured
                          curvature products of the loss split;
  - ``block_hessian``   : the dense Hessian of one small parameter block by
                          the paper's chunked hDual algorithm.

Probes.  The reference's key is a JAX PRNG key; here it is an integer
seed.  A seed draws its probe sequence from a ``torch.Generator`` on the
device of the parameters, in the reference's order -- chunk by chunk, then
probe by probe, leaf by leaf within a probe -- so one seed on one device
always draws the same sequence, whatever the chunk size, and a budget ``p``
averages the first ``p`` probes of it.  The sequence differs from JAX's
and between devices; ``_diag_from_probes`` takes an explicit stacked probe
tree instead of a seed (the parity tests feed JAX's own draws through it).

Chunks run one after the other (a Python loop where the reference vmaps
over chunks): at LM scale one chunk's probes, tangents and activations are
what fits, and the per-chunk means are summed as they come.
"""

from __future__ import annotations

import torch
from torch.func import grad, jvp, vjp, vmap
from torch.utils import _pytree as pytree

from repro_torch.core.funclock import func_locked
from repro_torch.engine.registry import BackendSpec, register_backend

__all__ = ["pytree_hvp", "pytree_hvp_fwd", "hutchinson_diag",
           "rademacher_like", "block_hessian",
           "ggn_hvp", "ggn_diag", "empirical_fisher_vp",
           "hutchinson_diag_budgeted", "ggn_diag_budgeted"]


def _tmap(fn, *trees):
    return pytree.tree_map(fn, *trees)


def _match_dtypes(tree, like):
    """``tree`` with each leaf in the dtype of ``like``'s leaf (a no-op
    where they agree): head-gradient cotangents onto the model-output
    dtypes (the fp32-stable head can promote), tangents onto the
    parameters'."""
    return _tmap(lambda c, z: c.to(z.dtype), tree, like)


@func_locked
def pytree_hvp(f, params, v):
    """(H @ v) for scalar f(params); fwd-over-rev: jvp of grad.  Each leaf
    comes back in its parameter's dtype: torch.func can promote the
    tangent of a product with a Python scalar to float64."""
    return _match_dtypes(jvp(grad(f), (params,), (v,))[1], params)


@func_locked
def pytree_hvp_fwd(f, params, v, w=None):
    """Pure-forward second directional derivative w^T H v, with NO reverse
    sweep: nested jvp, the hDual four-component structure <f, f_i, f_j,
    f_ij> written as jvp of jvp (w plays x_i, v plays x_j).  w defaults to
    v (v^T H v)."""
    w = v if w is None else w

    def dir_grad(p):
        return jvp(f, (p,), (v,))[1]          # v-directional derivative

    return jvp(dir_grad, (params,), (w,))[1]


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------

def _device_of(tree) -> torch.device:
    leaves = pytree.tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def _generator(key, device) -> torch.Generator:
    """A generator on ``device`` for an int seed (a 0-d tensor or numpy
    integer is read as its value); a Generator passes through.  ``meta``
    tensors (``launch.dryrun``'s stand-ins) hold no values and have no
    generator of their own: they draw from a host one."""
    if isinstance(key, torch.Generator):
        return key
    device = torch.device(device)
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(int(key))
    return gen


def rademacher_like(key, tree):
    """A tree of +-1 entries shaped like ``tree``, each leaf in its leaf's
    dtype, drawn leaf by leaf (in tree order) from ``key``: an int seed or
    a ``torch.Generator`` on the tree's device (which then advances)."""
    gen = _generator(key, _device_of(tree))
    return _tmap(lambda l: torch.empty(l.shape, dtype=torch.float32,
                                       device=l.device)
                 .bernoulli_(0.5, generator=gen).mul_(2).sub_(1)
                 .to(l.dtype), tree)


def _stack(trees):
    if len(trees) == 1:
        return _tmap(lambda l: l.unsqueeze(0), trees[0])
    return _tmap(lambda *ls: torch.stack(ls), *trees)


def _seed_chunks(params, key, n_probes: int, csize: int):
    """The probe chunks of a seed: n_probes / csize stacked (csize, ...)
    trees, drawn lazily chunk by chunk, probe by probe."""
    gen = _generator(key, _device_of(params))
    for _ in range(n_probes // csize):
        yield _stack([rademacher_like(gen, params) for _ in range(csize)])


def _probe_chunks(probes, csize: int):
    """The chunks of an explicit stacked (n_probes, ...) probe tree."""
    n_probes = pytree.tree_leaves(probes)[0].shape[0]
    for j in range(n_probes // csize):
        yield _tmap(lambda l: l[j * csize:(j + 1) * csize], probes)


def _check_chunking(n_probes: int, csize: int) -> None:
    if csize < 1 or n_probes % csize != 0:
        raise ValueError(f"diag needs csize | n_probes; got csize={csize}, "
                         f"n_probes={n_probes}")


# ---------------------------------------------------------------------------
# the chunked Hutchinson estimate
# ---------------------------------------------------------------------------

def _chunked(vp, chunks, n_probes: int, csize: int, p=None):
    """mean_k v_k * vp(v_k) over the probe chunks: each chunk's ``csize``
    probes vmapped through ``vp`` (one primal pass), its per-chunk mean
    summed as it comes, the sum divided by the chunk count.

    ``p`` (an int, or an integer tensor, 1 <= p <= n_probes) is a probe
    budget: the estimate then averages only the FIRST p probes of the same
    sequence.  Both estimates come from one pass over the chunks -- each
    chunk masks its members with global probe index < p -- and the result
    is selected with ``torch.where(p >= n_probes, full, budgeted)``, so at
    p == n_probes it is bitwise the unbudgeted estimate (the same op
    sequence), and requests with different budgets share one program."""
    _check_chunking(n_probes, csize)
    full = msum = None
    budget = None
    for j, probes in enumerate(chunks):
        hvs = vmap(vp)(probes)
        contrib = _tmap(torch.mul, probes, hvs)
        del hvs
        mean = _tmap(lambda c: c.mean(0), contrib)
        full = mean if full is None else _tmap(torch.Tensor.add_, full, mean)
        if p is not None:
            dev = _device_of(contrib)
            if budget is None:
                budget = torch.as_tensor(p, device=dev)
            mask = (j * csize + torch.arange(csize, device=dev)) < budget
            part = _tmap(lambda c: torch.where(
                mask.reshape((csize,) + (1,) * (c.dim() - 1)), c,
                torch.zeros((), dtype=c.dtype, device=dev)).sum(0), contrib)
            msum = part if msum is None else _tmap(torch.Tensor.add_, msum,
                                                   part)
            del part
        # nothing of this chunk but the two sums stays live beside the
        # next chunk's work (at LM scale each tree is parameter-sized)
        del contrib, probes, mean
    nchunk = n_probes // csize
    full = _tmap(lambda e: e / nchunk, full)
    if p is None:
        return full
    return _tmap(lambda a, s: torch.where(budget >= n_probes, a,
                                          s / budget), full, msum)


def _hvp_map(f, params):
    return lambda v: pytree_hvp(f, params, v)


def _gvp_map(model_fn, head_loss, params):
    """v -> G v through ONE vjp of the model (its J^T is shared by every
    probe of a chunk); J v is a jvp of the model, the head Hessian a jvp of
    the head's grad."""
    z, model_vjp = vjp(model_fn, params)
    head_grad = grad(head_loss)

    def gvp(v):
        Jv = jvp(model_fn, (params,), (v,))[1]
        HJv = jvp(head_grad, (z,), (Jv,))[1]
        return model_vjp(_match_dtypes(HJv, z))[0]

    return gvp


@func_locked
def _diag_from_probes(vp, probes, csize: int, p=None):
    """The chunked estimate of mean_k v_k * vp(v_k) over an explicit
    stacked (n_probes, ...) probe tree, in chunks of ``csize`` (with the
    probe budget ``p`` as ``_chunked``).  Build ``vp`` with ``_hvp_map``
    (Hessian) or ``_gvp_map`` (GGN)."""
    n_probes = pytree.tree_leaves(probes)[0].shape[0]
    return _chunked(vp, _probe_chunks(probes, csize), n_probes, csize, p)


@func_locked
def hutchinson_diag(f, params, key, n_probes: int = 4, csize: int = 4):
    """diag(H) ~ mean_k v_k * (H v_k), Rademacher v drawn from the seed
    ``key``; ``csize`` probes at a time vmapped through one linearization.
    n_probes must be divisible by csize."""
    _check_chunking(n_probes, csize)
    return _chunked(_hvp_map(f, params),
                    _seed_chunks(params, key, n_probes, csize),
                    n_probes, csize)


@func_locked
def hutchinson_diag_budgeted(f, params, key, p, n_probes: int = 4,
                             csize: int = 4):
    """``hutchinson_diag`` honoring a probe budget ``p <= n_probes``: the
    mean of the first p probes of the full-budget sequence; bitwise
    ``hutchinson_diag`` at p == n_probes.  The service's ``batched_diag``
    runs it per row."""
    _check_chunking(n_probes, csize)
    return _chunked(_hvp_map(f, params),
                    _seed_chunks(params, key, n_probes, csize),
                    n_probes, csize, p)


# ---------------------------------------------------------------------------
# structured curvature: GGN and empirical Fisher
# ---------------------------------------------------------------------------

@func_locked
def ggn_hvp(model_fn, head_loss, params, v):
    """Generalized Gauss-Newton product  G v = (J^T H_head J) v.

    model_fn  : params -> network outputs z (logits; a tensor or a tree)
    head_loss : z -> scalar loss (the convex head)

    J v is a jvp of the model, the head Hessian a jvp of the head's grad
    (never materialized), J^T a vjp of the model.  G drops the
    model-curvature term of the full Hessian, is exact for linear models,
    and is PSD whenever the head is convex."""
    return _gvp_map(model_fn, head_loss, params)(v)


@func_locked
def ggn_diag(model_fn, head_loss, params, key, n_probes: int = 4,
             csize: int = 4):
    """Hutchinson estimate of diag(G), the chunked schedule of
    ``hutchinson_diag`` applied to the GGN (one model vjp shared by every
    probe)."""
    _check_chunking(n_probes, csize)
    return _chunked(_gvp_map(model_fn, head_loss, params),
                    _seed_chunks(params, key, n_probes, csize),
                    n_probes, csize)


@func_locked
def ggn_diag_budgeted(model_fn, head_loss, params, key, p,
                      n_probes: int = 4, csize: int = 4):
    """``ggn_diag`` honoring a probe budget ``p`` (see
    ``hutchinson_diag_budgeted``)."""
    _check_chunking(n_probes, csize)
    return _chunked(_gvp_map(model_fn, head_loss, params),
                    _seed_chunks(params, key, n_probes, csize),
                    n_probes, csize, p)


@func_locked
def empirical_fisher_vp(per_example_fn, params, v):
    """Empirical Fisher-vector product  F v = (1/B) sum_b g_b (g_b . v).

    per_example_fn : params -> (B,) per-example losses.  F v is ONE jvp
    (the per-example directional derivatives J_L v) and ONE vjp (J_L^T);
    the B gradient outer products are never materialized."""
    losses, loss_vjp = vjp(per_example_fn, params)
    Jv = jvp(per_example_fn, (params,), (v,))[1]          # (B,)
    B = losses.shape[0]
    return loss_vjp(_match_dtypes(Jv / B, losses))[0]


# ---------------------------------------------------------------------------
# dense block Hessian
# ---------------------------------------------------------------------------

def _hmath_native(f_of_block, a) -> bool:
    """Whether ``f_of_block`` evaluates on hDual numbers: one evaluation at
    a constant hDual, which must return an ``HDual``.  A function written
    against torch ops fails there (with whatever a torch op raises when
    handed an HDual) or returns something else."""
    from repro_torch.core.hdual import HDual, lift
    try:
        return isinstance(f_of_block(lift(a, 1)), HDual)
    except Exception:
        return False


@func_locked
def block_hessian(f, params, block_path: str, csize: int = 8,
                  symmetric: bool = True, hdual=None):
    """Dense Hessian of f w.r.t. ONE parameter block, every other parameter
    frozen, by the paper's chunked (row, chunk) schedule.

    block_path : '/'-joined key path to a leaf (flattened row-major).
    hdual      : True runs the hDual engine (``core.api.hessian``) on an
                 hmath-native f, which reads the block variables-first
                 (value shape (n, *S), as ``core.api``'s schedules
                 require); False runs the chunked forward-over-forward
                 fallback (``torch.func.jvp`` of ``jvp``, the same (row,
                 chunk) schedule and evaluation count) on any torch
                 function; None (the default) decides by evaluating f once
                 at a constant hDual (``_hmath_native``)."""
    from repro_torch.core.api import chunk_pairs
    from repro_torch.core.api import hessian as chess_hessian
    from repro_torch.models.params import flatten, unflatten

    flat = flatten(params)
    block = flat[block_path]
    shape = tuple(block.shape)
    a = block.reshape(-1)
    n = a.numel()

    def f_of_block(b):
        flat2 = dict(flat)
        flat2[block_path] = b.reshape(shape + tuple(b.shape[1:]))
        return f(unflatten(flat2))

    if hdual is None:
        hdual = _hmath_native(f_of_block, a)
    if hdual:
        return chess_hessian(f_of_block, a, csize=csize, symmetric=symmetric)

    pairs = chunk_pairs(n, csize, symmetric)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    chunks = []
    for i, c in pairs:
        vs = eye[[min(c + k, n - 1) for k in range(csize)]]   # (csize, n)

        def gi(x, i=int(i)):
            return jvp(f_of_block, (x,), (eye[i],))[1]

        chunks.append(vmap(lambda v: jvp(gi, (a,), (v,))[1])(vs))
    chunks = torch.stack(chunks)                               # (P, csize)
    rows = torch.as_tensor(pairs[:, 0], device=a.device)
    cols = (torch.as_tensor(pairs[:, 1], device=a.device)[:, None]
            + torch.arange(csize, device=a.device)[None, :])
    valid = cols < n
    cols = cols.clamp(max=n - 1)
    rr = rows[:, None].expand(cols.shape)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    H = torch.zeros((n, n), dtype=a.dtype, device=a.device)
    H.index_put_((rr, cols), torch.where(valid, chunks, zero),
                 accumulate=True)
    if symmetric:
        upper = (cols // csize > (rows // csize)[:, None]) & valid
        H.index_put_((cols, rr), torch.where(upper, chunks, zero),
                     accumulate=True)
    return H


# ---------------------------------------------------------------------------
# engine backends: the LM-scale pytree paths, behind the same registry and
# callable cache as the flat-vector schedules
# ---------------------------------------------------------------------------

def _diag_setup(plan):
    n_probes = int(plan.opt("n_probes", 4))
    if n_probes % max(plan.csize, 1) != 0:
        raise ValueError(
            f"diag workload needs csize | n_probes; got csize="
            f"{plan.csize}, n_probes={n_probes}")
    diag_of = plan.opt("diag_of", "hessian")
    if diag_of not in ("hessian", "ggn"):
        raise ValueError(
            f"diag_of must be 'hessian' or 'ggn', got {diag_of!r}")
    return n_probes, diag_of


def _pytree_diag_fn(plan):
    """The single-point diag callable (params, key) for a plan: Hutchinson
    over the full Hessian, or over the GGN when ``diag_of="ggn"``."""
    n_probes, diag_of = _diag_setup(plan)
    if diag_of == "ggn":
        mf, hl = plan.opt("model_fn"), plan.opt("head_loss")
        return lambda params, key: ggn_diag(
            mf, hl, params, key, n_probes=n_probes, csize=plan.csize)
    return lambda params, key: hutchinson_diag(
        plan.f, params, key, n_probes=n_probes, csize=plan.csize)


def _pytree_diag_budgeted_fn(plan):
    """The budget-honoring diag callable (params, key, p): the
    ``batched_diag`` per-row function."""
    n_probes, diag_of = _diag_setup(plan)
    if diag_of == "ggn":
        mf, hl = plan.opt("model_fn"), plan.opt("head_loss")
        return lambda params, key, p: ggn_diag_budgeted(
            mf, hl, params, key, p, n_probes=n_probes, csize=plan.csize)
    return lambda params, key, p: hutchinson_diag_budgeted(
        plan.f, params, key, p, n_probes=n_probes, csize=plan.csize)


def _rows(spec, fn, A, device, *per_row):
    """(k, size) stacked raveled trees -> (k, size) on ``device``: ``fn``
    on each row's tree, raveled into one output.

    Rows run one after the other, not vmapped: each row is a whole
    parameter tree, and a vmapped row axis would multiply the model's live
    activations by the bucket (at LM scale one row is what fits).  ``A``
    may stay on the host (the service's pytree buckets do): each row
    reaches ``device`` as its own tree, so the card never holds the
    bucket's other rows beside one row's work."""
    out = None
    for i in range(A.shape[0]):
        tree = fn(spec.unravel_tensor(A[i], device),
                  *(x[i] for x in per_row))
        if out is None:         # after the first row: not beside its work
            out = torch.empty((A.shape[0], spec.size),
                              dtype=spec.torch_ravel_dtype, device=device)
        spec.ravel_tensor(tree, out=out[i])
        del tree
    return out


def _pytree_fwdrev_make(plan, workload):
    return func_locked(_pytree_fwdrev_callable(plan, workload))


def _pytree_fwdrev_callable(plan, workload):
    f = plan.f
    if workload == "hvp":
        return lambda params, v: pytree_hvp(f, params, v)
    if workload == "ggn":
        mf, hl = plan.opt("model_fn"), plan.opt("head_loss")
        return lambda params, v: ggn_hvp(mf, hl, params, v)
    if workload == "fisher":
        pex = plan.opt("per_example_fn")
        return lambda params, v: empirical_fisher_vp(pex, params, v)
    if workload == "diag":
        return _pytree_diag_fn(plan)
    if workload == "batched_hvp":
        # service-coalesced pytree HVPs: rows are RAVELED trees (see
        # engine/pytree.py), unraveled on the device as views of the row
        spec = plan.opt("pytree_spec")

        def one_hvp(params, v_row):
            return pytree_hvp(f, params, spec.unravel_tensor(v_row,
                                                             plan.device))

        return lambda A, V: _rows(spec, one_hvp, A, plan.device, V)
    if workload == "batched_diag":
        # (A, K, P): raveled param rows, seed rows, per-request probe
        # budgets (<= the plan's n_probes) -- the service honors each
        # request's n_probes= without splitting the bucket
        spec = plan.opt("pytree_spec")
        point = _pytree_diag_budgeted_fn(plan)
        return lambda A, K, P: _rows(spec, point, A, plan.device, K, P)
    raise KeyError(workload)


def _pytree_fwdrev_supports(plan, workload):
    """Veto combinations whose required plan options are missing: the GGN
    split (model_fn/head_loss), the Fisher per-example loss, and the ravel
    spec for the service-coalesced batched forms."""
    needs_split = (workload == "ggn"
                   or (workload in ("diag", "batched_diag")
                       and plan.opt("diag_of", "hessian") == "ggn"))
    if needs_split and (plan.opt("model_fn") is None
                        or plan.opt("head_loss") is None):
        return False
    if workload == "fisher" and plan.opt("per_example_fn") is None:
        return False
    if (workload in ("batched_hvp", "batched_diag")
            and plan.opt("pytree_spec") is None):
        return False
    return True


register_backend(BackendSpec(
    name="pytree_fwdrev", make=_pytree_fwdrev_make,
    workloads=frozenset({"hvp", "diag", "ggn", "fisher",
                         "batched_hvp", "batched_diag"}),
    priority=-10, flat_only=False, supports=_pytree_fwdrev_supports,
    doc="jvp-of-grad on parameter trees; diag = chunked Hutchinson "
        "(of H or the GGN); ggn/fisher = structured curvature products; "
        "batched_* = service-coalesced raveled rows"))


def _pytree_fwd_make(plan, workload):
    f = plan.f
    return func_locked(lambda params, v, w: pytree_hvp_fwd(f, params, v, w))


register_backend(BackendSpec(
    name="pytree_fwd", make=_pytree_fwd_make,
    workloads=frozenset({"quadform"}), priority=-20, flat_only=False,
    doc="pure-forward w^T H v (no reverse sweep, no activation storage)"))
