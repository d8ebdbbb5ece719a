"""Public wrappers for the CUDA kernels, and the engine's ``cuda`` backend.

Counterpart of ``repro.kernels.ops``.  A target function exposes its kernel
form through attributes (see ``core.testfns``): ``kernel_fn``/
``kernel_consts`` (the plain kernel form and its constants, the reference's
``pallas_fn``/``pallas_consts``).  The ``cuda`` backend and ``chess_hvp``
run every f, the paper's three test functions included, on the device form
generated from a trace of its kernel form (``kernels/trace.py``), as the
Pallas kernel evaluates f itself in its body.  ``device_fn`` names a test
function's hand-written CUDA device form, which only an explicit
``chess_hvp_cuda(..., device_fn=name)`` reaches.  ``hdual_linear`` and
``hdual_linear_apply`` are the reference's entry points of the fused hDual
linear map, without ``interpret``.  Importing this module builds and loads
nothing: a kernel is compiled at its first launch.
"""

from __future__ import annotations

from repro_torch.core import testfns
from repro_torch.engine.registry import BackendSpec, register_backend

from .chess_hvp import (chess_hvp_cuda, is_instance_block, lanes_for,
                        supports)
from .hdual_linear import hdual_linear_apply_cuda, hdual_linear_cuda
from .trace import TraceRefused, traced_form

__all__ = ["chess_hvp", "hdual_linear", "hdual_linear_apply", "kernel_form",
           "backend_form"]


def kernel_form(f):
    """(kernel_fn, consts, device_fn) for any engine target function;
    device_fn is None when f has no hand-written CUDA device form."""
    return (getattr(f, "kernel_fn", f),
            tuple(getattr(f, "kernel_consts", ())),
            getattr(f, "device_fn", None))


def backend_form(f, n: int):
    """The device form the ``cuda`` backend runs f on at n: the one
    generated from a trace of f's kernel form (``trace.traced_form``,
    cached); raises TraceRefused with the reason."""
    kf, consts, _ = kernel_form(f)
    return traced_form(kf, consts, n)


# ---------------------------------------------------------------------------
# engine backend: the paper's Fig. 2 L2 kernel
# ---------------------------------------------------------------------------

def _cuda_supports(plan, workload):
    """True, or why the ``cuda`` backend cannot run the plan.  It runs a
    flat CUDA plan without a mesh on ``backend_form(f, n)`` where f traces
    and the form fits at the plan's n and csize (shared memory,
    ``LOCAL_MAX`` bytes of local memory a thread: ``chess_hvp.supports``,
    the wrapper's own test), with a ``blk_m`` option (instances per CTA)
    that ``chess_hvp.instance_blocks`` lists for that form, or none.
    Otherwise ``auto`` resolves to ``vmap_l2`` and an explicit ``cuda`` is
    refused at resolution with the reason.  ``plan()`` refuses a ``blk_m``
    on a card plan before it gets here; the veto keeps the tuner's grid to
    candidates the kernel takes."""
    if plan.device.type != "cuda":
        return f"the plan is on {plan.device}, not a CUDA device"
    if plan.mesh is not None or plan.n is None:
        return ("a mesh or pytree plan (the kernel takes one flat (m, n) "
                "batch)")
    try:
        form = backend_form(plan.f, plan.n)
    except TraceRefused as e:
        return f"f's trace is refused: {e}"
    if not supports(form, plan.n, plan.csize):
        return (form.refusal(plan.n, lanes_for(plan.csize))
                or f"the traced form of f at n={plan.n} needs more shared "
                   f"memory than a CTA has")
    blk_m = plan.opt("blk_m")
    if blk_m is not None and not is_instance_block(form, plan.n, plan.csize,
                                                   blk_m):
        return (f"blk_m={blk_m!r} is not one of the instance blocks of f's "
                f"traced form at n={plan.n}, csize={plan.csize}")
    return True


def _cuda_make(plan, workload):
    kf, consts, _ = kernel_form(plan.f)
    # the reference's option name: for the pallas backend its instance
    # block, here the kernel's instances per CTA (None: the wrapper's pick)
    ipb = plan.opt("blk_m")

    def run(A, V):
        # the constants as they are at this call, as the reference passes
        # them to its kernel at every call (the form moves them itself,
        # when they change)
        return chess_hvp_cuda(kf, A, V, plan.csize, consts=consts,
                              symmetric=plan.symmetric, ipb=ipb)
    return run


register_backend(BackendSpec(
    name="cuda", make=_cuda_make, workloads=frozenset({"batched_hvp"}),
    # supports() keeps it off every non-CUDA plan, so it never wins on CPU
    priority=40, supports=_cuda_supports,
    doc="Fig. 2 L2 kernel in CUDA C++ for sm_90a (symmetric + ragged, any "
        "csize, float32/bfloat16/float16 inputs computed in float32); as "
        "the Pallas kernel evaluates any hmath-written f in its body, it "
        "evaluates every f, the paper's test functions included, through "
        "a device form generated from a trace of f at the plan's n "
        "(structural evaluation: an instance pass into shared memory, each "
        "cell over its seeds' support; built by nvcc at the first launch of "
        "each (f, n); option blk_m = instances per CTA, swept by the tuner; "
        "refused, with the reason, where f does not trace, its slot passes "
        "shared memory or the form needs more than LOCAL_MAX bytes of local "
        "memory a thread)"))


def chess_hvp(A, V, *, function: str = "rosenbrock", csize: int = 4,
              symmetric: bool = False):
    """Batched HVP on one of the paper's test-function families, through
    the backend's generated form of it.

    A, V: (m, n) float32, bfloat16 or float16 -> (m, n) in A.dtype.  CUDA
    tensors run the kernel, CPU tensors its plain version."""
    kf, consts, _ = kernel_form(testfns.FUNCTIONS[function](A.shape[-1]))
    return chess_hvp_cuda(kf, A, V, csize, consts=consts,
                          symmetric=symmetric)


def hdual_linear(x, w, *, bt: int = 128, bo: int = 128, bk: int = 128):
    """Fused hDual component matmul: x (K2, T, din) @ w (din, dout) ->
    (K2, T, dout) in x.dtype.  The tiles are the reference's: clamped to the
    dims, they must divide them."""
    return hdual_linear_cuda(x, w, bt=bt, bo=bo, bk=bk)


def hdual_linear_apply(hd, w, **kw):
    """Apply the fused kernel to an HDual whose value shape is (din,) or
    (T, din): ONE kernel launch maps val, di, dj and dij through w, every
    component contracting the same W tiles, reading them where they lie and
    writing the result's components (contiguous) directly, with no stacking
    copy.  Equivalent to hmath.matvec_const(w.T, hd) for vectors.  The last
    value axis is din, as in the reference; the tiles (bt, bo, bk) are
    checked as the reference checks them."""
    return hdual_linear_apply_cuda(hd, w, **kw)
