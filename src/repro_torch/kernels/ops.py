"""Public wrappers for the CUDA kernels, and the engine's ``cuda`` backend.

Counterpart of ``repro.kernels.ops``.  A target function exposes its kernel
forms through attributes (see ``core.testfns``): ``kernel_fn``/
``kernel_consts`` (the plain kernel form and its constants, the reference's
``pallas_fn``/``pallas_consts``) and ``device_fn`` (the name of its
hand-written CUDA device form).  Any other hmath-written f runs on a device
form generated from a trace of its kernel form (``kernels/trace.py``).
``hdual_linear`` and ``hdual_linear_apply`` are the reference's entry
points of the fused hDual linear map, without ``interpret``.  Importing
this module builds and loads nothing: a kernel is compiled at its first
launch.
"""

from __future__ import annotations

from repro_torch.core import testfns
from repro_torch.engine.registry import BackendSpec, register_backend

from .chess_hvp import (chess_hvp_cuda, is_instance_block, lanes_for,
                        supports)
from .hdual_linear import hdual_linear_apply_cuda, hdual_linear_cuda
from .trace import TraceRefused, traced_form

__all__ = ["chess_hvp", "hdual_linear", "hdual_linear_apply", "kernel_form"]


def kernel_form(f):
    """(kernel_fn, consts, device_fn) for any engine target function;
    device_fn is None when f has no CUDA device form."""
    return (getattr(f, "kernel_fn", f),
            tuple(getattr(f, "kernel_consts", ())),
            getattr(f, "device_fn", None))


# ---------------------------------------------------------------------------
# engine backend: the paper's Fig. 2 L2 kernel
# ---------------------------------------------------------------------------

def _cuda_supports(plan, workload):
    """True, or why the ``cuda`` backend cannot run the plan.  It runs a
    flat CUDA plan without a mesh: of f's hand-written device form where f
    has one, at an n that one CTA's shared memory takes
    (``chess_hvp.supports``, the wrapper's own test), with a ``blk_m``
    option (instances per CTA) that ``chess_hvp.instance_blocks`` lists at
    that n and csize, or none; else of the form generated from a trace of
    f (``trace.traced_form``), where f traces and the form fits at the
    plan's n and csize (shared memory, ``LOCAL_MAX`` bytes of local memory
    a thread), with no ``blk_m``.  Otherwise ``auto`` resolves to
    ``vmap_l2`` and an explicit ``cuda`` is refused at resolution with the
    reason.  ``plan()`` refuses a ``blk_m`` on a card plan before it gets
    here; the veto keeps the tuner's grid to candidates the kernel takes."""
    if plan.device.type != "cuda":
        return f"the plan is on {plan.device}, not a CUDA device"
    if plan.mesh is not None or plan.n is None:
        return ("a mesh or pytree plan (the kernel takes one flat (m, n) "
                "batch)")
    kf, consts, device_fn = kernel_form(plan.f)
    blk_m = plan.opt("blk_m")
    if device_fn is not None:
        if not supports(device_fn, plan.n, plan.csize):
            return (f"n={plan.n} is past what one CTA's shared memory takes "
                    f"for {device_fn} at csize={plan.csize}")
        if blk_m is not None and not is_instance_block(
                device_fn, plan.n, plan.csize, blk_m):
            return (f"blk_m={blk_m!r} is not one of {device_fn}'s instance "
                    f"blocks")
        return True
    if blk_m is not None:
        return ("a traced form takes no blk_m (its instances per CTA are "
                "the wrapper's)")
    try:
        form = traced_form(kf, consts, plan.n)
    except TraceRefused as e:
        return (f"f has no hand-written device form and its trace is "
                f"refused: {e}")
    if not supports(form, plan.n, plan.csize):
        return (form.refusal(plan.n, lanes_for(plan.csize))
                or f"the traced form of f at n={plan.n} needs more shared "
                   f"memory than a CTA has")
    return True


def _cuda_make(plan, workload):
    kf, consts, device_fn = kernel_form(plan.f)
    # the reference's option name: for the pallas backend its instance
    # block, here the kernel's instances per CTA (None: the wrapper's pick)
    ipb = plan.opt("blk_m")

    def run(A, V):
        # the constants as they are at this call, as the reference passes
        # them to its kernel at every call (a traced form moves them itself,
        # when they change)
        cs = consts if device_fn is None else tuple(c.to(A.device)
                                                    for c in consts)
        return chess_hvp_cuda(kf, A, V, plan.csize, consts=cs,
                              device_fn=device_fn, symmetric=plan.symmetric,
                              ipb=ipb)
    return run


register_backend(BackendSpec(
    name="cuda", make=_cuda_make, workloads=frozenset({"batched_hvp"}),
    # supports() keeps it off every non-CUDA plan, so it never wins on CPU
    priority=40, supports=_cuda_supports,
    doc="Fig. 2 L2 kernel in CUDA C++ for sm_90a (symmetric + ragged, any "
        "csize, float32/bfloat16/float16 inputs computed in float32); "
        "evaluates f through its hand-written device form (rosenbrock, "
        "ackley, fletcher_powell; option blk_m = instances per CTA, swept "
        "by the tuner) at the n one CTA's shared memory takes "
        "(chess_hvp.max_n), or, as the Pallas kernel traces any "
        "hmath-written f, through a device form generated from a trace of "
        "f at the plan's n (structural evaluation: an instance pass into "
        "shared memory, each cell over its seeds' support; built at first "
        "launch; refused, with the reason, where f does not trace, its "
        "slot passes shared memory or the form needs more than LOCAL_MAX "
        "bytes of local memory a thread)"))


def chess_hvp(A, V, *, function: str = "rosenbrock", csize: int = 4,
              symmetric: bool = False):
    """Batched HVP on one of the paper's test-function families.

    A, V: (m, n) float32, bfloat16 or float16 -> (m, n) in A.dtype.  CUDA
    tensors run the kernel, CPU tensors its plain version."""
    f = testfns.FUNCTIONS[function](A.shape[-1])
    kf, consts, device_fn = kernel_form(f)
    consts = tuple(c.to(A.device) for c in consts)
    return chess_hvp_cuda(kf, A, V, csize, consts=consts,
                          device_fn=device_fn, symmetric=symmetric)


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
