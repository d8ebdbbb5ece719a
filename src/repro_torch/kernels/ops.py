"""Public wrappers for the CUDA kernels, and the engine's ``cuda`` backend.

Counterpart of ``repro.kernels.ops``.  A target function exposes its kernel
forms through attributes (see ``core.testfns``): ``kernel_fn``/
``kernel_consts`` (the plain kernel form and its constants, the reference's
``pallas_fn``/``pallas_consts``) and ``device_fn`` (the name of its CUDA
device form).  ``hdual_linear`` and ``hdual_linear_apply`` are the
reference's entry points of the fused hDual linear map, without
``interpret``.  Importing this module builds and loads nothing: a kernel is
compiled at its first launch.
"""

from __future__ import annotations

from repro_torch.core import testfns
from repro_torch.engine.registry import BackendSpec, register_backend

from .chess_hvp import chess_hvp_cuda, is_instance_block, supports
from .hdual_linear import hdual_linear_apply_cuda, hdual_linear_cuda

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
    """A CUDA plan of f with a device form, at an n that one CTA's shared
    memory takes (``chess_hvp.supports``, the wrapper's own test), with a
    ``blk_m`` option (instances per CTA) that ``chess_hvp.instance_blocks``
    lists at that n and csize, or none; otherwise ``auto`` resolves to
    ``vmap_l2`` and an explicit ``cuda`` is refused at resolution.
    ``plan()`` refuses such a ``blk_m`` on a card plan before it gets here;
    the veto keeps the tuner's grid to candidates the kernel takes."""
    device_fn = kernel_form(plan.f)[2]
    if not (plan.device.type == "cuda" and plan.mesh is None
            and plan.n is not None and device_fn is not None
            and supports(device_fn, plan.n, plan.csize)):
        return False
    blk_m = plan.opt("blk_m")
    return blk_m is None or is_instance_block(device_fn, plan.n, plan.csize,
                                              blk_m)


def _cuda_make(plan, workload):
    kf, consts, device_fn = kernel_form(plan.f)
    consts = tuple(c.to(plan.device) for c in consts)
    # the reference's option name: for the pallas backend its instance
    # block, here the kernel's instances per CTA (None: the wrapper's pick)
    ipb = plan.opt("blk_m")

    def run(A, V):
        return chess_hvp_cuda(kf, A, V, plan.csize, consts=consts,
                              device_fn=device_fn, symmetric=plan.symmetric,
                              ipb=ipb)
    return run


register_backend(BackendSpec(
    name="cuda", make=_cuda_make, workloads=frozenset({"batched_hvp"}),
    # supports() keeps it off every non-CUDA plan, so it never wins on CPU
    priority=40, supports=_cuda_supports,
    doc="Fig. 2 L2 kernel in CUDA C++ for sm_90a (symmetric + ragged, any "
        "csize, float32/bfloat16/float16 inputs computed in float32; option "
        "blk_m = instances per CTA, swept by the tuner); serves "
        "only functions with a CUDA device form (rosenbrock, ackley, "
        "fletcher_powell), at the n one CTA's shared memory takes "
        "(chess_hvp.max_n), unlike the Pallas kernel, which traces any "
        "hmath-written f at any n"))


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
