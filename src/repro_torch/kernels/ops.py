"""Public wrappers for the CUDA kernel, and the engine's ``cuda`` backend.

Counterpart of ``repro.kernels.ops`` (its chess_hvp part).  A target
function exposes its kernel forms through attributes (see
``core.testfns``): ``kernel_fn``/``kernel_consts`` (the plain kernel form
and its constants, the reference's ``pallas_fn``/``pallas_consts``) and
``device_fn`` (the name of its CUDA device form).  Importing this module
builds and loads nothing: the kernel is compiled at its first launch.
"""

from __future__ import annotations

from repro_torch.core import testfns
from repro_torch.engine.registry import BackendSpec, register_backend

from .chess_hvp import LANES, chess_hvp_cuda

__all__ = ["chess_hvp", "kernel_form"]


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
    return (plan.device.type == "cuda" and plan.mesh is None
            and plan.n is not None and plan.csize <= LANES[-1]
            and kernel_form(plan.f)[2] is not None)


def _cuda_make(plan, workload):
    kf, consts, device_fn = kernel_form(plan.f)
    consts = tuple(c.to(plan.device) for c in consts)

    def run(A, V):
        return chess_hvp_cuda(kf, A, V, plan.csize, consts=consts,
                              device_fn=device_fn, symmetric=plan.symmetric)
    return run


register_backend(BackendSpec(
    name="cuda", make=_cuda_make, workloads=frozenset({"batched_hvp"}),
    # supports() keeps it off every non-CUDA plan, so it never wins on CPU
    priority=40, supports=_cuda_supports,
    doc="Fig. 2 L2 kernel in CUDA C++ for sm_90a (symmetric + ragged, "
        "csize <= 64, float32); serves only functions with a CUDA device "
        "form (rosenbrock, ackley, fletcher_powell), unlike the Pallas "
        "kernel, which traces any hmath-written f"))


def chess_hvp(A, V, *, function: str = "rosenbrock", csize: int = 4,
              symmetric: bool = False):
    """Batched HVP on one of the paper's test-function families.

    A, V: (m, n) float32 -> (m, n).  CUDA tensors run the kernel, CPU
    tensors its plain version."""
    f = testfns.FUNCTIONS[function](A.shape[-1])
    kf, consts, device_fn = kernel_form(f)
    consts = tuple(c.to(A.device) for c in consts)
    return chess_hvp_cuda(kf, A, V, csize, consts=consts,
                          device_fn=device_fn, symmetric=symmetric)
