"""Hand-written CUDA kernels for the paper's compute hot-spots, each beside
its plain PyTorch version:

  chess_hvp    -- the paper's Fig. 2 L2 batched-HVP kernel (CUDA C++, sm_90a),
                  on a hand-written device form of f or one generated from a
                  trace of any hmath-written f (``trace``, ``codegen``)
  hdual_linear -- the fused (2c+2)-component hDual linear map sharing W tiles
                  (CUDA C++, sm_90a)

The named entries ``chess_hvp(A, V, function=...)`` and ``hdual_linear(x,
w)`` live in ``kernels.ops``; they are not re-exported here, so that
``repro_torch.kernels.chess_hvp`` and ``repro_torch.kernels.hdual_linear``
stay the kernels' modules.
"""

from repro_torch.kernels.chess_hvp import (chess_hvp_cuda, chess_hvp_plain,
                                           kernel_grid)
from repro_torch.kernels.hdual_linear import (hdual_linear_cuda,
                                              hdual_linear_plain)
from repro_torch.kernels.ops import hdual_linear_apply, kernel_form

__all__ = ["chess_hvp_cuda", "chess_hvp_plain", "kernel_grid",
           "hdual_linear_cuda", "hdual_linear_plain", "hdual_linear_apply",
           "kernel_form"]
