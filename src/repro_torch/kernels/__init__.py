"""Hand-written CUDA kernels for the paper's compute hot-spots, each beside
its plain PyTorch version:

  chess_hvp -- the paper's Fig. 2 L2 batched-HVP kernel (CUDA C++, sm_90a)

The named entry ``chess_hvp(A, V, function=...)`` lives in ``kernels.ops``;
it is not re-exported here, so that ``repro_torch.kernels.chess_hvp`` stays
the kernel's module.
"""

from repro_torch.kernels.chess_hvp import (chess_hvp_cuda, chess_hvp_plain,
                                           kernel_grid)
from repro_torch.kernels.ops import kernel_form

__all__ = ["chess_hvp_cuda", "chess_hvp_plain", "kernel_grid", "kernel_form"]
