"""repro_torch -- the CHESSFAD engine on PyTorch and CUDA.

The PyTorch counterpart of the ``repro`` package (JAX/Pallas), module for
module: ``core`` (hDual numbers, hmath, the chunked schedules, the paper's
test functions), ``engine`` (plan/execute, backend registry, §5 op model)
and ``kernels`` (the paper's Fig. 2 L2 batched-HVP kernel, hand-written in
CUDA C++ for Hopper, ``sm_90a``).  This package imports neither JAX nor
``repro``.
"""
