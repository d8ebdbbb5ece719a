"""repro_torch.core -- CHESSFAD: chunked forward-mode second-order AD (the
paper's primary contribution) on PyTorch tensors.  Counterpart of
``repro.core``."""

from .hdual import HDual, lift, seed_point, is_hdual
from . import hmath
from .api import (eval_chunk, hessian, hvp, gradient, batched_hvp,
                  batched_hessian, chunk_pairs, num_chunk_evals, optimal_csize)
from . import ref
from . import testfns

__all__ = [
    "HDual", "lift", "seed_point", "is_hdual", "hmath",
    "eval_chunk", "hessian", "hvp", "gradient", "batched_hvp",
    "batched_hessian", "chunk_pairs", "num_chunk_evals", "optimal_csize",
    "ref", "testfns",
]
