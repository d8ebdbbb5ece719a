"""Optimizers: AdamW + SophiaH (CHESSFAD chunked-HVP curvature) and
Newton-CG (counterpart of ``repro.optim``)."""

from repro_torch.optim.optimizers import (OPTIMIZERS, Optimizer, adamw,
                                          clip_by_global_norm, global_norm,
                                          sophia_h)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["OPTIMIZERS", "Optimizer", "adamw", "sophia_h", "global_norm",
           "clip_by_global_norm", "warmup_cosine"]
