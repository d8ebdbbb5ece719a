"""LR schedules (pure functions of the step counter).

Counterpart of ``repro.optim.schedule``.  Each schedule maps a step (an
int, or a 0-d tensor on any device) to a float32 0-d tensor on the step's
device (the CPU for an int).
"""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    def lr(step):
        step = _step(step)
        warm = base_lr * step / max(warmup_steps, 1)
        frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        frac = frac.clamp(0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr


def constant(base_lr: float):
    return lambda step: torch.full_like(_step(step), base_lr)
