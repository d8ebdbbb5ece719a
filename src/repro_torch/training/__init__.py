"""repro_torch.training -- the single-device train step and the
fault-tolerant loop (counterpart of ``repro.training``; the sharded steps
wait for the distributed slice)."""

from repro_torch.training.loop import TrainLoop, TrainLoopConfig
from repro_torch.training.steps import TrainState, make_train_step

__all__ = ["TrainState", "make_train_step", "TrainLoop", "TrainLoopConfig"]
