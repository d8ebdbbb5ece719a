"""repro_torch.training -- the train steps (one device, a mesh, the
shard-map step), GPipe pipelining and the fault-tolerant loop
(counterpart of ``repro.training``)."""

from repro_torch.training.loop import TrainLoop, TrainLoopConfig
from repro_torch.training.steps import (TrainState, make_shard_map_train_step,
                                      make_train_step, state_shardings)

__all__ = ["TrainState", "make_train_step", "state_shardings",
           "make_shard_map_train_step", "TrainLoop", "TrainLoopConfig"]
