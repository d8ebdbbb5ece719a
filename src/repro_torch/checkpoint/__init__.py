"""repro_torch.checkpoint -- atomic, async checkpoints of pytrees of
tensors (counterpart of ``repro.checkpoint``)."""

from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                               latest_step,
                                               restore_checkpoint,
                                               save_checkpoint)

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint",
           "latest_step"]
