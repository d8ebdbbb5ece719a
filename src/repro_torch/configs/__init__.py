"""Architecture registry: one module per assigned arch + the paper workload.

A copy of ``repro.configs``; the tests hold every config to the
reference's field by field."""

from repro_torch.configs.base import (ARCH_NAMES, SHAPES, InputShape,
                                      ModelConfig, all_cells, cells_for,
                                      get_config)

__all__ = ["ARCH_NAMES", "SHAPES", "InputShape", "ModelConfig", "all_cells",
           "cells_for", "get_config"]
