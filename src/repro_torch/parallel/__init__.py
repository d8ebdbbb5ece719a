"""Distribution helpers over a ``torch.distributed`` DeviceMesh: the
logical-axis sharding rules and the collectives.

Counterpart of ``repro.parallel``."""

from .collectives import (compressed_psum, dequantize_int8,
                          hierarchical_grad_sync, quantize_int8)
from .sharding import (ACTIVATION_RULES, PARAM_RULES, NamedSharding,
                       batch_spec, constrain, data_axes, logical_to_sharding,
                       mesh_axis_size, spec_for)

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum",
           "hierarchical_grad_sync", "PARAM_RULES", "ACTIVATION_RULES",
           "spec_for", "logical_to_sharding", "mesh_axis_size", "data_axes",
           "batch_spec", "constrain", "NamedSharding"]
