"""Distribution helpers: collectives over a ``torch.distributed`` DeviceMesh.

Counterpart of ``repro.parallel`` (its collectives; the logical-axis
sharding rules come with the trainer's mesh half)."""

from .collectives import (compressed_psum, dequantize_int8,
                          hierarchical_grad_sync, quantize_int8)

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum",
           "hierarchical_grad_sync"]
