"""Roofline terms of one device, with the H100's published peaks.

Counterpart of ``repro.launch.hlo_analysis`` (its ``roofline_terms``).  The
reference's ``parse_collectives`` reads the collectives out of compiled
XLA HLO text; PyTorch compiles no such program, so it has no counterpart
here: the port's callers count their bytes and operations from shapes.

Constants (NVIDIA H100 SXM data sheet, dense rates, at the full 700 W
power limit; a card set below it runs slower):
  compute    = FLOPs_per_device / 67e12   [s]  float32 outside the tensor
               cores: the rate of every curvature route (hDual sweeps and
               the chess_hvp kernel both run FFMA)
  memory     = bytes_per_device / 3.35e12 [s]  HBM3
  collective = wire_bytes_per_device / 450e9 [s]  NVLink 4, one direction
               (900 GB/s both ways)
"""

from __future__ import annotations

__all__ = ["roofline_terms", "PEAK_FLOPS", "HBM_BW", "NVLINK_BW"]

PEAK_FLOPS = 67e12       # float32 FLOP/s, CUDA cores (FFMA)
HBM_BW = 3.35e12         # B/s
NVLINK_BW = 450e9        # B/s per direction


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   wire_bytes_per_dev: float) -> dict:
    t_c = flops_per_dev / PEAK_FLOPS
    t_m = bytes_per_dev / HBM_BW
    t_n = wire_bytes_per_dev / NVLINK_BW
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_n),
              key=lambda kv: kv[1])
    return {
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_n,
        "bound": dom[0],
        "step_time_lower_bound_s": max(t_c, t_m, t_n),
    }
