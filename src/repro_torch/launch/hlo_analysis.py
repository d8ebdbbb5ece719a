"""Collective-byte accounting and roofline terms of one device, with the
H100's published peaks.

Counterpart of ``repro.launch.hlo_analysis``.  The reference's
``parse_collectives`` reads the collectives out of compiled XLA HLO text;
PyTorch compiles no such program, so the HLO parsing has no counterpart.
Its ring model does: ``ring_wire_bytes(kind, nbytes, group)`` gives the
bytes one device puts on the wire for a collective whose OUTPUT holds
``nbytes`` over a group of ``group`` ranks,

  all-reduce          2 (g-1)/g * buffer   (reduce-scatter + all-gather ring)
  all-gather            (g-1)/g * output
  reduce-scatter        (g-1)   * output   (= (g-1)/g * input)
  all-to-all            (g-1)/g * buffer
  collective-permute              buffer

and ``CollectiveStats`` sums them per kind, as the reference's does.  The
port's callers record each collective as they issue it
(``launch.dryrun``).

Constants (NVIDIA H100 SXM data sheet, dense rates, at the full 700 W
power limit; a card set below it runs slower):
  compute    = FLOPs_per_device / 67e12   [s]  float32 outside the tensor
               cores: the rate of every curvature route (hDual sweeps and
               the chess_hvp kernel both run FFMA); ``PEAK_BF16`` = 989e12,
               the bfloat16 tensor-core rate, for bfloat16 compute
  memory     = bytes_per_device / 3.35e12 [s]  HBM3
  collective = wire_bytes_per_device / 450e9 [s]  NVLink 4, one direction
               (900 GB/s both ways)
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["CollectiveStats", "ring_wire_bytes", "roofline_terms",
           "COLLECTIVES", "PEAK_FLOPS", "PEAK_BF16", "HBM_BW", "NVLINK_BW"]

PEAK_FLOPS = 67e12       # float32 FLOP/s, CUDA cores (FFMA)
PEAK_BF16 = 989e12       # bfloat16 FLOP/s, tensor cores (dense)
HBM_BW = 3.35e12         # B/s
NVLINK_BW = 450e9        # B/s per direction

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def ring_wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """Bytes one device sends for a ``kind`` collective whose output holds
    ``nbytes``, over ``group`` ranks (0 for a group of one)."""
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}; expected one of "
                         f"{COLLECTIVES}")
    if group <= 1:
        return 0.0
    frac = (group - 1) / group
    if kind == "all-reduce":
        return 2.0 * frac * nbytes
    if kind == "reduce-scatter":
        return frac * nbytes * group     # input = output * g
    if kind == "collective-permute":
        return float(nbytes)
    return frac * nbytes                 # all-gather, all-to-all


@dataclass
class CollectiveStats:
    ops: dict = field(default_factory=dict)        # kind -> count
    wire_bytes: float = 0.0                        # per-device bytes sent
    by_kind: dict = field(default_factory=dict)    # kind -> bytes
    details: list = field(default_factory=list)

    def add(self, kind: str, nbytes: int, group: int) -> float:
        """Record one collective (output bytes, group size); a group of
        one is no collective and is not recorded.  Returns its wire
        bytes."""
        if group <= 1:
            return 0.0
        wire = ring_wire_bytes(kind, nbytes, group)
        self.ops[kind] = self.ops.get(kind, 0) + 1
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + wire
        self.wire_bytes += wire
        self.details.append({"kind": kind, "bytes": int(nbytes),
                             "group": int(group), "wire": wire})
        return wire


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   wire_bytes_per_dev: float, *,
                   peak_flops: float = PEAK_FLOPS) -> dict:
    t_c = flops_per_dev / peak_flops
    t_m = bytes_per_dev / HBM_BW
    t_n = wire_bytes_per_dev / NVLINK_BW
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_n),
              key=lambda kv: kv[1])
    return {
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_n,
        "bound": dom[0],
        "step_time_lower_bound_s": max(t_c, t_m, t_n),
    }
