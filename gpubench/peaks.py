"""Peak rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W power limit; a run prints the card's own limit beside its numbers),
and the least time a piece of work can take on them.

Each kind of operation is bound by the fastest pipe that computes it at
the precision the configuration states, so no implementation can read
over 100%: a float32-accurate contraction on the tensor cores takes three
TF32 passes (495 / 3 TFLOP/s); float64 contractions run on the fp64 tensor
cores; everything else (distances, the basis function) on the CUDA cores.
The copy of chip_smoke.py's _bound: the pipes overlap, so the operations
take the longest pipe's time, and the least time is the larger of that and
the bytes over the memory rate.
"""

from __future__ import annotations

import dataclasses

PEAK_F32 = 67e12          # FLOP/s, CUDA cores
PEAK_F64 = 34e12          # FLOP/s, CUDA cores
PEAK_F64_TC = 67e12       # FLOP/s, fp64 tensor cores
PEAK_TF32 = 495e12        # FLOP/s, tensor cores
PEAK_F32_TC = PEAK_TF32 / 3   # a float32-accurate contraction in 3 TF32 passes
PEAK_BYTES = 3.35e12      # B/s, HBM3


def elementwise(precision: str) -> float:
    return PEAK_F64 if precision == "float64" else PEAK_F32


def contraction(precision: str) -> float:
    return PEAK_F64_TC if precision == "float64" else PEAK_F32_TC


@dataclasses.dataclass(frozen=True)
class Work:
    """Operations, each with the peak of its pipe, and the bytes read and
    written once."""

    ops: tuple          # ((operations, peak), ...)
    bytes: float

    def seconds(self) -> float:
        t_ops = max((n / peak for n, peak in self.ops), default=0.0)
        return max(t_ops, self.bytes / PEAK_BYTES)
