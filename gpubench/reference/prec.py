"""Precisions the reference runs in.

TF32 is emulated: both operands of a contraction are rounded to TF32's 10
stored mantissa bits (round to nearest, as the tensor cores take them) and
multiplied in float32, so a control reads the same on the card and on the
CPU, and cuBLAS's own TF32 switch plays no part (it stays off).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Prec:
    real: torch.dtype = torch.float64   # distances, kernels, solves, eval, transport
    tf32: bool = False                  # contractions of the fit/eval/transport in TF32
    dbse_tf32: bool = False             # the DBSE Gram and projections in TF32
    falloff_bf16: bool = False          # the capture falloff in bfloat16


JUDGE = Prec()


def controls(precision: str) -> dict:
    """The controls of a configuration, each the reference put in the
    program's place one precision step below what the configuration states
    for one stage, and nothing else changed:

      precision     the fit, eval and transport (the configuration's
                    "precision"): float64 -> float32; float32 (TF32 off)
                    -> TF32 contractions
      falloff_bf16  the capture falloff, elementwise float32 in the
                    program under every configuration -> bfloat16
      dbse_tf32     the DBSE Gram and projections, float32 contractions
                    in the program -> TF32
    """
    if precision == "float64":
        step = Prec(real=torch.float32)
    elif precision == "float32":
        step = Prec(real=torch.float32, tf32=True)
    else:
        raise ValueError(f"no control for precision {precision!r}")
    return {"precision": step, "falloff_bf16": Prec(falloff_bf16=True),
            "dbse_tf32": Prec(dbse_tf32=True)}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (8-bit exponent, 10-bit mantissa), nearest-even,
    kept in float32."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """a @ b, with TF32 operands when tf32 (float32 accumulation)."""
    if tf32:
        return round_tf32(a) @ round_tf32(b)
    return a @ b
