"""Error-compensated TF32 contraction (3xTF32): the operand split and
fragment layout the PU tile kernel (csrc/pu.cu), the Jacobian kernel
(csrc/jacobian.cu) and the frames eval kernel (csrc/frames.cu) take, and
the plain emulation their CPU tests use.

The kernels contract a tile they compute in registers (A: points x
controls) with constant weight columns (B: controls x columns) on the
tensor cores, mma.sync m16n8k8 with tf32 inputs and f32 accumulation
(csrc/common.cuh, mma_3xtf32).  Each operand is split into a tf32 word and
its remainder, x = hi + lo, and the product is formed as
A_lo B_hi + A_hi B_lo + A_hi B_hi, with lo rounded to tf32 in turn: three
passes that together carry about 22 bits of each operand, the counterpart
of the TPU's Precision.HIGHEST, where a single tf32 pass would keep 11.

  round_tf32       cvt.rna.tf32.f32: the nearest tf32, ties away from zero
  split_tf32       x -> (hi, lo = x - hi exactly)
  mma_fragments    B (..., 8T, 8J) -> the hi and rounded lo words in the
                   order a warp's lanes load them, one float4 per lane per
                   (k-step, n-tile)
  matmul_3xtf32    per k-step of 8 the three products of the split operands
                   in float64, rounded to f32 and added to an f32
                   accumulator in k order, as the kernels add each k-step's
                   fresh fragment (the truncating adds inside an mma are
                   not modelled: they are exact here)
  n_tiles          the n8 tiles a launch's columns take
"""

from __future__ import annotations

import torch

_TF32_DROP = 0x1FFF     # the 13 low mantissa bits a tf32 word does not keep
_TF32_HALF = 0x1000


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest tf32 (10 explicit mantissa bits, ties away
    from zero), as float32: PTX cvt.rna.tf32.f32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + _TF32_HALF) & ~_TF32_DROP).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 x -> (hi, lo), both float32: hi = round_tf32(x), lo = x - hi
    exactly.  The kernels feed round_tf32(lo) to the mma, which carries a
    normal x to within 2^-22 |x|."""
    hi = round_tf32(x)
    return hi, x.float() - hi


def mma_fragments(b: torch.Tensor) -> torch.Tensor:
    """B (..., 8T, 8J) float32 -> (..., T, J, 32, 4): for k-step s and
    n-tile j, lane 4g + t holds (hi, hi, lo, lo) of B[8s + t][8j + g] and
    B[8s + t + 4][8j + g], the b0/b1 registers of mma.m16n8k8 (row t and
    t + 4, column g) in both words."""
    *lead, k, n = b.shape
    if k % 8 or n % 8:
        raise ValueError(f"B must be padded to whole 8 x 8 tiles, got {tuple(b.shape)}")
    d = len(lead)

    def lanes(w):
        # (..., s, h, t, j, g) with row 8s + 4h + t, column 8j + g
        w = w.reshape(*lead, k // 8, 2, 4, n // 8, 8)
        return w.permute(*range(d), d, d + 3, d + 4, d + 2, d + 1)    # (..., s, j, g, t, h)

    hi, lo = split_tf32(b)
    return torch.stack([lanes(hi), lanes(round_tf32(lo))], dim=-2).reshape(
        *lead, k // 8, n // 8, 32, 4)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (..., M, K) x (..., K, N) as the kernels' tensor cores form it:
    both operands split, and per k-step of 8 A_lo B_hi + A_hi B_lo +
    A_hi B_hi with the lo words rounded to tf32, summed in float64, rounded
    to f32 and added to the f32 result in k order."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    al, bl = round_tf32(al).double(), round_tf32(bl).double()
    ah, bh = ah.double(), bh.double()
    out = None
    for k in range(0, a.shape[-1], 8):
        ks = slice(k, k + 8)
        step = (al[..., ks] @ bh[..., ks, :] + ah[..., ks] @ bl[..., ks, :]
                + ah[..., ks] @ bh[..., ks, :]).float()
        out = step if out is None else out + step
    return out


def n_tiles(columns: int, tiles: tuple) -> int:
    """The n8 tiles a launch of `columns` weight columns takes: the fewest
    of the kernel's instantiated counts `tiles` that hold them."""
    return next(t for t in tiles if 8 * t >= columns)
