"""Full-float32 matmul scope: the port's counterpart of the JAX package's
Precision.HIGHEST.

On Hopper a float32 matmul may run in TF32 (about three decimal digits)
when torch.backends.cuda.matmul.allow_tf32 is set or the float32 matmul
precision is "high"/"medium", and cuDNN uses TF32 by default.  The solve's
refinement and the plain eval path are only as good as their contractions,
so every matmul and LU call of the port runs inside highest_precision().
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def highest_precision():
    """Turn TF32 off for matmuls and cuDNN; restore the caller's settings
    on exit."""
    saved = (
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
        torch.get_float32_matmul_precision(),
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[2])
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
