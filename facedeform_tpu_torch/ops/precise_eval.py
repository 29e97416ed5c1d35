"""Float64 dense evaluation for growing kernels (port of
facedeform_tpu/ops/precise_eval.py).

TPS/MQ/linear/cubic grow with distance, so the solved weights carry
||w|| orders of magnitude above the displacement they produce, and an f32
evaluation loses the 5e-5 budget to phi rounding, weight rounding and
cancellation in the contraction.  The JAX package emulates double
precision with double-float (hi, lo) f32 pairs because the TPU has no
float64; the H100 has native fp64, so the port computes in float64 where
JAX computes in double-float, and ops/dfloat.py has no port.  The model's
f32 lo words (w_rbf_lo, w_poly_lo) still carry the sub-f32 bits of the
dense solve, so models cross between the two packages unchanged.

evaluate_precise is the CPU path of the growing kernels and the plain
twin of the CUDA precise kernel (ops/cuda_precise.py).
"""

from __future__ import annotations

import torch

from facedeform_tpu_torch.config import PolyTerm, RBFKernel
from facedeform_tpu_torch.ops.assemble import poly_basis
from facedeform_tpu_torch.ops.kernels import apply_kernel, pairwise_sqdist

# Kernels whose growth makes f32 evaluation budget-breaking at scale.
GROWING_KERNELS = (
    RBFKernel.THIN_PLATE,
    RBFKernel.MULTIQUADRIC,
    RBFKernel.LINEAR,
    RBFKernel.CUBIC,
)


def inv_eps2_64(eps: torch.Tensor) -> torch.Tensor:
    """1 / eps^2 in float64 (eps^2 of an f32 eps is exact in float64)."""
    e = eps.double()
    return 1.0 / torch.clamp(e * e, min=1e-30)


def weights_64(model) -> tuple[torch.Tensor, torch.Tensor]:
    """(w_rbf + w_rbf_lo, w_poly + w_poly_lo) in float64; absent lo words
    (Krylov-route fits, the shared frames route) count as zeros."""
    w = model.w_rbf.double()
    wp = model.w_poly.double()
    if model.w_rbf_lo is not None:
        w = w + model.w_rbf_lo.double()
    if model.w_poly_lo is not None:
        wp = wp + model.w_poly_lo.double()
    return w, wp


def evaluate_precise(model, points: torch.Tensor, kernel: RBFKernel, term: PolyTerm,
                     chunk: int = 32768) -> torch.Tensor:
    """Displacement at points (V, 3) -> (V, 3) f32, computed in float64.

    Distances from the f32 coordinates, s = d2 / eps^2, phi, the
    contraction against w_rbf + w_rbf_lo and the tail against
    w_poly + w_poly_lo all run in float64 over chunks of `chunk` vertices;
    the sum is rounded to f32 once.  No centering: that is the f32 path's
    cancellation guard, not needed here."""
    kernel = RBFKernel(kernel)
    ctrl = model.ctrl.double()
    inv_eps2 = inv_eps2_64(model.eps)                  # (L, N)
    w, wp = weights_64(model)
    outs = []
    for pts in torch.split(points.double(), chunk):
        d2 = pairwise_sqdist(pts, ctrl)                 # (c, N)
        disp = torch.zeros((pts.shape[0], 3), dtype=torch.float64, device=pts.device)
        for layer in range(w.shape[0]):
            disp = disp + apply_kernel(kernel, d2 * inv_eps2[layer], 1.0) @ w[layer]
        if wp.shape[0] > 0:
            disp = disp + poly_basis(pts, term) @ wp
        outs.append(disp.float())
    if not outs:
        return torch.zeros((0, 3), dtype=torch.float32, device=points.device)
    return torch.cat(outs)
