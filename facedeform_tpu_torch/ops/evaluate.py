"""Dense plain-PyTorch evaluation (port of facedeform_tpu/ops/evaluate.py).

The CPU path of the port and the plain twin of both CUDA eval kernels
(ops/cuda_eval.py): phi (L, V, N) contracted against the weights with
TF32 off, chunked along V so the kernel matrix stays bounded.
"""

from __future__ import annotations

import torch

from facedeform_tpu_torch.config import PolyTerm, RBFKernel
from facedeform_tpu_torch.ops.assemble import poly_basis
from facedeform_tpu_torch.ops.kernels import apply_kernel, pairwise_sqdist
from facedeform_tpu_torch.utils.precision import highest_precision


def _center_phi(kernel: RBFKernel, term: PolyTerm) -> bool:
    """Centering is valid only under the sum(w) = 0 tail constraint and only
    pays off for kernels that grow with distance."""
    return PolyTerm(term) != PolyTerm.ZERO and RBFKernel(kernel) in (
        RBFKernel.THIN_PLATE,
        RBFKernel.MULTIQUADRIC,
        RBFKernel.LINEAR,
        RBFKernel.CUBIC,
    )


def evaluate_block(model, points: torch.Tensor, kernel: RBFKernel, term: PolyTerm) -> torch.Tensor:
    """Displacement at points (V, 3) -> (V, 3); materializes phi (L, V, N)."""
    points = points.float()
    d2 = pairwise_sqdist(points, model.ctrl)
    phi = apply_kernel(kernel, d2[None], model.eps[:, None, :])  # (L, V, N)
    if _center_phi(kernel, term):
        # P^T w = 0 includes a ones row, so sum_j w_j = 0 and a per-row
        # constant may be subtracted from layer-0 phi: it shrinks the
        # cancelling terms of growing kernels (only layer 0 has the tail)
        phi0 = phi[0] - torch.mean(phi[0], dim=-1, keepdim=True)
        phi = torch.cat([phi0[None], phi[1:]], dim=0)
    with highest_precision():
        disp = torch.einsum("lvn,lnc->vc", phi, model.w_rbf)
        if model.w_poly.shape[0] > 0:
            disp = disp + poly_basis(points, term) @ model.w_poly
    return disp


def evaluate(model, points: torch.Tensor, kernel: RBFKernel, term: PolyTerm,
             chunk: int = 65536) -> torch.Tensor:
    """Chunked dense evaluation; bounds scratch to chunk * N * L floats."""
    if points.shape[0] <= chunk:
        return evaluate_block(model, points, kernel, term)
    return torch.cat([
        evaluate_block(model, p, kernel, term) for p in torch.split(points, chunk)
    ])
