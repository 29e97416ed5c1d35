"""RBF interpolation system assembly (port of facedeform_tpu/ops/assemble.py).

    [ Phi + lam*I   P          ] [ w ]   [ delta ]
    [ P^T           -1e-8 * I  ] [ c ] = [   0   ]

with Phi[i,j] = phi(||x_i - x_j|| / eps_j) and P the polynomial tail.
"""

from __future__ import annotations

import torch

from facedeform_tpu_torch.config import PolyTerm, RBFKernel
from facedeform_tpu_torch.ops.kernels import apply_kernel, pairwise_sqdist


def poly_basis(pts: torch.Tensor, term: PolyTerm) -> torch.Tensor:
    """Tail basis rows (V, n_poly): LINEAR [1, x, y, z], CONSTANT [1],
    ZERO (V, 0)."""
    term = PolyTerm(term)
    ones = torch.ones((pts.shape[0], 1), dtype=pts.dtype, device=pts.device)
    if term == PolyTerm.LINEAR:
        return torch.cat([ones, pts], dim=-1)
    if term == PolyTerm.CONSTANT:
        return ones
    return ones[:, :0]


def assemble_system(
    ctrl: torch.Tensor,
    kernel: RBFKernel,
    term: PolyTerm,
    eps,
    lam,
    tail_reg: float = 1e-8,
) -> torch.Tensor:
    """The (N + m, N + m) saddle-point system.

    eps is (N,) or a scalar, lam a scalar or (N,) ridge on the Phi
    diagonal.  -tail_reg * I in the tail block makes the system
    quasi-definite, so rank-deficient tails (coplanar rigs with a LINEAR
    term) solve to a minimal-norm tail instead of blowing up.
    """
    n = ctrl.shape[0]
    phi = apply_kernel(kernel, pairwise_sqdist(ctrl, ctrl), eps)
    lam = torch.as_tensor(lam, dtype=phi.dtype, device=phi.device)
    phi = phi + torch.diag(torch.broadcast_to(lam, (n,)))
    p = poly_basis(ctrl, term)
    m = p.shape[1]
    if m == 0:
        return phi
    tail = -tail_reg * torch.eye(m, dtype=phi.dtype, device=phi.device)
    top = torch.cat([phi, p], dim=1)
    bot = torch.cat([p.T, tail], dim=1)
    return torch.cat([top, bot], dim=0)


def assemble_rhs(delta: torch.Tensor, term: PolyTerm) -> torch.Tensor:
    """Right-hand side (..., N + m, 3): displacements (..., N, 3), zero rows
    for the tail; a leading axis carries the poses of a shot."""
    m = {PolyTerm.LINEAR: 4, PolyTerm.CONSTANT: 1, PolyTerm.ZERO: 0}[PolyTerm(term)]
    pad = torch.zeros(delta.shape[:-2] + (m, delta.shape[-1]), dtype=delta.dtype,
                      device=delta.device)
    return torch.cat([delta, pad], dim=-2)
