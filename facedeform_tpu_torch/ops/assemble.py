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


def assemble_system_df(
    ctrl: torch.Tensor,
    kernel: RBFKernel,
    term: PolyTerm,
    eps,
    lam,
    tail_reg: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """assemble_system split into f32 words (a_hi, a_lo), a_hi + a_lo the
    float64 system.

    For growing kernels the f32 rounding of phi, amplified by the
    system's conditioning, caps the forward accuracy of any solve against
    the f32 matrix; solve.lu_solve_refined_against_df refines against
    a_hi + a_lo instead.  The phi block (with lam on its diagonal) is
    computed in float64 from the f32 coordinates and split; the tail rows
    and the -tail_reg * I block are assemble_system's f32 values, so a_lo
    is zero outside the N x N phi block.
    """
    n = ctrl.shape[0]
    c64 = ctrl.double()
    eps64 = torch.broadcast_to(torch.as_tensor(eps, device=ctrl.device).double(), (n,))
    phi = apply_kernel(kernel, pairwise_sqdist(c64, c64), eps64)
    lam64 = torch.as_tensor(lam, device=ctrl.device).double()
    phi = phi + torch.diag(torch.broadcast_to(lam64, (n,)))
    phi_hi = phi.float()
    phi_lo = (phi - phi_hi.double()).float()
    p = poly_basis(ctrl.float(), term)
    m = p.shape[1]
    if m == 0:
        return phi_hi, phi_lo
    tail = -tail_reg * torch.eye(m, dtype=torch.float32, device=ctrl.device)
    a_hi = torch.cat([torch.cat([phi_hi, p], dim=1), torch.cat([p.T, tail], dim=1)], dim=0)
    a_lo = torch.zeros_like(a_hi)
    a_lo[:n, :n] = phi_lo
    return a_hi, a_lo


def assemble_rhs(delta: torch.Tensor, term: PolyTerm) -> torch.Tensor:
    """Right-hand side (..., N + m, 3): displacements (..., N, 3), zero rows
    for the tail; a leading axis carries the poses of a shot."""
    m = {PolyTerm.LINEAR: 4, PolyTerm.CONSTANT: 1, PolyTerm.ZERO: 0}[PolyTerm(term)]
    pad = torch.zeros(delta.shape[:-2] + (m, delta.shape[-1]), dtype=delta.dtype,
                      device=delta.device)
    return torch.cat([delta, pad], dim=-2)
