"""Krylov solvers (port of facedeform_tpu/ops/krylov.py): restarted GMRES,
the inner solver of the growing kernels' GMRES-IR refinement
(ops/solve.lu_solve_refined_against_df).

The JAX module's PMINRES, block-Jacobi preconditioners and pminres_df
serve the matrix-free large-rig route, which is not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from facedeform_tpu_torch.ops.solve import SolveReport
from facedeform_tpu_torch.utils.precision import highest_precision


def gmres(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    msolve: Callable[[torch.Tensor], torch.Tensor],
    tol: float = 1e-7,
    restart: int = 32,
    max_restarts: int = 16,
) -> tuple[torch.Tensor, SolveReport]:
    """Right-preconditioned restarted GMRES(restart), all columns of b
    (n, k) in lockstep: solves A M^-1 u = b, x = M^-1 u.

    Arnoldi runs classical Gram-Schmidt with one reorthogonalization pass
    (CGS2) for every column at once, each Hessenberg column is solved by
    normal equations with a 1e-12 ridge, and restarts continue while ANY
    column's residual exceeds tol * ||b_col||, so the column count changes
    the iterates.  x starts at zero (GMRES-IR solves each correction
    equation cold; the JAX package's x0 serves the unported Krylov route).
    f32 throughout, TF32 off.  Returns (x, report) with cond_est None, as
    the JAX package builds it.
    """
    b = b.float()
    n, k = b.shape
    m = restart
    with highest_precision():
        bnorm = torch.linalg.norm(b, dim=0)                          # (k,)
        x = torch.zeros_like(b)
        resid = bnorm
        anorm = torch.zeros((), dtype=torch.float32, device=b.device)
        it = 0
        while it < max_restarts and bool(torch.any(resid > tol * torch.clamp(bnorm, min=1e-30))):
            r = b - matvec(x)
            beta = torch.linalg.norm(r, dim=0)
            # dead-column guard: a column converged to ~1e-20 would make a
            # ~1e9-scale "unit" vector and overflow the Gram-Schmidt cascade
            alive0 = beta > 1e-25
            basis = torch.zeros((m + 1, n, k), dtype=torch.float32, device=b.device)
            basis[0] = torch.where(alive0, r / torch.clamp(beta, min=1e-30), torch.zeros_like(r))
            beta = torch.where(alive0, beta, torch.zeros_like(beta))
            hess = torch.zeros((m + 1, m, k), dtype=torch.float32, device=b.device)
            for j in range(m):
                w = matvec(msolve(basis[j]))
                # CGS2: rows > j of basis are zero, so full projections are exact
                h1 = torch.einsum("ink,nk->ik", basis, w)
                w = w - torch.einsum("ink,ik->nk", basis, h1)
                h2 = torch.einsum("ink,nk->ik", basis, w)
                w = w - torch.einsum("ink,ik->nk", basis, h2)
                h = h1 + h2
                hlast = torch.linalg.norm(w, dim=0)
                # breakdown guard: a fully captured residual leaves w ~ 0
                alive = hlast > 1e-20
                basis[j + 1] = torch.where(alive, w / torch.clamp(hlast, min=1e-30),
                                           torch.zeros_like(w))
                h[j + 1] = torch.where(alive, hlast, torch.zeros_like(hlast))
                hess[:, j] = h
            # min_y || beta e1 - H y || per column, by normal equations
            h_t = hess.permute(2, 1, 0)                              # (k, m, m+1)
            g = torch.zeros((k, m + 1, 1), dtype=torch.float32, device=b.device)
            g[:, 0, 0] = beta
            hth = h_t @ h_t.transpose(1, 2) + 1e-12 * torch.eye(
                m, dtype=torch.float32, device=b.device)
            y = torch.linalg.solve(hth, h_t @ g)[..., 0]             # (k, m)
            x = x + msolve(torch.einsum("ink,ki->nk", basis[:m], y))
            resid = torch.linalg.norm(b - matvec(x), dim=0)
            anorm = torch.maximum(anorm, torch.amax(torch.linalg.norm(hess, dim=(0, 1))))
            it += 1
        r_final = b - matvec(x)
        xnorm = torch.linalg.norm(x, dim=0)
        # the Hessenberg's norm measures the preconditioned operator: take
        # the max with the per-column ||A x|| / ||x||
        ax_norm = torch.linalg.norm(b - r_final, dim=0)
        anorm = torch.maximum(anorm, torch.amax(ax_norm / torch.clamp(xnorm, min=1e-30)))
        col_scale = anorm * xnorm + torch.linalg.norm(b, dim=0)
        report = SolveReport(
            residual_norm=torch.linalg.norm(r_final),
            rhs_norm=torch.linalg.norm(b),
            scale_norm=anorm * torch.linalg.norm(x) + torch.linalg.norm(b),
            cond_est=None,
            col_backward=torch.linalg.norm(r_final, dim=0) / torch.clamp(col_scale, min=1e-30),
        )
    return x, report
