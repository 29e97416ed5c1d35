"""Matrix-free Krylov solvers (port of facedeform_tpu/ops/krylov.py): the
large-rig fit route and the inner solver of GMRES-IR.

Past the dense route's control count (ops/fit._KRYLOV_THRESHOLD) the
saddle system is never materialized: a chunked matvec

    (A x)_i = sum_j phi(|c_i - c_j| / eps_j) x_j + lam_i x_i + (P c)_i

drives

  * restarted GMRES for QNN, whose per-point radii make the system
    non-symmetric (column j carries eps_j), block-Jacobi right-
    preconditioned; GMRES is also the inner solver of the growing
    kernels' GMRES-IR refinement (ops/solve.lu_solve_refined_against_df);
  * preconditioned MINRES for the symmetric MULTILAYER/KERNEL systems:
    block-Jacobi for the positive-definite kernels, the spectral
    absolute value of Z-ordered blocks for the conditionally PD ones
    (TPS/MQ/linear/cubic), whose diagonal blocks are indefinite;
  * plain MINRES for any symmetric indefinite system.

Each iteration costs one O(N^2) kernel sweep; the JAX package computes it
in XLA, with no Pallas kernel, and so does the port, in plain torch.  The
solvers run a host loop that reads one convergence flag per iteration and
stop by the JAX package's rules, so the iteration counts match on the same
inputs.  Every contraction runs with TF32 off.

The opt-in precise path (make_saddle_matvec_df_pair, make_saddle_matvec_df,
pminres_df) is double-float in the JAX package; the H100 has native
float64, so here phi and the contraction run in float64, and the (hi, lo)
f32 pairs of the JAX interface carry its rounding.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from facedeform_tpu_torch.config import PolyTerm, RBFKernel
from facedeform_tpu_torch.ops.assemble import poly_basis
from facedeform_tpu_torch.ops.kernels import apply_kernel, pairwise_sqdist
from facedeform_tpu_torch.ops.solve import SolveReport
from facedeform_tpu_torch.utils import profiling
from facedeform_tpu_torch.utils.precision import highest_precision

profiling.count("fit.gmres_restarts", 0)

Matvec = Callable[[torch.Tensor], torch.Tensor]


def _lam_col(lam, n: int, dtype, device) -> torch.Tensor:
    """Ridge as a scalar or an (N, 1) column against (N, k) operands."""
    lam = torch.as_tensor(lam, dtype=dtype, device=device)
    return lam.reshape(n, 1) if lam.ndim == 1 else lam


def _saddle_matvec(ctrl, kernel, term, eps, lam, tail_reg, chunk) -> Matvec:
    """The saddle matvec in ctrl's dtype: phi row chunks of `chunk`
    controls contracted against x's top block, plus the ridge and the
    polynomial coupling."""
    n = ctrl.shape[0]
    p = poly_basis(ctrl, term)
    m = p.shape[1]
    eps = torch.as_tensor(eps, dtype=ctrl.dtype, device=ctrl.device)
    lam = _lam_col(lam, n, ctrl.dtype, ctrl.device)

    def matvec(x: torch.Tensor) -> torch.Tensor:      # (N + m, k)
        xw, xc = x[:n], x[n:]
        with highest_precision():
            y_top = torch.cat([
                apply_kernel(kernel, pairwise_sqdist(rows, ctrl), eps) @ xw
                for rows in torch.split(ctrl, chunk)
            ])
            y_top = y_top + lam * xw
            if not m:
                return y_top
            y_top = y_top + p @ xc
            y_bot = p.T @ xw - tail_reg * xc
        return torch.cat([y_top, y_bot])

    return matvec


def make_saddle_matvec(
    ctrl: torch.Tensor,
    kernel: RBFKernel,
    term: PolyTerm,
    eps,
    lam,
    tail_reg: float = 1e-8,
    chunk: int = 2048,
) -> Matvec:
    """Matvec of the (N + m, N + m) saddle system, never materialized, in
    f32: O(chunk x N) memory.  eps is a scalar or (N,) (per-point radii
    give QNN's non-symmetric system), lam a scalar or (N,) ridge."""
    return _saddle_matvec(ctrl.float(), kernel, term, eps, lam, tail_reg, chunk)


def make_saddle_matvec_df_pair(
    ctrl: torch.Tensor,
    kernel: RBFKernel,
    term: PolyTerm,
    eps,
    lam,
    tail_reg: float = 1e-8,
    chunk: int = 2048,
) -> Callable:
    """The saddle matvec over an (x_hi, x_lo) f32 pair, returning the pair
    (y_hi, y_lo) of A (x_hi + x_lo): the operand, phi (from the f32
    coordinates), the contraction, the ridge and the tail all in float64,
    the result split into f32 words.  The JAX package's double-float
    sweep, pminres_df's operator."""
    n = ctrl.shape[0]
    eps64 = torch.broadcast_to(torch.as_tensor(eps, device=ctrl.device).double(), (n,))
    lam64 = torch.as_tensor(lam, device=ctrl.device).double()
    mv64 = _saddle_matvec(ctrl.float().double(), kernel, term, eps64, lam64, tail_reg, chunk)

    def matvec(x):
        x_hi, x_lo = x
        y = mv64(x_hi.double() + x_lo.double())
        return _split(y)

    return matvec


def make_saddle_matvec_df(
    ctrl: torch.Tensor,
    kernel: RBFKernel,
    term: PolyTerm,
    eps,
    lam,
    tail_reg: float = 1e-8,
    chunk: int = 2048,
) -> Matvec:
    """make_saddle_matvec computed in float64 and rounded to f32 once: the
    f32 Krylov route's noise floor on growing kernels is phi's f32
    evaluation error, which this removes (standalone residual sweeps)."""
    pair = make_saddle_matvec_df_pair(ctrl, kernel, term, eps, lam, tail_reg, chunk)

    def matvec(x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return pair((x, torch.zeros_like(x)))[0]

    return matvec


def _split(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float64 -> (hi, lo) f32 words, hi + lo == y to ~2^-48."""
    hi = y.float()
    return hi, (y - hi.double()).float()


def _batched_sqdist(c: torch.Tensor) -> torch.Tensor:
    """(nb, B, 3) -> (nb, B, B) squared distances within each block, from
    exact per-coordinate differences (pairwise_sqdist's arithmetic)."""
    d = [c[..., :, None, i] - c[..., None, :, i] for i in range(3)]
    return d[0] * d[0] + d[1] * d[1] + d[2] * d[2]


def _blocks(ctrl, eps, lam, block: int):
    """Controls, radii and ridge padded to whole blocks: (nb, B, 3),
    (nb, B), (nb, B), pad.  Padded radii are 1; the ridge is edge-padded:
    the padded all-at-origin rows share the last block with real markers,
    and a zero ridge there would leave that mixed block's padded
    sub-matrix (all-ones gaussian) with only the jitter on its diagonal,
    cond ~lam / jitter worse than the real system."""
    n = ctrl.shape[0]
    pad = (-n) % block
    eps = torch.broadcast_to(torch.as_tensor(eps, dtype=ctrl.dtype, device=ctrl.device), (n,))
    lam = torch.broadcast_to(torch.as_tensor(lam, dtype=ctrl.dtype, device=ctrl.device), (n,))
    ctrl_p = torch.cat([ctrl, ctrl.new_zeros((pad, 3))])
    eps_p = torch.cat([eps, eps.new_ones((pad,))])
    lam_p = torch.cat([lam, lam[-1:].expand(pad)])
    nb = ctrl_p.shape[0] // block
    return ctrl_p.reshape(nb, block, 3), eps_p.reshape(nb, block), lam_p.reshape(nb, block), pad


def _block_msolve(n: int, pad: int, block: int, apply_blocks) -> Matvec:
    """Preconditioner on the top block through apply_blocks((nb, B, k)),
    identity on the polynomial-tail rows."""

    def msolve(r: torch.Tensor) -> torch.Tensor:      # (N + m, k)
        top, tail = r[:n], r[n:]
        k = r.shape[1]
        t = torch.cat([top, top.new_zeros((pad, k))])
        with highest_precision():
            out = apply_blocks(t.reshape(-1, block, k))
        return torch.cat([out.reshape(-1, k)[:n], tail])

    return msolve


def make_block_jacobi(
    ctrl: torch.Tensor,
    kernel: RBFKernel,
    term: PolyTerm,
    eps,
    lam,
    block: int = 512,
    jitter: float = 1e-5,
) -> Matvec:
    """Block-Jacobi approximate inverse of the saddle system's top block.

    The (block x block) diagonal blocks of Phi + (lam + jitter) I are
    inverted batched and explicitly (torch.linalg.inv: the blocks are
    strongly diagonally dominant for the radii the model families produce,
    so the inverse is stable and its application one batched matmul);
    identity on the polynomial-tail rows.  Block (b, i, j) uses the radius
    of column j (QNN's per-point radii).  Valid as a MINRES preconditioner
    for PD kernels only (gaussian, IMQ, Wendland: SPD blocks); usable for
    GMRES unconditionally.  `term` is the JAX signature's; the tail rows
    are whatever r carries past the N controls.  Built and applied in
    ctrl's dtype (f32 on the fit route)."""
    n = ctrl.shape[0]
    cb, eb, lb, pad = _blocks(ctrl, eps, lam, block)
    eye = torch.eye(block, dtype=ctrl.dtype, device=ctrl.device)
    blocks = apply_kernel(kernel, _batched_sqdist(cb), eb[:, None, :])
    blocks = blocks + (lb + jitter)[:, None, :] * eye
    with highest_precision():
        inv_blocks = torch.linalg.inv(blocks)

    return _block_msolve(n, pad, block, lambda t: inv_blocks @ t)


def make_abs_block_jacobi(
    ctrl: torch.Tensor,
    kernel: RBFKernel,
    term: PolyTerm,
    eps,
    lam,
    block: int = 512,
    spatial: bool = True,
) -> Matvec:
    """Absolute-value block-Jacobi: an SPD preconditioner for the CPD
    kernels (TPS/MQ/linear/cubic), whose diagonal blocks are symmetric
    indefinite (Vecharynski & Knyazev).  Each block B = Q diag(w) Q^T gives
    M_b^-1 = Q diag(1 / max(|w|, 1e-7 |w|_max)) Q^T: SPD by construction,
    two batched matmuls a application after one batched eigh.

    spatial=True Z-orders the controls first (ops/morton), so that each
    block covers a neighbourhood and captures the kernel's strong
    short-range coupling.  Padded rows and columns decouple to the
    identity, so the one mixed block's spectrum is the real sub-block's
    plus unit eigenvalues.  Identity on the polynomial-tail rows.  Built
    and applied in ctrl's dtype (f32 on the fit route)."""
    from facedeform_tpu_torch.ops.morton import spatial_order

    n = ctrl.shape[0]
    eps = torch.broadcast_to(torch.as_tensor(eps, dtype=ctrl.dtype, device=ctrl.device), (n,))
    lam = torch.broadcast_to(torch.as_tensor(lam, dtype=ctrl.dtype, device=ctrl.device), (n,))
    perm = inv_perm = None
    if spatial:
        perm, inv_perm = spatial_order(ctrl)
        ctrl, eps, lam = ctrl[perm], eps[perm], lam[perm]
    cb, eb, lb, pad = _blocks(ctrl, eps, lam, block)
    eye = torch.eye(block, dtype=ctrl.dtype, device=ctrl.device)
    valid = (torch.arange(n + pad, device=ctrl.device) < n).reshape(-1, block)
    blocks = apply_kernel(kernel, _batched_sqdist(cb), eb[:, None, :])
    blocks = blocks + lb[:, None, :] * eye
    blocks = torch.where(valid[:, :, None] & valid[:, None, :], blocks, eye)
    with highest_precision():
        w_eig, q = torch.linalg.eigh(blocks)
    amax = torch.amax(torch.abs(w_eig), dim=-1, keepdim=True)
    inv_abs = 1.0 / torch.maximum(torch.abs(w_eig), torch.clamp(amax * 1e-7, min=1e-20))

    inner = _block_msolve(
        n, pad, block, lambda t: q @ ((q.transpose(-1, -2) @ t) * inv_abs[..., None]))
    if not spatial:
        return inner

    def msolve(r: torch.Tensor) -> torch.Tensor:
        out = inner(torch.cat([r[:n][perm], r[n:]]))
        return torch.cat([out[:n][inv_perm], out[n:]])

    return msolve


def _report(b, x, r_final, anorm) -> SolveReport:
    """Backward-error report of a Krylov solve from its true final
    residual; anorm estimates ||A||."""
    xnorm = torch.linalg.norm(x, dim=0)
    col_scale = anorm * xnorm + torch.linalg.norm(b, dim=0)
    return SolveReport(
        residual_norm=torch.linalg.norm(r_final),
        rhs_norm=torch.linalg.norm(b),
        scale_norm=anorm * torch.linalg.norm(x) + torch.linalg.norm(b),
        cond_est=None,
        col_backward=torch.linalg.norm(r_final, dim=0) / torch.clamp(col_scale, min=1e-30),
    )


def _rayleigh_anorm(lanczos_anorm, b, x, r_final):
    """The Lanczos/Hessenberg estimate measures the PRECONDITIONED
    operator (~1 by construction), not ||A||: take the max with the
    per-column ||A x|| / ||x||, or healthy solves read as failures."""
    ax_norm = torch.linalg.norm(b - r_final, dim=0)
    xnorm = torch.linalg.norm(x, dim=0)
    return torch.maximum(torch.amax(lanczos_anorm),
                         torch.amax(ax_norm / torch.clamp(xnorm, min=1e-30)))


def _running(it: int, maxiter: int, resid, tol, bnorm) -> bool:
    """The JAX package's loop condition (one host read an iteration)."""
    return it < maxiter and bool(profiling.to_host(
        torch.any(resid > tol * torch.clamp(bnorm, min=1e-30))))


def _pminres(matvec, b, msolve, tol, maxiter, x0, alive_floor):
    """The PMINRES recurrence in b's dtype (Elman, Silvester & Wathen:
    Lanczos on M^-1 A in the M inner product, per-column (k,) Lanczos and
    Givens scalars); returns (x, report of the true final residual)."""
    k = b.shape[1]
    r = b if x0 is None else b - matvec(x0)
    z = msolve(r)
    zr = torch.sum(z * r, dim=0)
    # dead-column guard: a zero (or converged) column would floor gamma1
    # at 1e-15, which never decays through the Givens recurrence; zero
    # its tracked residual, its update stays 0
    alive0 = zr > alive_floor
    one = torch.ones((k,), dtype=b.dtype, device=b.device)
    gamma = torch.where(alive0, torch.sqrt(torch.clamp(zr, min=1e-30)), one)
    eta = torch.where(alive0, gamma, torch.zeros_like(gamma))
    bnorm = torch.linalg.norm(b, dim=0)
    x = torch.zeros_like(b)
    v, v_prev = r, torch.zeros_like(b)
    w, w_prev = torch.zeros_like(b), torch.zeros_like(b)
    gamma_prev, c1, c0 = one, one, one
    s1 = s0 = torch.zeros_like(one)
    anorm = torch.zeros_like(one)
    resid, it = eta, 0
    while _running(it, maxiter, resid, tol, bnorm):
        zj = z / gamma
        azj = matvec(zj)
        delta = torch.sum(zj * azj, dim=0)
        v_new = azj - (delta / gamma) * v - (gamma / gamma_prev) * v_prev
        z = msolve(v_new)
        gamma_new = torch.sqrt(torch.clamp(torch.sum(z * v_new, dim=0), min=1e-30))
        alpha0 = c1 * delta - c0 * s1 * gamma
        alpha1 = torch.clamp(torch.sqrt(alpha0 * alpha0 + gamma_new * gamma_new), min=1e-30)
        alpha2 = s1 * delta + c0 * c1 * gamma
        alpha3 = s0 * gamma
        c1n = alpha0 / alpha1
        s1n = gamma_new / alpha1
        w_new = (zj - alpha3 * w_prev - alpha2 * w) / alpha1
        x = x + (c1n * eta) * w_new
        eta = -s1n * eta
        anorm = torch.maximum(
            anorm, torch.sqrt(delta * delta + gamma * gamma + gamma_new * gamma_new))
        v_prev, v = v, v_new
        w_prev, w = w, w_new
        gamma_prev, gamma = gamma, gamma_new
        c0, c1, s0, s1 = c1, c1n, s1, s1n
        resid, it = torch.abs(eta), it + 1
    if x0 is not None:
        x = x + x0
    r_final = b - matvec(x)
    return x, _report(b, x, r_final, _rayleigh_anorm(anorm, b, x, r_final))


def pminres(
    matvec: Matvec,
    b: torch.Tensor,
    msolve: Matvec,
    tol: float = 1e-7,
    maxiter: int = 256,
    x0: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, SolveReport]:
    """Preconditioned MINRES (SPD preconditioner), all columns of b (n, k)
    in lockstep, in f32.  The tracked residual |eta| is in the M^-1 norm;
    the report carries the true final residual.  Stops when every column's
    tracked residual is within tol * ||b_col|| or after maxiter
    iterations; x0 warm-starts from its residual."""
    with highest_precision():
        return _pminres(matvec, b.float(), msolve, tol, maxiter,
                        None if x0 is None else x0.float(), 1e-25)


def pminres_df(
    matvec_df: Callable,
    b: torch.Tensor,
    msolve: Matvec,
    tol: float = 1e-11,
    maxiter: int = 256,
    x0=None,
) -> tuple[tuple[torch.Tensor, torch.Tensor], SolveReport]:
    """Preconditioned MINRES with every vector in float64 (the JAX
    package's double-float vectors): f32 PMINRES on the growing kernels
    stalls at eps32 ||A|| ||x|| / ||b|| because the f32 storage of the
    iterate and the Lanczos basis pins the floor, whatever the matvec's
    precision.  matvec_df is make_saddle_matvec_df_pair's (hi, lo) ->
    (hi, lo) operator; the preconditioner stays f32 (it shapes the
    convergence, not the attainable accuracy).  x0 is an f32 tensor or an
    (hi, lo) pair.  Returns ((x_hi, x_lo), report); the report's residual
    is the float64 one, its fields f32."""

    def mv(u):
        hi, lo = matvec_df(_split(u))
        return hi.double() + lo.double()

    def prec(u):
        return msolve(u.float()).double()

    if isinstance(x0, tuple):
        x0 = x0[0].double() + x0[1].double()
    elif x0 is not None:
        x0 = x0.double()
    with highest_precision():
        x, report = _pminres(mv, b.float().double(), prec, tol, maxiter, x0, 1e-30)
    return _split(x), SolveReport(*(None if f is None else f.float() for f in report))


def gmres(
    matvec: Matvec,
    b: torch.Tensor,
    msolve: Optional[Matvec] = None,
    tol: float = 1e-7,
    restart: int = 32,
    max_restarts: int = 16,
    x0: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, SolveReport]:
    """Right-preconditioned restarted GMRES(restart), all columns of b
    (n, k) in lockstep: solves A M^-1 u = b, x = M^-1 u (msolve None: the
    identity).

    Arnoldi runs classical Gram-Schmidt with one reorthogonalization pass
    (CGS2) for every column at once, each Hessenberg column is solved by
    normal equations with a 1e-12 ridge, and restarts continue while ANY
    column's residual exceeds tol * ||b_col||, so the column count changes
    the iterates.  x0 warm-starts the first restart; its true residual is
    computed first (one matvec), so a converged x0 exits at once.  GMRES-IR
    solves each correction equation cold (x0 None).  f32 throughout, TF32
    off.  Returns (x, report) with cond_est None, as the JAX package builds
    it.
    """
    if msolve is None:
        def msolve(v):
            return v

    b = b.float()
    n, k = b.shape
    m = restart
    with highest_precision():
        bnorm = torch.linalg.norm(b, dim=0)                          # (k,)
        if x0 is None:
            x, resid = torch.zeros_like(b), bnorm
        else:
            x = x0.float()
            resid = torch.linalg.norm(b - matvec(x), dim=0)
        anorm = torch.zeros((), dtype=torch.float32, device=b.device)
        it = 0
        while _running(it, max_restarts, resid, tol, bnorm):
            profiling.count("fit.gmres_restarts")
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
            with profiling.blocking(b.device):                      # its error check
                y = torch.linalg.solve(hth, h_t @ g)[..., 0]         # (k, m)
            x = x + msolve(torch.einsum("ink,ki->nk", basis[:m], y))
            resid = torch.linalg.norm(b - matvec(x), dim=0)
            anorm = torch.maximum(anorm, torch.amax(torch.linalg.norm(hess, dim=(0, 1))))
            it += 1
        r_final = b - matvec(x)
        report = _report(b, x, r_final, _rayleigh_anorm(anorm, b, x, r_final))
    return x, report


def minres(
    matvec: Matvec,
    b: torch.Tensor,
    tol: float = 1e-7,
    maxiter: int = 256,
    x0: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, SolveReport]:
    """MINRES (Paige & Saunders) for symmetric, possibly indefinite
    systems, all columns of b in lockstep with per-column (k,) scalars.  A
    warm start x0 restarts the Krylov space on its residual; the stopping
    rule and the report are relative to the full right-hand side.  The
    report's ||A|| is the Lanczos estimate max_j ||T e_j||."""
    b_full = b.float()
    k = b_full.shape[1]
    with highest_precision():
        b = b_full if x0 is None else b_full - matvec(x0.float())
        bnorm = torch.linalg.norm(b_full, dim=0)
        beta = torch.linalg.norm(b, dim=0)
        safe_beta1 = torch.where(beta > 0, torch.clamp(beta, min=1e-30), torch.ones_like(beta))
        one = torch.ones((k,), dtype=torch.float32, device=b.device)
        x = torch.zeros_like(b)
        v, v_prev = b / safe_beta1, torch.zeros_like(b)
        w, w_old = torch.zeros_like(b), torch.zeros_like(b)
        eta = beta
        gamma1 = gamma0 = one
        sigma1 = sigma0 = torch.zeros_like(one)
        anorm = torch.zeros_like(one)
        resid, it = beta, 0
        while _running(it, maxiter, resid, tol, bnorm):
            av = matvec(v)
            alpha = torch.sum(v * av, dim=0)
            av = av - alpha * v - beta * v_prev
            beta_new = torch.linalg.norm(av, dim=0)
            v_new = av / torch.clamp(beta_new, min=1e-30)
            delta = gamma1 * alpha - gamma0 * sigma1 * beta
            rho1 = torch.clamp(torch.sqrt(delta * delta + beta_new * beta_new), min=1e-30)
            rho2 = sigma1 * alpha + gamma0 * gamma1 * beta
            rho3 = sigma0 * beta
            gamma2 = delta / rho1
            sigma2 = beta_new / rho1
            w_new = (v - rho3 * w_old - rho2 * w) / rho1
            x = x + (gamma2 * eta) * w_new
            eta = -sigma2 * eta
            anorm = torch.maximum(
                anorm, torch.sqrt(alpha * alpha + beta * beta + beta_new * beta_new))
            v_prev, v, beta = v, v_new, beta_new
            w_old, w = w, w_new
            gamma0, gamma1, sigma0, sigma1 = gamma1, gamma2, sigma1, sigma2
            resid, it = torch.abs(eta), it + 1
        if x0 is not None:
            x = x + x0.float()
        r_final = b_full - matvec(x)
        report = _report(b_full, x, r_final, torch.amax(anorm))
    return x, report
