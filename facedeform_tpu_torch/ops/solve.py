"""Dense linear solve: f32 LU + iterative refinement with a float64 residual
(port of the dense route of facedeform_tpu/ops/solve.py).

The JAX package factorizes in f32 and evaluates the refinement residual
B - A X in emulated double precision (a Dekker-split, double-float
pairwise tree), because the TPU has no float64.  That tree approximates
exactly the float64 residual of the f32 matrix against the f32 solution
pair, and the H100 has native fp64, so the port computes the residual in
float64 directly.  The f32 LU, the double-float solution pair
(x_hi, x_lo) and the SolveReport semantics stay as they are.

Growing kernels solve against the float64 system split into f32 words
(assemble.assemble_system_df): lu_solve_refined_against_df factors a_hi
and refines by GMRES-IR with float64 residuals against a_hi + a_lo, or
stationarily (gmres_ir=False) for the well-conditioned batched patch
systems of the partition-of-unity fit (ops/pu.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from facedeform_tpu_torch.ops import cuda_solve
from facedeform_tpu_torch.utils import profiling
from facedeform_tpu_torch.utils.precision import highest_precision

profiling.count("fit.lu_solves", 0)


class SolveReport(NamedTuple):
    """Structured solver outcome.  The health criterion is the normwise
    backward error residual / (||A|| ||X|| + ||B||)."""

    residual_norm: torch.Tensor  # ||B - A X||_F after refinement
    rhs_norm: torch.Tensor       # ||B||_F
    # ||A||_F ||X||_F + ||B||_F — backward-error denominator
    scale_norm: Optional[torch.Tensor] = None
    # max |diag U| / min |diag U|: growth-factor condition indicator
    cond_est: Optional[torch.Tensor] = None
    # per-column backward errors ||r_c|| / (||A|| ||x_c|| + ||b_c||), (k,)
    col_backward: Optional[torch.Tensor] = None

    def backward_error(self) -> torch.Tensor:
        """Normwise backward error."""
        denom = self.scale_norm if self.scale_norm is not None else self.rhs_norm
        return self.residual_norm / torch.clamp(denom, min=1e-30)


def _report_from(a_norm, lu_diag, x, b, r) -> SolveReport:
    """Assemble the full report given the factor diagonal and residual.
    Works with a leading batch axis on lu_diag/x/b/r (one report field
    per system), as the JAX package's vmapped reports carry."""
    x_norm = torch.linalg.norm(x, dim=(-2, -1))
    b_norm = torch.linalg.norm(b, dim=(-2, -1))
    absd = torch.abs(lu_diag)
    cond = torch.amax(absd, dim=-1) / torch.clamp(torch.amin(absd, dim=-1), min=1e-30)
    col_scale = a_norm[..., None] * torch.linalg.norm(x, dim=-2) + torch.linalg.norm(b, dim=-2)
    col_back = torch.linalg.norm(r, dim=-2) / torch.clamp(col_scale, min=1e-30)
    return SolveReport(
        residual_norm=torch.linalg.norm(r, dim=(-2, -1)),
        rhs_norm=b_norm,
        scale_norm=a_norm * x_norm + b_norm,
        cond_est=cond,
        col_backward=col_back,
    )


class LUFactors(NamedTuple):
    """An f32 LU factorization: LAPACK's lu and pivots and, for a factor
    the kernel of cuda_solve can solve against (cuda_solve.takes_factor: a
    2-D f32 factor on the card), what it reads beside them, computed once
    so that no solve recomputes it: the pivots' row permutation
    (cuda_solve.lu_perm) and the diagonal blocks' inverses
    (cuda_solve.block_inverses).  Factors without them, LUFactors(lu, piv),
    take torch.linalg.lu_solve."""

    lu: torch.Tensor
    piv: torch.Tensor
    perm: Optional[torch.Tensor] = None
    dinv: Optional[torch.Tensor] = None


def _factors(lu: torch.Tensor, piv: torch.Tensor) -> LUFactors:
    if not cuda_solve.takes_factor(lu):
        return LUFactors(lu, piv)
    return LUFactors(lu, piv, cuda_solve.lu_perm(piv), cuda_solve.block_inverses(lu))


def lu_factor_hp(a: torch.Tensor) -> LUFactors:
    """f32 LU factorization with TF32 off.

    lu_factor_ex does not raise on a zero pivot: a singular system shows
    up as a non-finite backward error in the SolveReport, which
    errors.check_solve turns into SolveFailedError (the JAX package's
    behaviour).  A span, fit.factor."""
    with profiling.span("fit.factor"), highest_precision():
        lu, piv, _ = torch.linalg.lu_factor_ex(a.float())
        return _factors(lu, piv)


def _as_factors(lu_piv) -> LUFactors:
    """LUFactors from lu_factor_hp's output or a caller's (lu, piv) pair,
    converted once where a public function accepts one."""
    return lu_piv if isinstance(lu_piv, LUFactors) else _factors(*lu_piv)


def lu_solve(f: LUFactors, b: torch.Tensor) -> torch.Tensor:
    """Solve against LU factors, counted in fit.lu_solves.  Factors that
    carry the permutation and diagonal-block inverses (lu_factor_hp's of a
    2-D f32 factor on the card), with 1 to cuda_solve.K_MAX right-hand-side
    columns in a solve autograd need not differentiate, go to the
    hand-written kernel (cuda_solve.takes); anything else to
    torch.linalg.lu_solve."""
    profiling.count("fit.lu_solves")
    if cuda_solve.takes(f, b):
        return cuda_solve.lu_solve_cuda(f.lu, f.perm, f.dinv, b)
    return torch.linalg.lu_solve(f.lu, f.piv, b)


def _residual64(a64: torch.Tensor, x_hi, x_lo, b64: torch.Tensor) -> torch.Tensor:
    """B - A (x_hi + x_lo) in float64, rounded to f32.  This is the value
    the JAX package's double-float residual tree approximates."""
    x = x_hi.double()
    if x_lo is not None:
        x = x + x_lo.double()
    return (b64 - a64 @ x).float()


def _two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Knuth TwoSum: s + e == a + b exactly.  Eager PyTorch runs each op as
    its own rounded f32 kernel, so nothing contracts or reassociates it."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _lu_refined_impl(a, b, n_refine, want_lo, f=None):
    """Iterative refinement with the solution kept in double-float.

    Folding each correction into an f32 x would re-round the solution every
    sweep and stall the forward error near u * cond; carrying (x_hi, x_lo)
    converges it to ~cond * u^2.  Returns ((x_hi, x_lo), report, f), f the
    LUFactors of a (factored here unless given).

    b may carry a leading batch axis (F, n, k) against one (n, n) system
    a; f then holds F factorizations of a (the per-pose route of
    fit_frames), and the report's fields carry the batch axis.
    """
    a = a.float()
    b = b.float()
    a64, b64 = a.double(), b.double()
    with highest_precision():
        f = lu_factor_hp(a) if f is None else f
        x_hi = lu_solve(f, b)
        x_lo = torch.zeros_like(x_hi)
        for _ in range(n_refine):
            r = _residual64(a64, x_hi, x_lo, b64)
            dx = lu_solve(f, r)
            # bits of dx lost rounding into x_hi go to x_lo
            x_hi, e = _two_sum(x_hi, dx)
            x_lo = x_lo + e
    # The caller of want_lo=False receives x_hi alone: report the residual
    # of that f32 solution, not of the internal pair.
    r = _residual64(a64, x_hi, x_lo if want_lo else None, b64)
    report = _report_from(
        torch.linalg.norm(a), torch.diagonal(f.lu, dim1=-2, dim2=-1), x_hi, b, r
    )
    if not want_lo:
        x_lo = torch.zeros_like(x_hi)
    return (x_hi, x_lo), report, f


def lu_solve_refined(
    a: torch.Tensor, b: torch.Tensor, n_refine: int = 2
) -> tuple[torch.Tensor, SolveReport]:
    """Solve A X = B (A: (n, n), B: (n, k)) in f32 with refinement; returns
    the f32 solution and its SolveReport (see errors.check_solve)."""
    (x, _), report, _ = _lu_refined_impl(a, b, n_refine, want_lo=False)
    return x, report


def lu_solve_refined_df(
    a: torch.Tensor, b: torch.Tensor, n_refine: int = 2
) -> tuple[tuple[torch.Tensor, torch.Tensor], SolveReport]:
    """lu_solve_refined returning the solution pair (x_hi, x_lo): x_lo holds
    the sub-f32 bits the precise eval contracts against."""
    x_pair, report, _ = _lu_refined_impl(a, b, n_refine, want_lo=True)
    return x_pair, report


def lu_solve_refined_factored(
    a: torch.Tensor, b: torch.Tensor, n_refine: int = 2
) -> tuple[torch.Tensor, SolveReport, tuple[torch.Tensor, torch.Tensor]]:
    """lu_solve_refined that also returns the (lu, piv) factors: LOOCV
    (ops/loocv.py) derives the inverse diagonal of the same matrix from
    them with two triangular solves instead of a second factorization."""
    (x, _), report, f = _lu_refined_impl(a, b, n_refine, want_lo=False)
    return x, report, (f.lu, f.piv)


def cholesky_solve_refined(
    a: torch.Tensor, b: torch.Tensor, n_refine: int = 2
) -> tuple[torch.Tensor, SolveReport]:
    """Symmetric positive-definite solve (the DBSE normal equations): f32
    Cholesky, n_refine sweeps of refinement with float64 residuals, the
    solution kept in f32 as the JAX package keeps it.  a (..., n, n) and
    b (..., n, k) may carry a leading batch axis (one report field per
    system).  A factorization that fails (not positive definite) gives
    NaN, so the report's backward error is non-finite, as JAX's is."""
    a = a.float()
    b = b.float()
    a64, b64 = a.double(), b.double()
    with highest_precision():
        c, info = torch.linalg.cholesky_ex(a)
        c = torch.where((info != 0)[..., None, None], torch.full_like(c, float("nan")), c)
        x = torch.cholesky_solve(b, c)
        for _ in range(n_refine):
            r = _residual64(a64, x, None, b64)
            x = x + torch.cholesky_solve(r, c)
    r = _residual64(a64, x, None, b64)
    # the Cholesky diagonal enters the condition squared (A = L L^T)
    diag = torch.diagonal(c, dim1=-2, dim2=-1)
    return x, _report_from(torch.linalg.norm(a, dim=(-2, -1)), diag * diag, x, b, r)


def lu_resolve_refined_df(
    lu_piv, a: torch.Tensor, b: torch.Tensor, n_refine: int = 2
) -> tuple[tuple[torch.Tensor, torch.Tensor], SolveReport]:
    """lu_solve_refined_df against precomputed factors of a: lu_factor_hp's
    LUFactors or an (lu, piv) pair."""
    x_pair, report, _ = _lu_refined_impl(a, b, n_refine, want_lo=True, f=_as_factors(lu_piv))
    return x_pair, report


def _map_col_blocks(refine_fn, b: torch.Tensor, kb: int = 3):
    """refine_fn((..., n, kb) block) -> (x_hi, x_lo, r) over b's columns in
    consecutive kb-column groups, run one after another.  GMRES ends on its
    `any`-column test, so the block width is part of the result: kb = 3
    keeps one pose's xyz together (the packed frames layout is frame-major
    3-column groups).  Each block is made contiguous, so a pose solves
    exactly as its own (n, 3) right-hand side would.  A leading batch axis
    (one system per patch) rides along."""
    k = b.shape[-1]
    if k <= kb:
        return refine_fn(b.contiguous())
    outs = [refine_fn(blk.contiguous()) for blk in torch.split(b, kb, dim=-1)]
    return tuple(torch.cat(parts, dim=-1) for parts in zip(*outs))


class DFSystem(NamedTuple):
    """What a refined solve against a_hi + a_lo reads besides its
    right-hand side (df_system): the f32 words where GMRES-IR's operator
    reads them (None under stationary refinement, which never does; so
    their presence selects GMRES-IR in solve_df), the
    f32 LU of a_hi, the float64 system a_hi + a_lo each residual runs
    against, and ||a_hi||_F for the report.  A leading batch axis (one
    system per partition-of-unity patch) rides on every field.  It holds
    nothing of a right-hand side, so a caller that re-solves one system
    for many may keep it (ops/pu.PUFitPlan)."""

    a_hi: Optional[torch.Tensor]
    a_lo: Optional[torch.Tensor]
    f: LUFactors
    a64: torch.Tensor
    a_norm: torch.Tensor


def df_system(a_hi, a_lo, gmres_ir=True, f=None) -> DFSystem:
    """The DFSystem of (a_hi + a_lo): a_hi factored here unless its
    LUFactors f are given.  A batch solved by GMRES-IR goes one system
    after another, so its norms are taken one system at a time too."""
    a_hi, a_lo = a_hi.float(), a_lo.float()
    with highest_precision():
        f = lu_factor_hp(a_hi) if f is None else f
    a64 = a_hi.double() + a_lo.double()
    if gmres_ir and a_hi.ndim == 3:
        a_norm = torch.stack([torch.linalg.norm(a, dim=(-2, -1)) for a in a_hi])
    else:
        a_norm = torch.linalg.norm(a_hi, dim=(-2, -1))
    if not gmres_ir:
        a_hi = a_lo = None
    return DFSystem(a_hi, a_lo, f, a64, a_norm)


def solve_df(s: DFSystem, b, n_refine):
    """Solve (a_hi + a_lo) X = b against a DFSystem with the solution kept
    as (x_hi, x_lo).

    Each sweep's residual b - (a_hi + a_lo)(x_hi + x_lo) is float64.  With
    GMRES-IR (a system that keeps its words) its correction equation is solved by LU-preconditioned GMRES
    (GMRES-IR, Carson & Higham), which converges where stationary
    refinement stalls at cond * u ~ 1; its f32 operator is
    a_hi @ v + a_lo @ v as two separate products, never (a_hi + a_lo) @ v,
    whose f32 sum would round a_lo away.  Without it, each sweep is one
    LU-preconditioned correction (stationary refinement).

    A batch of K systems (the partition-of-unity patches) takes b (K, n,
    k): the stationary sweeps run batched, GMRES-IR one system after
    another, each against its slice of the batched factors, as
    torch.linalg.lu_solve takes them.  Returns ((x_hi, x_lo), report), the
    report's fields with the leading K axis."""
    from facedeform_tpu_torch.ops.krylov import gmres

    b = b.float()
    gmres_ir = s.a_hi is not None
    if gmres_ir and s.a64.ndim == 3:
        outs = [solve_df(DFSystem(s.a_hi[i], s.a_lo[i], LUFactors(s.f.lu[i], s.f.piv[i]),
                                  s.a64[i], s.a_norm[i]), b[i], n_refine)
                for i in range(s.a64.shape[0])]
        x_hi = torch.stack([o[0][0] for o in outs])
        x_lo = torch.stack([o[0][1] for o in outs])
        return (x_hi, x_lo), SolveReport(*(torch.stack(f) for f in zip(*[o[1] for o in outs])))
    with highest_precision():

        def msolve(v):
            return lu_solve(s.f, v)

        def matvec(v):
            return s.a_hi @ v + s.a_lo @ v

        def refine(b_blk):
            b64 = b_blk.double()
            x_hi = msolve(b_blk)
            x_lo = torch.zeros_like(x_hi)
            for _ in range(n_refine):
                r = _residual64(s.a64, x_hi, x_lo, b64)
                if gmres_ir:
                    dx, _ = gmres(matvec, r, msolve, restart=16, max_restarts=2)
                else:
                    dx = msolve(r)
                x_hi, e = _two_sum(x_hi, dx)
                x_lo = x_lo + e
            return x_hi, x_lo, _residual64(s.a64, x_hi, x_lo, b64)

        x_hi, x_lo, r = _map_col_blocks(refine, b)
    report = _report_from(s.a_norm, torch.diagonal(s.f.lu, dim1=-2, dim2=-1), x_hi, b, r)
    return (x_hi, x_lo), report


def _lu_against_df_impl(a_hi, a_lo, b, n_refine, gmres_ir=True, f=None):
    """solve_df against the DFSystem of (a_hi + a_lo), a_hi factored here
    unless its LUFactors f are given."""
    return solve_df(df_system(a_hi, a_lo, gmres_ir, f), b, n_refine)


def lu_solve_refined_against_df(
    a_hi: torch.Tensor, a_lo: torch.Tensor, b: torch.Tensor, n_refine: int = 3,
    gmres_ir: bool = True,
) -> tuple[tuple[torch.Tensor, torch.Tensor], SolveReport]:
    """Solve (A_hi + A_lo) X = B (assemble_system_df's pair) with an f32 LU
    of A_hi and float64-residual refinement: GMRES-IR, or with
    gmres_ir=False stationary refinement, which needs ~30x fewer triangular
    solves a sweep but contracts only while cond * u < 1 (the
    partition-of-unity patches at their spacing-scale radius, cond ~2e6).
    A leading batch axis on all three solves K systems at once."""
    return _lu_against_df_impl(a_hi, a_lo, b, n_refine, gmres_ir)


def lu_resolve_refined_against_df(
    lu_piv, a_hi: torch.Tensor, a_lo: torch.Tensor, b: torch.Tensor, n_refine: int = 3,
) -> tuple[tuple[torch.Tensor, torch.Tensor], SolveReport]:
    """lu_solve_refined_against_df against precomputed factors of A_hi:
    lu_factor_hp's LUFactors or an (lu, piv) pair."""
    return _lu_against_df_impl(a_hi, a_lo, b, n_refine, f=_as_factors(lu_piv))
