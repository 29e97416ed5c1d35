"""Leave-one-out cross-validation (Rippa) radius / ridge selection (port
of facedeform_tpu/ops/loocv.py).

The reference exposes raw smoothing knobs (QNN's q/z, the Multilayer
radius/lambda, src/SOP_FaceDeform.cpp:344-347) and leaves choosing them to
the user.  This module picks them by leave-one-out cross-validation with
Rippa's closed form: for the interpolation system B x = b (tail and ridge
exactly as ops/assemble.py builds it), the leave-one-out prediction error
at control i is

    e_i = -w_i / (B^{-1})_{ii}

per displacement column, with no refits.  One factorization per candidate
scores the whole LOO error: a grid of C candidates costs C dense
(N+m)-size factorizations, each candidate's inverse diagonal from two
triangular solves against its own LU.  A dense-regime tool: the same
<= 8192-control limit as the dense fit route.

Family mapping (as ops/fit.py):
  * QNN: a candidate factor f scales the whole radius field, which is
    scaling q and z together (min(fq nn, fz mean) = f min(q nn, z mean));
    lam stays 0.
  * MULTILAYER: scored on the first layer's interpolant at the candidate
    radius/ridge (a documented approximation).
  * KERNEL: single layer, global radius + ridge, the exact model.
"""

from __future__ import annotations

import numpy as np
import torch

from facedeform_tpu_torch.config import (
    DeformConfig,
    DeformParams,
    PolyTerm,
    RBFKernel,
    RBFModelType,
)
from facedeform_tpu_torch.ops.assemble import assemble_rhs, assemble_system
from facedeform_tpu_torch.ops.solve import (
    LUFactors, SolveReport, lu_solve, lu_solve_refined_factored,
)
from facedeform_tpu_torch.utils.precision import highest_precision

# Half-octave steps over +-3 octaves around the user's value: wide enough
# to recover from an off-by-8x radius, fine enough to bracket the LOO
# minimum within ~19%.
DEFAULT_RADIUS_FACTORS = tuple(float(2.0 ** e) for e in np.arange(-3.0, 3.5, 0.5))
# Ridge grid (MULTILAYER/KERNEL only); the reference clamps lambda >= 0.01
# (src/SOP_FaceDeform.cpp:253), so that is the floor.
DEFAULT_RIDGE_VALUES = (0.01, 0.0316, 0.1, 0.316, 1.0)


def loocv_errors(
    ctrl: torch.Tensor,
    delta: torch.Tensor,
    kernel: RBFKernel,
    term: PolyTerm,
    eps,
    lam,
    n_refine: int = 2,
) -> tuple[torch.Tensor, SolveReport]:
    """Closed-form (N, 3) leave-one-out prediction errors on ctrl's device.

    e[i, c] is (the interpolant without point i, evaluated at x_i) minus
    delta[i, c], for the system ops/assemble.py builds (tail rows,
    quasi-definite tail regularization and ridge included).
    """
    ctrl = ctrl.float()
    delta = delta.float().to(ctrl.device)
    n = ctrl.shape[0]
    a = assemble_system(ctrl, kernel, term, eps, lam)
    b = assemble_rhs(delta, term)
    x, report, (lu, piv) = lu_solve_refined_factored(a, b, n_refine=n_refine)
    # the inverse diagonal from the same factorization (two triangular
    # solves against the identity), not a second factorization
    with highest_precision():
        eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
        binv_diag = torch.diagonal(lu_solve(LUFactors(lu, piv), eye))[:n]
    w = x[:n]
    # a vanishing diagonal means the leave-i-out system is singular
    # (duplicate points): the sign-keeping floor gives a huge e_i, which
    # poisons this candidate's score
    tiny = torch.where(binv_diag < 0, torch.full_like(binv_diag, -1e-30),
                       torch.full_like(binv_diag, 1e-30))
    safe = torch.where(torch.abs(binv_diag) > 1e-30, binv_diag, tiny)
    return -w / safe[:, None], report


def loocv_score(ctrl, delta, kernel: RBFKernel, term: PolyTerm, eps, lam) -> torch.Tensor:
    """RMS of the LOO errors; a non-finite candidate scores +inf, so a
    blown-up factorization never wins the argmin."""
    e, _ = loocv_errors(ctrl, delta, kernel, term, eps, lam)
    s = torch.sqrt(torch.mean(e * e))
    return torch.where(torch.isfinite(s), s, torch.full_like(s, float("inf")))


def _sweep(ctrl, delta, kernel, term, eps_base, scales, lams) -> np.ndarray:
    """(C,) LOO scores, one candidate at a time (the peak memory is one
    (N+m)^2 system and its inverse whatever C), pulled to the host once."""
    scores = [loocv_score(ctrl, delta, kernel, term, eps_base * float(s), float(lam))
              for s, lam in zip(scales, lams)]
    return torch.stack(scores).cpu().numpy()


def autotune(
    rest_ctrl,
    deformed_ctrl,
    cfg: DeformConfig = DeformConfig(),
    params: DeformParams = DeformParams(),
    radius_factors=None,
    ridge_values=None,
    device="cuda",
) -> tuple[DeformParams, dict]:
    """Pick the radius (QNN: the q/z scale) and optionally the ridge by
    LOOCV on `device`; returns (updated DeformParams, diagnostics).

    radius_factors: multiplicative candidates on the current radius field
    (default: half-octave grid over +-3 octaves).  ridge_values: absolute
    lambda candidates (MULTILAYER/KERNEL only; QNN raises).  diag holds
    {"factors", "ridges", "scores" (F, R), "best_factor", "best_ridge",
    "best_score", "radius_candidates"}; its factors/ridges are the applied
    grids, clamped to the fit-time floors and deduplicated.
    """
    from facedeform_tpu_torch.ops import fit as fit_mod

    rest_ctrl = torch.as_tensor(rest_ctrl, dtype=torch.float32, device=device)
    deformed_ctrl = torch.as_tensor(deformed_ctrl, dtype=torch.float32, device=device)
    n = int(rest_ctrl.shape[0])
    if cfg.solver == "pu":
        raise ValueError(
            "LOOCV autotune applies to the global dense families; the PU "
            "route picks per-patch radii from the local point spacing "
            "(ops/pu.py eps='auto') and takes no global radius"
        )
    if fit_mod.uses_krylov(cfg, n):
        raise ValueError(
            "LOOCV autotune needs the dense factorization (closed-form "
            f"inverse diagonal); {n} controls routes to Krylov.  Tune on a "
            "subsampled rig or use solver='pu' locality instead."
        )
    cp = params.clamped()
    kernel = fit_mod.effective_kernel(cfg)
    if cfg.model == RBFModelType.QNN:
        if ridge_values is not None:
            raise ValueError(
                "QNN is exact interpolation (lam=0 structurally, "
                "ops/fit.py); ridge_values only applies to "
                "MULTILAYER/KERNEL"
            )
        eps_base = fit_mod._qnn_radii(rest_ctrl, cp.qcoef, cp.zcoef)
        lam_base = 0.0
    else:
        eps_base = torch.full((n,), float(cp.radius), dtype=torch.float32, device=device)
        lam_base = float(cp.lam)

    factors = np.asarray(
        DEFAULT_RADIUS_FACTORS if radius_factors is None else radius_factors, np.float32)
    ridges = (np.asarray([lam_base], np.float32) if ridge_values is None
              else np.asarray(ridge_values, np.float32))
    # score what fit() would run after params.clamped(): radius >= 0.01,
    # lam >= 0.01, qcoef/zcoef >= 0.1 (src/SOP_FaceDeform.cpp:249-253)
    if cfg.model != RBFModelType.QNN:
        base_r = float(cp.radius)
        factors = np.maximum(factors, 0.01 / base_r).astype(np.float32)
        ridges = np.maximum(ridges, 0.01).astype(np.float32)
    else:
        floor = max(0.1 / float(cp.qcoef), 0.1 / float(cp.zcoef))
        factors = np.maximum(factors, floor).astype(np.float32)
    # clamping can collapse grid cells onto the floor: each distinct
    # candidate pays its factorization once
    factors = np.unique(factors)
    ridges = np.unique(ridges)

    grid_f, grid_l = np.meshgrid(factors, ridges, indexing="ij")
    delta = deformed_ctrl - rest_ctrl
    scores = _sweep(rest_ctrl, delta, kernel, cfg.term, eps_base,
                    grid_f.ravel(), grid_l.ravel()).reshape(len(factors), len(ridges))

    if not np.isfinite(scores).any():
        raise ValueError(
            "every LOOCV candidate produced a non-finite score — the rig "
            "is degenerate (duplicate/collinear controls at every radius)"
        )
    fi, ri = np.unravel_index(np.nanargmin(
        np.where(np.isfinite(scores), scores, np.inf)), scores.shape)
    best_f = float(factors[fi])
    best_l = float(ridges[ri])

    if cfg.model == RBFModelType.QNN:
        new_params = params._replace(
            qcoef=float(cp.qcoef) * best_f, zcoef=float(cp.zcoef) * best_f)
    else:
        new_params = params._replace(radius=float(cp.radius) * best_f)
        if ridge_values is not None:
            new_params = new_params._replace(lam=best_l)

    diag = {
        "factors": factors,
        "ridges": ridges,
        "scores": scores,
        "best_factor": best_f,
        "best_ridge": best_l,
        "best_score": float(scores[fi, ri]),
        "radius_candidates": factors * (
            1.0 if cfg.model == RBFModelType.QNN else float(cp.radius)),
    }
    return new_params, diag


def fit_auto(
    rest_ctrl,
    deformed_ctrl,
    cfg: DeformConfig = DeformConfig(),
    params: DeformParams = DeformParams(),
    radius_factors=None,
    ridge_values=None,
    check: bool = True,
    device="cuda",
):
    """autotune + Deformer.fit in one call on `device`; returns (Deformer,
    diag).  The Deformer carries the tuned params."""
    from facedeform_tpu_torch.deformer import Deformer

    new_params, diag = autotune(
        rest_ctrl, deformed_ctrl, cfg, params,
        radius_factors=radius_factors, ridge_values=ridge_values, device=device,
    )
    return (
        Deformer.fit(rest_ctrl, deformed_ctrl, cfg, new_params, check=check, device=device),
        diag,
    )
