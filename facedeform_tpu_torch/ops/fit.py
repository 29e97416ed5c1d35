"""RBF model fitting, dense route (port of facedeform_tpu/ops/fit.py).

QNN: gaussian with per-point radii eps_i = q * nndist_i capped at
z * mean(nndist), exact interpolation.  MULTILAYER: coarse-to-fine
gaussian layers, radius halving per layer, each fitted to the residual of
the previous ones.  KERNEL: one layer of the chosen zoo kernel with a
global radius and ridge.  The polynomial tail rides the first layer only.
Growing kernels (TPS/MQ/linear/cubic, GROWING_KERNELS) assemble their
system in float64, split into f32 words (a_hi, a_lo), and refine by
GMRES-IR against it; the others refine against the f32 system.  Past
_KRYLOV_THRESHOLD controls (or with solver="krylov") the system is never
assembled: matrix-free Krylov solvers (ops/krylov.py) take the layer.

The dense route splits at the pose: prepare() assembles and factors the
per-layer systems of a rest rig, refit() solves a new pose against them in
O(n^2), through the same _resolve_layer as fit(), so a refit model equals
fit()'s bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from facedeform_tpu_torch.config import (
    DeformConfig, DeformParams, PolyTerm, RBFKernel, RBFModelType,
)
from facedeform_tpu_torch.ops.assemble import (
    assemble_rhs, assemble_system, assemble_system_df,
)
from facedeform_tpu_torch.ops import krylov
from facedeform_tpu_torch.ops.kernels import kernel_is_pd, nearest_neighbor_dist
from facedeform_tpu_torch.ops.precise_eval import GROWING_KERNELS
from facedeform_tpu_torch.ops.solve import (
    LUFactors, SolveReport, _lu_against_df_impl, _lu_refined_impl, lu_factor_hp,
)
from facedeform_tpu_torch.utils import errors, profiling
from facedeform_tpu_torch.utils.precision import highest_precision

_FIELDS = ("ctrl", "w_rbf", "w_poly", "eps", "w_rbf_lo", "w_poly_lo")


class RBFModel(nn.Module):
    """Solved deformation model.

    Buffers carry the JAX RBFModel's field names, so state_dict() is the
    carry-over format: ctrl (N, 3); w_rbf (L, N, 3); w_poly (m, 3);
    eps (L, N); optional w_rbf_lo (L, N, 3) / w_poly_lo (m, 3), the sub-f32
    bits of the dense solve's weights (None when absent).
    """

    def __init__(self, ctrl, w_rbf, w_poly, eps, w_rbf_lo=None, w_poly_lo=None):
        super().__init__()
        for name, value in zip(_FIELDS, (ctrl, w_rbf, w_poly, eps, w_rbf_lo, w_poly_lo)):
            # dense row-major buffers: the eval kernels take raw pointers
            # (LU solves return column-major results, so slices of them
            # would not be)
            self.register_buffer(name, None if value is None else value.contiguous())

    @property
    def device(self) -> torch.device:
        return self.ctrl.device


# Above this control count the dense factorization gives way to the
# matrix-free Krylov solvers (the JAX package's routing).
_KRYLOV_THRESHOLD = 8192


def uses_krylov(cfg: DeformConfig, n: int) -> bool:
    """Whether (cfg, n-control rig) routes to the matrix-free Krylov solvers."""
    return cfg.solver == "krylov" or (cfg.solver == "auto" and n > _KRYLOV_THRESHOLD)


def krylov_cpd(cfg: DeformConfig, n: int) -> bool:
    """Whether (cfg, n) routes through Krylov with a conditionally PD
    kernel (TPS/MQ/linear/cubic).  Such a fit converges to the f32 Krylov
    noise floor, not the refined-LU floor, so its health checks use
    errors.KRYLOV_CPD_BACKWARD_RTOL (QNN and MULTILAYER are gaussian)."""
    return uses_krylov(cfg, n) and not kernel_is_pd(effective_kernel(cfg))


def _worst_report(reports: list) -> SolveReport:
    """The per-layer report with the worst backward error."""
    if len(reports) == 1:
        return reports[0]
    errs = torch.stack([r.backward_error() for r in reports])
    return reports[int(profiling.to_host(torch.argmax(errs)))]


def effective_kernel(cfg: DeformConfig) -> RBFKernel:
    """QNN and Multilayer are gaussian-based; KERNEL mode picks from the zoo."""
    if cfg.model == RBFModelType.KERNEL:
        return cfg.kernel
    return RBFKernel.GAUSSIAN


def _qnn_radii(ctrl: torch.Tensor, q: float, z: float) -> torch.Tensor:
    """Per-point adaptive radii for QNN mode; shape (N,)."""
    nn_d = nearest_neighbor_dist(ctrl)
    # floor at a fraction of the cloud scale: duplicates can't give eps = 0
    scale = torch.clamp(torch.max(nn_d), min=1e-6)
    nn_d = torch.maximum(nn_d, 1e-4 * scale)
    return torch.minimum(q * nn_d, z * torch.mean(nn_d))


# Confidence below this floor is treated as "barely trusted", not zero.
CONFIDENCE_FLOOR = 1e-3


def confidence_clipped(confidence, n: int, device=None) -> torch.Tensor:
    """(N,) confidence clipped to [CONFIDENCE_FLOOR, 1]; ShapeMismatchError
    on a wrong-length vector."""
    c = profiling.to_device(confidence, device, torch.float32).reshape(-1)
    if c.shape[0] != n:
        raise errors.ShapeMismatchError(
            f"confidence has {c.shape[0]} entries for {n} markers"
        )
    return torch.clamp(c, CONFIDENCE_FLOOR, 1.0)


def _family_radii(cfg, params, rest_ctrl, confidence=None):
    """First-layer radius field (N,) and ridge (scalar or (N,)).

    QNN: adaptive radii, lam 0.  MULTILAYER / KERNEL: global radius + user
    ridge, turned into lam / c_i by a per-marker confidence (QNN rejects
    confidence: its lam is structurally 0)."""
    n = rest_ctrl.shape[0]
    dev = rest_ctrl.device
    if cfg.model == RBFModelType.QNN:
        if confidence is not None:
            raise ValueError(
                "confidence weighting needs a ridge family "
                "(MULTILAYER or KERNEL): QNN interpolates exactly "
                "(lam = 0 structurally), so per-marker confidence would "
                "have no effect"
            )
        eps0 = _qnn_radii(rest_ctrl, params.qcoef, params.zcoef)
        lam0 = profiling.to_device(0.0, dev, torch.float32)
    else:
        eps0 = torch.full((n,), params.radius, dtype=torch.float32, device=dev)
        lam0 = profiling.to_device(params.lam, dev, torch.float32)
        if confidence is not None:
            lam0 = lam0 / confidence_clipped(confidence, n, dev)
    return eps0, lam0


def _lam_col(lam: torch.Tensor) -> torch.Tensor:
    """Ridge shaped to broadcast against (N, k) weight columns."""
    return lam[:, None] if lam.ndim == 1 else lam


class LayerFactors(NamedTuple):
    """Pose-independent artifacts of one dense layer's solve: the system
    (a_lo is the float64 remainder for growing kernels, None otherwise)
    and the f32 LU factors of a_hi, with what every solve of a refit reads
    beside them (solve.LUFactors)."""

    a_hi: torch.Tensor
    a_lo: Optional[torch.Tensor]
    factors: LUFactors


class FitFactors(NamedTuple):
    """prepare()'s output: each layer's LayerFactors and the radius and
    ridge fields fit() derived from the rest rig, so refit() never
    recomputes them (QNN's adaptive radii are a function of the rest
    rig)."""

    ctrl: torch.Tensor          # (N, 3) f32 rest controls
    eps0: torch.Tensor          # (N,) first-layer radii
    lam0: torch.Tensor          # scalar or (N,) ridge
    layers: tuple               # L x LayerFactors


def _assemble_layer(rest_ctrl, kernel, term, eps_l, lam0):
    """One layer's system: the split float64 pair for growing kernels (the
    f32 rounding of phi alone breaks the budget once the conditioning
    amplifies it), the f32 system and None for decaying kernels."""
    with profiling.span("fit.assemble"):
        if kernel in GROWING_KERNELS:
            return assemble_system_df(rest_ctrl, kernel, term, eps_l, lam0)
        return assemble_system(rest_ctrl, kernel, term, eps_l, lam0), None


def _factor_layer(a_hi, a_lo) -> LayerFactors:
    return LayerFactors(a_hi, a_lo, lu_factor_hp(a_hi))


def _resolve_layer(lay: LayerFactors, b: torch.Tensor, n_refine: int):
    """Refined solve of b (R, k) against a layer's factors: GMRES-IR
    against a_hi + a_lo (at least 3 sweeps) for growing kernels, float64-
    residual refinement otherwise.  Returns ((x, x_lo), report).  A span,
    fit.refine."""
    with profiling.span("fit.refine"):
        if lay.a_lo is not None:
            return _lu_against_df_impl(lay.a_hi, lay.a_lo, b, max(n_refine, 3),
                                       f=lay.factors)
        (x, x_lo), report, _ = _lu_refined_impl(lay.a_hi, b, n_refine, want_lo=True,
                                                f=lay.factors)
        return (x, x_lo), report


def _dense_layer_solve(rest_ctrl, kernel, term, eps_l, lam0, b, n_refine):
    """Assemble, factor and solve one dense layer: (a_hi, (x, x_lo),
    report); a_hi chains the next layer's residual target."""
    a, a_lo = _assemble_layer(rest_ctrl, kernel, term, eps_l, lam0)
    return (a, *_resolve_layer(_factor_layer(a, a_lo), b, n_refine))


def _resolved(lay: LayerFactors, b: torch.Tensor, n_refine: int):
    """_solve_layers' step on the dense route: (x, x_lo, report, A @)."""
    (x, x_lo), report = _resolve_layer(lay, b, n_refine)

    def apply_sys(v):
        with highest_precision():
            return lay.a_hi @ v

    return x, x_lo, report, apply_sys


def _krylov_layer(cfg, rest_ctrl, kernel, term, eps_l, lam0, b):
    """One layer on the matrix-free route (the JAX package's routing):
    GMRES for QNN (per-point radii: non-symmetric), PMINRES for the
    symmetric families, preconditioned by block-Jacobi for PD kernels and
    by the |.|-block-Jacobi of Z-ordered blocks for CPD kernels (their
    diagonal blocks are indefinite).  n_refine - 1 further sweeps
    warm-start from the last x.  Krylov models carry no lo words."""
    apply_sys = krylov.make_saddle_matvec(rest_ctrl, kernel, term, eps_l, lam0)
    if cfg.model == RBFModelType.QNN:
        msolve = krylov.make_block_jacobi(rest_ctrl, kernel, term, eps_l, lam0)

        def solve(x0):
            return krylov.gmres(apply_sys, b, msolve=msolve, x0=x0)
    else:
        make = (krylov.make_block_jacobi if kernel_is_pd(kernel)
                else krylov.make_abs_block_jacobi)
        msolve = make(rest_ctrl, kernel, term, eps_l, lam0)

        def solve(x0):
            return krylov.pminres(apply_sys, b, msolve, x0=x0)
    x, report = solve(None)
    for _ in range(max(cfg.n_refine - 1, 0)):
        x, report = solve(x)
    return x, None, report, apply_sys


def _solve_layers(rest_ctrl, delta, cfg, eps0, lam0, layer_solve):
    """The coarse-to-fine layer loop of fit() (both routes) and refit():
    layer_solve(layer, eps_l, term, b) -> (x, x_lo or None, report,
    apply_sys).  The polynomial tail rides the first layer; each finer
    layer fits what the coarser ones left.  Returns (model, the report of
    the layer with the worst backward error)."""
    n = rest_ctrl.shape[0]
    dev = rest_ctrl.device
    w_layers, w_lo_layers, eps_layers, reports = [], [], [], []
    w_poly = torch.zeros((cfg.n_poly, 3), device=dev)
    w_poly_lo = torch.zeros((cfg.n_poly, 3), device=dev)
    target = delta
    for layer in range(cfg.n_layers):
        eps_l = eps0 * (0.5 ** layer)
        term = cfg.term if layer == 0 else PolyTerm.ZERO
        b = assemble_rhs(target, term)
        x, x_lo, report, apply_sys = layer_solve(layer, eps_l, term, b)
        w_l = x[:n]
        w_layers.append(w_l)
        eps_layers.append(eps_l)
        reports.append(report)
        if x_lo is not None:
            w_lo_layers.append(x_lo[:n])
        if layer == 0 and cfg.n_poly > 0:
            w_poly = x[n:]
            if x_lo is not None:
                w_poly_lo = x_lo[n:]
        if layer + 1 < cfg.n_layers:
            # the top block is Phi w + lam w + P c, so this layer's
            # prediction at the controls is (A x)[:n] - lam w
            target = target - (apply_sys(x)[:n] - _lam_col(lam0) * w_l)
    has_lo = bool(w_lo_layers)
    model = RBFModel(
        ctrl=rest_ctrl.clone(),  # never alias the caller's array
        w_rbf=torch.stack(w_layers),
        w_poly=w_poly,
        eps=torch.stack(eps_layers),
        w_rbf_lo=torch.stack(w_lo_layers) if has_lo else None,
        w_poly_lo=w_poly_lo if has_lo else None,
    )
    return model, _worst_report(reports)


def _fit_impl(rest_ctrl, deformed_ctrl, cfg, params, confidence, want_factors):
    n = rest_ctrl.shape[0]
    kernel = effective_kernel(cfg)
    params = params.clamped()
    rest_ctrl = rest_ctrl.float()
    delta = deformed_ctrl.float() - rest_ctrl
    eps0, lam0 = _family_radii(cfg, params, rest_ctrl, confidence)
    layers = []
    if uses_krylov(cfg, n):
        def layer_solve(layer, eps_l, term, b):
            return _krylov_layer(cfg, rest_ctrl, kernel, term, eps_l, lam0, b)
    else:
        def layer_solve(layer, eps_l, term, b):
            layers.append(_factor_layer(*_assemble_layer(rest_ctrl, kernel, term, eps_l, lam0)))
            return _resolved(layers[-1], b, cfg.n_refine)
    model, report = _solve_layers(rest_ctrl, delta, cfg, eps0, lam0, layer_solve)
    factors = None
    if want_factors:
        factors = FitFactors(ctrl=rest_ctrl.clone(), eps0=eps0, lam0=lam0, layers=tuple(layers))
    return model, report, factors


def fit(
    rest_ctrl: torch.Tensor,
    deformed_ctrl: torch.Tensor,
    cfg: DeformConfig,
    params: DeformParams = DeformParams(),
    confidence: Optional[torch.Tensor] = None,
) -> tuple[RBFModel, SolveReport]:
    """Fit an RBFModel mapping rest control points to their displacements.

    Runs on rest_ctrl's device.  Returns (model, report); the report is the
    layer with the worst backward error.  Dense route: growing kernels
    (TPS/MQ/linear/cubic) assemble in float64 and refine by GMRES-IR
    against it, the others refine an f32 LU with float64 residuals.  Past
    _KRYLOV_THRESHOLD controls or with solver="krylov": matrix-free GMRES
    (QNN) or PMINRES (MULTILAYER/KERNEL), no lo words.
    """
    model, report, _ = _fit_impl(rest_ctrl, deformed_ctrl, cfg, params, confidence,
                                 want_factors=False)
    return model, report


def _dense_only(api: str, cfg: DeformConfig, n: int) -> None:
    if uses_krylov(cfg, n):
        raise ValueError(
            f"{api} is a dense-route API: the Krylov path is matrix-free "
            "(no factorization to reuse) - gate on fit.uses_krylov"
        )


def fit_with_factors(
    rest_ctrl: torch.Tensor,
    deformed_ctrl: torch.Tensor,
    cfg: DeformConfig,
    params: DeformParams = DeformParams(),
    confidence: Optional[torch.Tensor] = None,
) -> tuple[RBFModel, SolveReport, FitFactors]:
    """fit() that also returns the pose-independent FitFactors, so an
    interactive caller pays the O(n^3) factorizations once per rest rig
    and re-solves marker drags through refit() at O(n^2).  Dense route
    only: ValueError on the Krylov route."""
    _dense_only("fit_with_factors", cfg, rest_ctrl.shape[0])
    return _fit_impl(rest_ctrl, deformed_ctrl, cfg, params, confidence, want_factors=True)


def prepare(
    rest_ctrl: torch.Tensor,
    cfg: DeformConfig,
    params: DeformParams = DeformParams(),
    confidence: Optional[torch.Tensor] = None,
) -> FitFactors:
    """Assemble and LU-factor the per-layer systems of a rest rig, without
    a pose: the system depends on the rest rig and the solve params only,
    the deformed rig enters through the right-hand side.  An interactive
    session (the same rest rig, a new pose every cook) pays the O(n^3)
    factorization once and O(n^2) triangular solves and refinement per
    drag.  Dense route only: ValueError on the Krylov route."""
    _dense_only("prepare()", cfg, rest_ctrl.shape[0])
    params = params.clamped()
    rest_ctrl = rest_ctrl.float()
    kernel = effective_kernel(cfg)
    eps0, lam0 = _family_radii(cfg, params, rest_ctrl, confidence)
    layers = tuple(
        _factor_layer(*_assemble_layer(rest_ctrl, kernel,
                                       cfg.term if layer == 0 else PolyTerm.ZERO,
                                       eps0 * (0.5 ** layer), lam0))
        for layer in range(cfg.n_layers))
    return FitFactors(ctrl=rest_ctrl.clone(), eps0=eps0, lam0=lam0, layers=layers)


def refit(
    factors: FitFactors,
    deformed_ctrl: torch.Tensor,
    cfg: DeformConfig,
) -> tuple[RBFModel, SolveReport]:
    """Solve a new pose against prepared factors: the marker-drag path.

    The same layer loop and _resolve_layer as fit()'s dense route against
    the same factors, so the model equals fit()'s of the same pose bit for
    bit.  Takes no params: the knobs that shape the system (radius, lam,
    qcoef, zcoef, confidence) are baked into the factors."""
    rest_ctrl = factors.ctrl
    delta = deformed_ctrl.float() - rest_ctrl

    def layer_solve(layer, eps_l, term, b):
        return _resolved(factors.layers[layer], b, cfg.n_refine)

    return _solve_layers(rest_ctrl, delta, cfg, factors.eps0, factors.lam0, layer_solve)


def _pack(t: torch.Tensor) -> torch.Tensor:
    """(F, rows, 3) pose blocks -> (rows, 3F) right-hand-side columns."""
    return t.transpose(0, 1).reshape(t.shape[1], -1)


def _unpack(x: torch.Tensor, f: int) -> torch.Tensor:
    """(rows, 3F) columns -> (F, rows, 3) pose blocks."""
    return x.reshape(x.shape[0], f, 3).transpose(0, 1)


def _frames_report(report: SolveReport, a, x, b, f: int) -> SolveReport:
    """Per-pose view (fields (F,), col_backward (F, 3)) of a packed
    (rows, 3F) solve's report: each pose's residual norm from its 3
    per-column backward errors (||r_c|| = col_backward_c * col_scale_c),
    as the JAX package derives it, over that pose's ||A|| ||x_f|| +
    ||b_f||."""
    a_norm = torch.linalg.norm(a)
    col_r = report.col_backward * (
        a_norm * torch.linalg.norm(x, dim=0) + torch.linalg.norm(b, dim=0))
    b_f = torch.linalg.norm(_unpack(b, f), dim=(1, 2))
    return SolveReport(
        residual_norm=torch.sqrt(torch.sum(col_r.reshape(f, 3) ** 2, dim=1)),
        rhs_norm=b_f,
        scale_norm=a_norm * torch.linalg.norm(_unpack(x, f), dim=(1, 2)) + b_f,
        col_backward=report.col_backward.reshape(f, 3),
    )


def _frames_worst(reports: list) -> SolveReport:
    """Per frame, the layer report with the worst backward error: fields
    (F,), col_backward (F, 3); a field some layer lacks is None."""
    idx = torch.argmax(torch.stack([r.backward_error() for r in reports]), dim=0)

    def pick(vals):
        if any(v is None for v in vals):
            return None
        t = torch.stack(vals)                                   # (L, F, ...)
        i = idx.reshape((1, -1) + (1,) * (t.ndim - 2)).expand((1,) + t.shape[1:])
        return torch.gather(t, 0, i)[0]

    return SolveReport(*(pick(vals) for vals in zip(*reports)))


def _fit_frames_krylov(rest_ctrl, deformed_frames, cfg, params, confidence):
    """A Krylov-size shot: one fit() per pose.  GMRES restarts while any
    of its columns is above tol, so solving all 3F columns in lockstep
    would change every pose's iterates; a loop of single fits gives each
    frame exactly its single fit (the JAX package's vmapped while_loop
    does too)."""
    fits = [fit(rest_ctrl, pose, cfg, params, confidence) for pose in deformed_frames]
    models = [m for m, _ in fits]
    reports = [r for _, r in fits]
    model = RBFModel(
        ctrl=models[0].ctrl, w_rbf=torch.stack([m.w_rbf for m in models]),
        w_poly=torch.stack([m.w_poly for m in models]), eps=models[0].eps,
    )
    report = SolveReport(
        residual_norm=torch.stack([r.residual_norm for r in reports]),
        rhs_norm=torch.stack([r.rhs_norm for r in reports]),
        scale_norm=torch.stack([r.scale_norm for r in reports]),
        col_backward=torch.stack([r.col_backward for r in reports]),
    )
    return model, report


def fit_frames_per_pose(
    rest_ctrl: torch.Tensor,
    deformed_frames: torch.Tensor,
    cfg: DeformConfig,
    params: DeformParams = DeformParams(),
    confidence: Optional[torch.Tensor] = None,
    want_report: bool = False,
):
    """F poses of one rest rig, each solved as fit() solves it: the JAX
    package's vmapped per-frame fit, with the frame axis written out.

    Dense route: the system depends on the rest rig only, so it is
    assembled once; each pose factors its own copy of it (F batched LU
    factorizations) and refines its own 3 columns.  A growing kernel runs
    fit_frames_dense's solve (one factorization of the float64 pair,
    fit()'s GMRES-IR per pose's 3-column block, so a pose's weights are
    exactly fit()'s) and keeps the lo words that route drops.  Krylov
    route: one fit() per pose (no lo words).  Returns (model with w_rbf
    (F, L, N, 3), w_poly (F, m, 3) and their lo words stacked the same
    way, per-frame residual norms (F,) of each frame's worst layer), and
    with want_report also that layer's per-frame SolveReport (fields (F,),
    col_backward (F, 3)), which errors.check_frames reads on the Krylov
    route of a CPD kernel."""
    n, f = rest_ctrl.shape[0], deformed_frames.shape[0]
    if uses_krylov(cfg, n):
        model, report = _fit_frames_krylov(rest_ctrl, deformed_frames, cfg, params, confidence)
        out = (model, report.residual_norm)
        return out + (report,) if want_report else out
    kernel = effective_kernel(cfg)
    params = params.clamped()
    rest_ctrl = rest_ctrl.float()
    target = deformed_frames.float() - rest_ctrl[None]          # (F, N, 3)
    eps0, lam0 = _family_radii(cfg, params, rest_ctrl, confidence)
    dev = rest_ctrl.device
    w_layers, w_lo_layers, eps_layers, reports = [], [], [], []
    w_poly = torch.zeros((f, cfg.n_poly, 3), device=dev)
    w_poly_lo = torch.zeros((f, cfg.n_poly, 3), device=dev)
    for layer in range(cfg.n_layers):
        eps_l = eps0 * (0.5 ** layer)
        term = cfg.term if layer == 0 else PolyTerm.ZERO
        b = assemble_rhs(target, term)
        if kernel in GROWING_KERNELS:
            b = _pack(b)
            a, (x, x_lo), packed = _dense_layer_solve(
                rest_ctrl, kernel, term, eps_l, lam0, b, cfg.n_refine)
            report = _frames_report(packed, a, x, b, f)
            x, x_lo = _unpack(x, f), _unpack(x_lo, f)
        else:
            with profiling.span("fit.assemble"):
                a = assemble_system(rest_ctrl, kernel, term, eps_l, lam0)
            factors = lu_factor_hp(a.expand(f, *a.shape))
            with profiling.span("fit.refine"):
                (x, x_lo), report, _ = _lu_refined_impl(
                    a, b, cfg.n_refine, want_lo=True, f=factors)
        w_l = x[:, :n]
        w_layers.append(w_l)
        w_lo_layers.append(x_lo[:, :n])
        eps_layers.append(eps_l)
        reports.append(report)
        if layer == 0 and cfg.n_poly > 0:
            w_poly, w_poly_lo = x[:, n:], x_lo[:, n:]
        if layer + 1 < cfg.n_layers:
            with highest_precision():
                ax = a @ x
            target = target - (ax[:, :n] - _lam_col(lam0) * w_l)
    model = RBFModel(
        ctrl=rest_ctrl.clone(),
        w_rbf=torch.stack(w_layers, dim=1),
        w_poly=w_poly,
        eps=torch.stack(eps_layers),
        w_rbf_lo=torch.stack(w_lo_layers, dim=1),
        w_poly_lo=w_poly_lo,
    )
    # each frame reports its own worst layer, as _worst_report does per pose
    report = _frames_worst(reports)
    out = (model, report.residual_norm)
    return out + (report,) if want_report else out


def fit_frames_dense(
    rest_ctrl: torch.Tensor,
    deformed_frames: torch.Tensor,
    cfg: DeformConfig,
    params: DeformParams = DeformParams(),
    confidence: Optional[torch.Tensor] = None,
    want_report: bool = False,
):
    """F-frame fit sharing ONE factorization per layer (dense route).

    The saddle system depends only on the rest rig and the layer radius,
    so every frame of a shot is 3 more right-hand-side columns: one
    assembly, one LU and one refined solve of (N + m, 3F) per layer.
    Returns (model with w_rbf (F, L, N, 3) and w_poly (F, m, 3); per-frame
    residual norms (F,), each frame's worst layer; the aggregate
    SolveReport of the worst layer), and with want_report also the
    per-frame SolveReport of each frame's worst layer.  Decaying kernels
    drop the lo words, as the JAX package does.  Growing kernels refine in
    3-column blocks, one GMRES-IR per pose: the per-pose route's solve,
    and they keep its lo words (w_rbf_lo (F, L, N, 3), w_poly_lo (F, m,
    3)), so the two routes give equal models bit for bit.  (The JAX
    package's shared route drops them for growing kernels too.)  The
    Krylov route never comes here (fit_frames takes the per-pose fits), but
    like the JAX function this one solves any rig densely.
    """
    n, f = rest_ctrl.shape[0], deformed_frames.shape[0]
    kernel = effective_kernel(cfg)
    params = params.clamped()
    rest_ctrl = rest_ctrl.float()
    target = deformed_frames.float() - rest_ctrl[None]          # (F, N, 3)
    eps0, lam0 = _family_radii(cfg, params, rest_ctrl, confidence)

    keep_lo = kernel in GROWING_KERNELS
    w_layers, w_lo_layers, eps_layers, reports, frame_reports = [], [], [], [], []
    w_poly = torch.zeros((f, cfg.n_poly, 3), device=rest_ctrl.device)
    w_poly_lo = torch.zeros_like(w_poly)
    for layer in range(cfg.n_layers):
        eps_l = eps0 * (0.5 ** layer)
        term = cfg.term if layer == 0 else PolyTerm.ZERO
        b = _pack(assemble_rhs(target, term))
        a, (x, x_lo), report = _dense_layer_solve(
            rest_ctrl, kernel, term, eps_l, lam0, b, cfg.n_refine)
        frame_reports.append(_frames_report(report, a, x, b, f))
        x_f, x_lo_f = _unpack(x, f), _unpack(x_lo, f)            # (F, rows, 3)
        w_l = x_f[:, :n]
        w_layers.append(w_l)
        w_lo_layers.append(x_lo_f[:, :n])
        eps_layers.append(eps_l)
        reports.append(report)
        if layer == 0 and cfg.n_poly > 0:
            w_poly, w_poly_lo = x_f[:, n:], x_lo_f[:, n:]
        if layer + 1 < cfg.n_layers:
            with highest_precision():
                ax = a @ x
            target = target - (_unpack(ax, f)[:, :n] - _lam_col(lam0) * w_l)
    model = RBFModel(
        ctrl=rest_ctrl.clone(),
        w_rbf=torch.stack(w_layers, dim=1),
        w_poly=w_poly,
        eps=torch.stack(eps_layers),
        w_rbf_lo=torch.stack(w_lo_layers, dim=1) if keep_lo else None,
        w_poly_lo=w_poly_lo if keep_lo else None,
    )
    resid = torch.amax(torch.stack([r.residual_norm for r in frame_reports]), dim=0)
    out = (model, resid, _worst_report(reports))
    return out + (_frames_worst(frame_reports),) if want_report else out
