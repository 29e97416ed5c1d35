"""RBF model fitting, dense route (port of facedeform_tpu/ops/fit.py).

QNN: gaussian with per-point radii eps_i = q * nndist_i capped at
z * mean(nndist), exact interpolation.  MULTILAYER: coarse-to-fine
gaussian layers, radius halving per layer, each fitted to the residual of
the previous ones.  KERNEL: one layer of the chosen zoo kernel with a
global radius and ridge.  The polynomial tail rides the first layer only.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from facedeform_tpu_torch.config import (
    DeformConfig, DeformParams, PolyTerm, RBFKernel, RBFModelType,
)
from facedeform_tpu_torch.ops.assemble import assemble_rhs, assemble_system
from facedeform_tpu_torch.ops.kernels import nearest_neighbor_dist
from facedeform_tpu_torch.ops.solve import SolveReport, _lu_refined_impl, lu_factor_hp
from facedeform_tpu_torch.utils import errors
from facedeform_tpu_torch.utils.precision import highest_precision

# Kernels whose phi grows with distance: their fits need double-float
# assembly and their evals the precise path (both still to be ported).
GROWING_KERNELS = (
    RBFKernel.THIN_PLATE,
    RBFKernel.MULTIQUADRIC,
    RBFKernel.LINEAR,
    RBFKernel.CUBIC,
)

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


# Above this control count the JAX package's dense factorization gives way
# to matrix-free Krylov solvers.
_KRYLOV_THRESHOLD = 8192


def uses_krylov(cfg: DeformConfig, n: int) -> bool:
    """Whether (cfg, n-control rig) routes to the matrix-free Krylov solvers."""
    return cfg.solver == "krylov" or (cfg.solver == "auto" and n > _KRYLOV_THRESHOLD)


def _worst_report(reports: list) -> SolveReport:
    """The per-layer report with the worst backward error."""
    if len(reports) == 1:
        return reports[0]
    errs = torch.stack([r.backward_error() for r in reports])
    return reports[int(torch.argmax(errs))]


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
    c = torch.as_tensor(confidence, dtype=torch.float32, device=device).reshape(-1)
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
        lam0 = torch.tensor(0.0, device=dev)
    else:
        eps0 = torch.full((n,), params.radius, dtype=torch.float32, device=dev)
        lam0 = torch.tensor(params.lam, dtype=torch.float32, device=dev)
        if confidence is not None:
            lam0 = lam0 / confidence_clipped(confidence, n, dev)
    return eps0, lam0


def _lam_col(lam: torch.Tensor) -> torch.Tensor:
    """Ridge shaped to broadcast against (N, k) weight columns."""
    return lam[:, None] if lam.ndim == 1 else lam


def _check_dense_route(cfg: DeformConfig, n: int) -> RBFKernel:
    """The effective kernel, or NotImplementedError for the routes not
    ported yet: Krylov (n > 8192 or solver="krylov") and growing kernels
    (double-float assembly)."""
    kernel = effective_kernel(cfg)
    if uses_krylov(cfg, n):
        raise NotImplementedError(
            f"the matrix-free Krylov route ({n} controls, solver="
            f"{cfg.solver!r}) is not ported yet (ROADMAP queue 1, slice F: "
            "ops/krylov.py)"
        )
    if kernel in GROWING_KERNELS:
        raise NotImplementedError(
            f"{kernel.name} fits need double-float assembly, not ported yet "
            "(ROADMAP queue 1, slice C: precision for growing kernels)"
        )
    return kernel


def fit(
    rest_ctrl: torch.Tensor,
    deformed_ctrl: torch.Tensor,
    cfg: DeformConfig,
    params: DeformParams = DeformParams(),
    confidence: Optional[torch.Tensor] = None,
) -> tuple[RBFModel, SolveReport]:
    """Fit an RBFModel mapping rest control points to their displacements.

    Runs on rest_ctrl's device.  Returns (model, report); the report is the
    layer with the worst backward error.  The Krylov route (n > 8192 or
    solver="krylov") and the growing kernels (which need double-float
    assembly) raise NotImplementedError until they are ported.
    """
    n = rest_ctrl.shape[0]
    kernel = _check_dense_route(cfg, n)
    params = params.clamped()
    rest_ctrl = rest_ctrl.float()
    delta = deformed_ctrl.float() - rest_ctrl
    eps0, lam0 = _family_radii(cfg, params, rest_ctrl, confidence)

    w_layers, w_lo_layers, eps_layers, reports = [], [], [], []
    dev = rest_ctrl.device
    w_poly = torch.zeros((cfg.n_poly, 3), device=dev)
    w_poly_lo = torch.zeros((cfg.n_poly, 3), device=dev)
    target = delta
    for layer in range(cfg.n_layers):
        eps_l = eps0 * (0.5 ** layer)
        term = cfg.term if layer == 0 else PolyTerm.ZERO
        a = assemble_system(rest_ctrl, kernel, term, eps_l, lam0)
        b = assemble_rhs(target, term)
        (x, x_lo), report, _ = _lu_refined_impl(a, b, cfg.n_refine, want_lo=True)
        w_l = x[:n]
        w_layers.append(w_l)
        w_lo_layers.append(x_lo[:n])
        eps_layers.append(eps_l)
        reports.append(report)
        if layer == 0 and cfg.n_poly > 0:
            w_poly, w_poly_lo = x[n:], x_lo[n:]
        if layer + 1 < cfg.n_layers:
            # the next (finer) layer fits what this one left: the top block
            # is Phi w + lam w + P c, so the prediction is (A x)[:n] - lam w
            with highest_precision():
                ax = a @ x
            target = target - (ax[:n] - _lam_col(lam0) * w_l)

    model = RBFModel(
        ctrl=rest_ctrl.clone(),  # never alias the caller's array
        w_rbf=torch.stack(w_layers),
        w_poly=w_poly,
        eps=torch.stack(eps_layers),
        w_rbf_lo=torch.stack(w_lo_layers),
        w_poly_lo=w_poly_lo,
    )
    return model, _worst_report(reports)


def fit_frames_per_pose(
    rest_ctrl: torch.Tensor,
    deformed_frames: torch.Tensor,
    cfg: DeformConfig,
    params: DeformParams = DeformParams(),
    confidence: Optional[torch.Tensor] = None,
) -> tuple[RBFModel, torch.Tensor]:
    """F poses of one rest rig, each solved as fit() solves it: the JAX
    package's vmapped per-frame fit, with the frame axis written out.

    The system depends on the rest rig only, so it is assembled once; each
    pose factors its own copy of it (F batched LU factorizations) and
    refines its own 3 columns.  Returns (model with w_rbf (F, L, N, 3),
    w_poly (F, m, 3) and their lo words stacked the same way, per-frame
    residual norms (F,) of each frame's worst layer)."""
    n, f = rest_ctrl.shape[0], deformed_frames.shape[0]
    kernel = _check_dense_route(cfg, n)
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
        a = assemble_system(rest_ctrl, kernel, term, eps_l, lam0)
        lu_piv = lu_factor_hp(a.expand(f, *a.shape))
        (x, x_lo), report, _ = _lu_refined_impl(
            a, assemble_rhs(target, term), cfg.n_refine, want_lo=True, lu_piv=lu_piv)
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
    errs = torch.stack([r.backward_error() for r in reports])       # (L, F)
    resid = torch.stack([r.residual_norm for r in reports])         # (L, F)
    return model, torch.gather(resid, 0, torch.argmax(errs, dim=0)[None])[0]


def fit_frames_dense(
    rest_ctrl: torch.Tensor,
    deformed_frames: torch.Tensor,
    cfg: DeformConfig,
    params: DeformParams = DeformParams(),
    confidence: Optional[torch.Tensor] = None,
) -> tuple[RBFModel, torch.Tensor, SolveReport]:
    """F-frame fit sharing ONE factorization per layer (dense route).

    The saddle system depends only on the rest rig and the layer radius,
    so every frame of a shot is 3 more right-hand-side columns: one
    assembly, one LU and one refined solve of (N + m, 3F) per layer.
    Returns (model with w_rbf (F, L, N, 3) and w_poly (F, m, 3), lo words
    dropped as in the JAX package; per-frame residual norms (F,), each
    frame's worst layer; the aggregate SolveReport of the worst layer).
    """
    n, f = rest_ctrl.shape[0], deformed_frames.shape[0]
    kernel = _check_dense_route(cfg, n)
    params = params.clamped()
    rest_ctrl = rest_ctrl.float()
    target = deformed_frames.float() - rest_ctrl[None]          # (F, N, 3)
    eps0, lam0 = _family_radii(cfg, params, rest_ctrl, confidence)

    def pack(t):      # (F, rows, 3) -> (rows, 3F)
        return t.transpose(0, 1).reshape(t.shape[1], -1)

    def unpack(x):    # (rows, 3F) -> (F, rows, 3)
        return x.reshape(x.shape[0], f, 3).transpose(0, 1)

    w_layers, eps_layers, reports, frame_resids = [], [], [], []
    w_poly = torch.zeros((f, cfg.n_poly, 3), device=rest_ctrl.device)
    for layer in range(cfg.n_layers):
        eps_l = eps0 * (0.5 ** layer)
        term = cfg.term if layer == 0 else PolyTerm.ZERO
        a = assemble_system(rest_ctrl, kernel, term, eps_l, lam0)
        b = pack(assemble_rhs(target, term))
        (x, _), report, _ = _lu_refined_impl(a, b, cfg.n_refine, want_lo=True)
        # per-frame residual norms from the per-column backward errors
        # (||r_c|| = col_backward_c * col_scale_c), as the JAX package does
        col_r = report.col_backward * (
            torch.linalg.norm(a) * torch.linalg.norm(x, dim=0) + torch.linalg.norm(b, dim=0))
        frame_resids.append(torch.sqrt(torch.sum(col_r.reshape(f, 3) ** 2, dim=1)))
        x_f = unpack(x)                                          # (F, rows, 3)
        w_l = x_f[:, :n]
        w_layers.append(w_l)
        eps_layers.append(eps_l)
        reports.append(report)
        if layer == 0 and cfg.n_poly > 0:
            w_poly = x_f[:, n:]
        if layer + 1 < cfg.n_layers:
            with highest_precision():
                ax = a @ x
            target = target - (unpack(ax)[:, :n] - _lam_col(lam0) * w_l)
    model = RBFModel(
        ctrl=rest_ctrl.clone(),
        w_rbf=torch.stack(w_layers, dim=1),
        w_poly=w_poly,
        eps=torch.stack(eps_layers),
    )
    resid = torch.amax(torch.stack(frame_resids), dim=0)
    return model, resid, _worst_report(reports)
