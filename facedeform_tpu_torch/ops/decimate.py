"""Rig decimation: greedy pivoted-Cholesky marker selection + error report
(port of facedeform_tpu/ops/decimate.py).

Dense tracked/scan rigs are over-sampled: thousands of markers carry the
deformation a few hundred would.  Dropping markers cuts the fit and every
per-frame eval.

Selection = greedy pivoted Cholesky on the (ridge-regularized) kernel Gram
matrix: each step picks the marker whose basis function the already
selected ones approximate worst (the residual diagonal of the Schur
complement), farthest-point sampling in the RKHS metric; the residual
trace bounds the kernel mass the dropped markers still carry (lazy /
pivoted-Cholesky <-> FPS equivalence: arXiv 2601.03706).  The reference
has no counterpart (ALGLIB consumes whatever rig it is given,
src/SOP_FaceDeform.cpp:268-287).

On the device: k steps, each an argmax, one gaussian kernel column and
one (N, i) x (i,) matvec against the columns chosen so far: O(N k^2)
work in all and no (N, N) matrix.  The argmax stays on the device (no
host sync a step: at 2000 steps a sync each would cost more than the
arithmetic); the picks come to the host once at the end.  Selection
always uses a gaussian surrogate (strictly PD, so the diagonal stays
nonnegative); the error report of reduce_rig measures the real fit.

`reduce_rig` refits on the selected subset and reports the displacement
error at the dropped markers; `fit_reduced(_frames)` keeps every marker as
an observation of a ridge regression over the K selected centers (the
Nystrom form), and returns a stock RBFModel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from facedeform_tpu_torch.utils.precision import highest_precision


class SelectReport(NamedTuple):
    """Diagnostics of a marker selection."""

    residual_trace: float     # sum of the remaining Schur diagonal (>= 0)
    residual_max: float       # worst single dropped-marker residual
    eps: float                # gaussian surrogate radius used


class ReduceReport(NamedTuple):
    """Measured cost of fitting on the reduced rig."""

    max_err: float            # max |field(dropped) - target| over dropped
    rms_err: float            # rms of the same
    motion_scale: float       # max |deformed - rest| for context
    select: SelectReport

    @property
    def relative_max_err(self) -> float:
        return self.max_err / max(self.motion_scale, 1e-30)


def select_markers(
    rest_ctrl,
    k: int,
    eps: Optional[float] = None,
    lam: float = 1e-6,
    device="cuda",
) -> tuple[np.ndarray, SelectReport]:
    """Pick the k most informative markers of a rest rig on `device`.

    Returns (idx (k,) int32 in selection order, SelectReport).  `eps`
    defaults to 2x the rig's median nearest-neighbor spacing (the PU auto
    rule, ops/pu.py); `lam` is a jitter ridge keeping the f32 recursion
    stable (it biases scores by +lam only).
    """
    x = np.ascontiguousarray(np.asarray(rest_ctrl, np.float32))
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"rest_ctrl must be (N, 3), got {x.shape}")
    n = x.shape[0]
    k = int(k)
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, {n}]")
    if eps is None:
        from facedeform_tpu_torch.ops.pu import _median_nn

        eps = 2.0 * _median_nn(x)
    eps = float(max(eps, 1e-9))

    xt = torch.as_tensor(x, device=device)
    inv_e2 = float(np.float32(1.0 / (eps * eps)))
    d = torch.full((n,), 1.0 + lam, dtype=torch.float32, device=device)
    # the chosen columns as rows: row i is column i of the N x k factor
    low = torch.zeros((k, n), dtype=torch.float32, device=device)
    idx = torch.zeros(k, dtype=torch.int64, device=device)
    ar = torch.arange(n, device=device)
    with highest_precision():
        for i in range(k):
            # index_select with a (1,) index tensor: indexing by a 0-d
            # tensor could read it back to the host
            p = torch.argmax(d).reshape(1)
            piv = torch.clamp(d.index_select(0, p), min=1e-30)
            # the gaussian column phi(|x - x_p|), never an (N, N) matrix
            diff = xt - xt.index_select(0, p)
            col = torch.exp(-torch.sum(diff * diff, dim=1) * inv_e2)
            col = col + lam * (ar == p)
            # subtract the span of the previous columns; full f32 (no TF32):
            # a rounding error here compounds over the k sequential steps
            # and reorders the pivots
            c = (col - low[:i].T @ low[:i].index_select(1, p)[:, 0]) * torch.rsqrt(piv)
            low[i] = c
            d = torch.clamp(d - c * c, min=0.0).index_fill(0, p, -1.0)  # never re-pick
            idx[i:i + 1] = p
    resid = torch.clamp(d, min=0.0)
    trace, rmax = torch.stack([torch.sum(resid), torch.max(resid)]).tolist()
    rep = SelectReport(residual_trace=trace, residual_max=rmax, eps=eps)
    return idx.cpu().numpy().astype(np.int32), rep


def reduce_rig(
    rest_ctrl,
    deformed_ctrl,
    k: int,
    cfg=None,
    params=None,
    eps: Optional[float] = None,
    device="cuda",
) -> tuple[np.ndarray, ReduceReport]:
    """Select k markers and measure what dropping the rest costs: fit the
    model family (cfg/params, defaults DeformConfig()/DeformParams()) on
    the selected subset and evaluate the field at the dropped markers
    against their deformed positions.  Selection reads only the rest rig,
    so one index set serves a whole tracked shot."""
    from facedeform_tpu_torch.config import DeformConfig, DeformParams
    from facedeform_tpu_torch.deformer import Deformer

    cfg = cfg if cfg is not None else DeformConfig()
    params = params if params is not None else DeformParams()
    rest = np.ascontiguousarray(np.asarray(rest_ctrl, np.float32))
    deformed = np.ascontiguousarray(np.asarray(deformed_ctrl, np.float32))
    if rest.shape != deformed.shape:
        raise ValueError(f"rig shapes differ: {rest.shape} vs {deformed.shape}")
    idx, sel = select_markers(rest, k, eps=eps, device=device)
    motion = float(np.abs(deformed - rest).max())

    if len(idx) == rest.shape[0]:
        return idx, ReduceReport(0.0, 0.0, motion, sel)

    keep = np.zeros(rest.shape[0], bool)
    keep[idx] = True
    if getattr(cfg, "solver", None) == "pu":
        # Deformer refuses the PU route; the interpolation error at the
        # dropped markers is a property of the kernel family, so measure
        # it with the auto-routed dense/Krylov solver of the same family
        import dataclasses

        cfg = dataclasses.replace(cfg, solver="auto")
    d = Deformer.fit(rest[keep], deformed[keep], cfg, params, device=device)
    pred, _ = d.apply(rest[~keep])
    enorm = torch.linalg.norm(
        pred - torch.as_tensor(deformed[~keep], device=pred.device), dim=1)
    max_err, rms = torch.stack([enorm.max(), torch.sqrt(torch.mean(enorm ** 2))]).tolist()
    return idx, ReduceReport(max_err=max_err, rms_err=rms, motion_scale=motion, select=sel)


class ReducedFitInfo(NamedTuple):
    """Regression-quality diagnostics of a reduced-basis fit (apart from
    the SolveReport, which measures the normal equations' solve: a noisy
    rig has a large regression residual while the solve is healthy)."""

    idx: np.ndarray           # (k,) selected centers
    fit_rms: float            # rms |field(marker) - target| over ALL N
    fit_max: float            # max of the same
    motion_scale: float


def _resolve_centers(rest, k, idx, eps_select, device):
    """Select (or validate caller-supplied) centers."""
    if idx is None:
        idx, _sel = select_markers(rest, k, eps=eps_select, device=device)
    else:
        idx = np.asarray(idx, np.int32)
        n = rest.shape[0]
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            # -1 and n-1 pass a uniqueness check as distinct values but
            # index the same marker: duplicate centers in disguise
            raise ValueError(
                f"idx out of range: values must be in [0, {n}), got "
                f"[{idx.min()}, {idx.max()}]"
            )
        if len(np.unique(idx)) != len(idx):
            raise ValueError("idx has duplicate centers")
    return idx


def _check_single_layer(cfg):
    """fit_reduced's family contract; raised before any selection work."""
    from facedeform_tpu_torch.config import RBFModelType

    if cfg.model == RBFModelType.MULTILAYER:
        raise ValueError(
            "fit_reduced is single-layer (KERNEL/QNN): MULTILAYER's "
            "residual layers are interpolation machinery — use "
            "reduce_rig (subset mode) for that family"
        )


def _reduced_design(cfg, params, rest, idx, device):
    """The (N, K+m) reduced design matrix over K selected centers on
    `device`: (centers (K, 3), a, eps_c, lam, m).  Radii follow the model
    family on the centers; the regression is overdetermined (N >= K), so a
    tiny ridge only conditions QNN's lam = 0."""
    from facedeform_tpu_torch.ops import fit as fit_mod
    from facedeform_tpu_torch.ops.assemble import poly_basis
    from facedeform_tpu_torch.ops.kernels import apply_kernel, pairwise_sqdist

    _check_single_layer(cfg)
    x = torch.as_tensor(rest, device=device)
    centers = x[torch.tensor(idx, dtype=torch.int64, device=device)]
    kernel = fit_mod.effective_kernel(cfg)
    # confidence is an observation weight here, not a ridge
    eps_c, lam0 = fit_mod._family_radii(cfg, params, centers, None)
    lam = torch.clamp(torch.max(torch.as_tensor(lam0)), min=1e-6)
    a_rbf = apply_kernel(kernel, pairwise_sqdist(x, centers), eps_c)
    p_n = poly_basis(x, cfg.term)
    a = torch.cat([a_rbf, p_n], dim=1)                    # (N, K+m)
    return centers, a, eps_c, lam, int(p_n.shape[1])


def _confidence_weights(confidence, n, device):
    """(N, 1) sqrt-confidence observation weights, or None."""
    if confidence is None:
        return None
    from facedeform_tpu_torch.ops.fit import confidence_clipped

    return torch.sqrt(confidence_clipped(confidence, n, device))[:, None]


def _ridge_normal_solve(a_w, b_w, ridge, constraint=None):
    """Solve (A'A + diag(ridge)) Z = A'B, optionally under C Z = 0 (a KKT
    block system).  Returns (z, sys, rhs_sys, resid) in float32, z the
    primal (K+m) block.  Zero-ridge columns (the tail) get 1e-6 of their
    own Gram diagonal, so a coplanar rig's dependent tail columns still
    solve; the constraint block carries the dense solver's -1e-8
    quasi-definite shift.

    The system is assembled and solved in float64.  Its condition is the
    design's squared: assembled in float32 (the JAX package's algorithm),
    the fitted field of a 50-center TPS rig over 300 markers sits up to
    3e-3 of the motion scale from the exact regression's; in float64 it
    sits ~1e-6 from it, the rounding of the float32 weights."""
    a64, b64 = a_w.double(), b_w.double()
    gram = a64.T @ a64
    rhs = a64.T @ b64
    ridge = torch.where(ridge > 0, ridge.double(), 1e-6 * torch.diagonal(gram))
    gram = gram + torch.diag(ridge)
    if constraint is not None:
        mc = constraint.shape[0]
        eye = torch.eye(mc, dtype=gram.dtype, device=gram.device)
        sys = torch.cat([torch.cat([gram, constraint.double().T], dim=1),
                         torch.cat([constraint.double(), -1e-8 * eye], dim=1)], dim=0)
        rhs_sys = torch.cat([rhs, rhs.new_zeros((mc, rhs.shape[1]))])
    else:
        sys, rhs_sys = gram, rhs
    z_full = torch.linalg.solve(sys, rhs_sys)
    resid = rhs_sys - sys @ z_full
    return z_full[: gram.shape[0]].float(), sys.float(), rhs_sys.float(), resid.float()


def _tail_constraint(cfg, centers, m: int):
    """(m, K+m) KKT constraint [P_K^T | 0] enforcing P_K^T w = 0, or None.

    The eval paths center phi for growing kernels assuming sum_j w_j = 0
    (ops/evaluate._center_phi); an unconstrained ridge regression breaks
    it and the field picks up a mean(phi) * sum(w) bias, so the full CPD
    side condition is imposed.  Strictly PD kernels stay unconstrained."""
    from facedeform_tpu_torch.ops import fit as fit_mod
    from facedeform_tpu_torch.ops.assemble import poly_basis
    from facedeform_tpu_torch.ops.evaluate import _center_phi

    if m == 0 or not _center_phi(fit_mod.effective_kernel(cfg), cfg.term):
        return None
    p_k = poly_basis(centers, cfg.term)                   # (K, m)
    return torch.cat([p_k.T, p_k.new_zeros((m, m))], dim=1)


def _ridge(kk: int, m: int, lam: torch.Tensor) -> torch.Tensor:
    return torch.cat([lam.expand(kk).float(), lam.new_zeros(m, dtype=torch.float32)])


def fit_reduced(
    rest_ctrl,
    deformed_ctrl,
    k: int,
    cfg=None,
    params=None,
    confidence=None,
    eps_select: Optional[float] = None,
    idx=None,
    device="cuda",
):
    """Reduced-basis regression fit on `device`: all N markers constrain K
    centers through the ridge least squares

        min_w,c  sum_i c_i |Phi_ik w + P_i c - delta_i|^2 + lam |w|^2

    (the Nystrom / inducing-point form): on a noisy tracker rig it
    averages ~N/K observations a degree of freedom instead of
    interpolating noise.  The result is a stock RBFModel (ctrl = the K
    centers), so every eval path takes it unchanged; wrap it in
    Deformer(..., reduced=True).  `confidence` ((N,) in (0, 1]) weights
    the rows by sqrt(c_i).  Single-layer families only (KERNEL, QNN
    radii).  Returns (model, report, info).
    """
    from facedeform_tpu_torch.config import DeformConfig, DeformParams
    from facedeform_tpu_torch.ops.fit import RBFModel
    from facedeform_tpu_torch.ops.solve import SolveReport

    cfg = cfg if cfg is not None else DeformConfig()
    params = (params if params is not None else DeformParams()).clamped()
    _check_single_layer(cfg)
    rest = np.ascontiguousarray(np.asarray(rest_ctrl, np.float32))
    deformed = np.ascontiguousarray(np.asarray(deformed_ctrl, np.float32))
    if rest.shape != deformed.shape:
        raise ValueError(f"rig shapes differ: {rest.shape} vs {deformed.shape}")
    n = rest.shape[0]
    idx = _resolve_centers(rest, k, idx, eps_select, device)
    kk = len(idx)
    centers, a, eps_c, lam, m = _reduced_design(cfg, params, rest, idx, device)

    delta = torch.as_tensor(deformed - rest, device=device)
    sw = _confidence_weights(confidence, n, device)
    a_w, delta_w = (a, delta) if sw is None else (a * sw, delta * sw)
    z, gram, rhs, resid = _ridge_normal_solve(
        a_w, delta_w, _ridge(kk, m, lam), constraint=_tail_constraint(cfg, centers, m))

    # solver health: the backward error of the normal system (the
    # regression misfit below is data, not a solve failure)
    report = SolveReport(
        residual_norm=torch.linalg.norm(resid),
        rhs_norm=torch.linalg.norm(rhs),
        scale_norm=torch.linalg.norm(gram) * torch.linalg.norm(z) + torch.linalg.norm(rhs),
    )
    model = RBFModel(
        ctrl=centers,
        w_rbf=z[:kk][None],                               # (1, K, 3)
        w_poly=z[kk:],
        eps=torch.broadcast_to(torch.as_tensor(eps_c, dtype=torch.float32), (kk,))[None],
    )
    with highest_precision():
        pred = a @ z                                      # unweighted: the field at the markers
    err = torch.linalg.norm(pred - delta, dim=1)
    rms, emax, scale = torch.stack([
        torch.sqrt(torch.mean(err ** 2)), torch.max(err), torch.max(torch.abs(delta))]).tolist()
    info = ReducedFitInfo(idx=np.asarray(idx), fit_rms=rms, fit_max=emax, motion_scale=scale)
    return model, report, info


class ReducedSeqFitInfo(NamedTuple):
    """Per-frame regression diagnostics of a reduced-basis shot fit."""

    idx: np.ndarray           # (k,) selected centers
    fit_rms: np.ndarray       # (F,) rms |field(marker) - target| over ALL N
    fit_max: np.ndarray       # (F,) max of the same
    motion_scale: float
    resid_norms: np.ndarray   # (F,) normal-system residual per frame


def fit_reduced_frames(
    rest_ctrl,
    deformed_frames,
    k: int,
    cfg=None,
    params=None,
    confidence=None,
    eps_select: Optional[float] = None,
    idx=None,
    device="cuda",
):
    """Reduced-basis regression over a whole shot with one factorization:
    the design matrix depends only on the rest rig and the centers, so an
    F-frame shot is 3F right-hand-side columns of the same normal system.
    Inputs (N, 3) rest and (F, N, 3) frames; `confidence` (N,) weights
    every frame alike.

    Returns (model, report, info): a frames-stacked RBFModel (ctrl (K, 3),
    w_rbf (F, 1, K, 3), w_poly (F, m, 3), eps (1, K)) that
    parallel.batched.apply_frames takes unchanged; one SolveReport over
    all 3F columns whose col_backward exposes a single bad frame to
    errors.check_solve; per-frame regression misfits in info.
    """
    from facedeform_tpu_torch.config import DeformConfig, DeformParams
    from facedeform_tpu_torch.ops.fit import RBFModel
    from facedeform_tpu_torch.ops.solve import SolveReport

    cfg = cfg if cfg is not None else DeformConfig()
    params = (params if params is not None else DeformParams()).clamped()
    _check_single_layer(cfg)
    rest = np.ascontiguousarray(np.asarray(rest_ctrl, np.float32))
    frames = np.ascontiguousarray(np.asarray(deformed_frames, np.float32))
    if frames.ndim != 3 or frames.shape[1:] != rest.shape:
        raise ValueError(
            f"deformed_frames must be (F, N, 3) matching rest "
            f"{rest.shape}, got {frames.shape}"
        )
    n, f = rest.shape[0], frames.shape[0]
    idx = _resolve_centers(rest, k, idx, eps_select, device)
    kk = len(idx)
    centers, a, eps_c, lam, m = _reduced_design(cfg, params, rest, idx, device)

    delta = torch.as_tensor(frames, device=device) - torch.as_tensor(rest, device=device)[None]
    # frames as right-hand-side columns (N, 3F), frame-major [f0 xyz, f1 xyz, ...]
    delta_cols = delta.permute(1, 0, 2).reshape(n, 3 * f)
    sw = _confidence_weights(confidence, n, device)
    a_w, d_w = (a, delta_cols) if sw is None else (a * sw, delta_cols * sw)
    z, gram, rhs, resid = _ridge_normal_solve(
        a_w, d_w, _ridge(kk, m, lam), constraint=_tail_constraint(cfg, centers, m))

    gnorm = torch.linalg.norm(gram)
    col_back = torch.linalg.norm(resid, dim=0) / torch.clamp(
        gnorm * torch.linalg.norm(z, dim=0) + torch.linalg.norm(rhs, dim=0), min=1e-30)
    report = SolveReport(
        residual_norm=torch.linalg.norm(resid),
        rhs_norm=torch.linalg.norm(rhs),
        scale_norm=gnorm * torch.linalg.norm(z) + torch.linalg.norm(rhs),
        col_backward=col_back,
    )
    zf = z.reshape(kk + m, f, 3).permute(1, 0, 2)          # (F, K+m, 3)
    model = RBFModel(
        ctrl=centers,
        w_rbf=zf[:, None, :kk, :],                         # (F, 1, K, 3)
        w_poly=zf[:, kk:, :],                              # (F, m, 3)
        eps=torch.broadcast_to(torch.as_tensor(eps_c, dtype=torch.float32), (kk,))[None],
    )
    with highest_precision():
        pred = (a @ z).reshape(n, f, 3)
    err = torch.linalg.norm(pred.permute(1, 0, 2) - delta, dim=2)   # (F, N)
    info = ReducedSeqFitInfo(
        idx=np.asarray(idx),
        fit_rms=torch.sqrt(torch.mean(err ** 2, dim=1)).cpu().numpy(),
        fit_max=torch.amax(err, dim=1).cpu().numpy(),
        motion_scale=float(torch.max(torch.abs(delta))),
        resid_norms=torch.linalg.norm(resid.reshape(kk + m, f, 3), dim=(0, 2)).cpu().numpy(),
    )
    return model, report, info
