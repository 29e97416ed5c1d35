"""Structured error types and the solve health check (port of
facedeform_tpu/utils/errors.py)."""

from __future__ import annotations

import math

import torch

from facedeform_tpu_torch.utils import profiling


class FaceDeformError(Exception):
    """Base class for all framework errors."""


class ShapeMismatchError(FaceDeformError):
    """Rest/deform rig point counts differ."""


class SolveFailedError(FaceDeformError):
    """RBF system solve did not converge (checked host-side from the
    SolveReport's backward error)."""


class CaptureError(FaceDeformError):
    """Capture initialization/flood-fill failure."""


# Normwise backward error ||r|| / (||A|| ||X|| + ||B||) above which a solve
# is declared failed; a healthy refined solve lands orders of magnitude
# below, a singular rig at NaN or far above (see the JAX package's note).
SOLVE_BACKWARD_RTOL = 1e-6

# Threshold for the matrix-free Krylov solves of the conditionally-PD
# kernels, which converge to the f32 Krylov noise floor.
KRYLOV_CPD_BACKWARD_RTOL = 1e-3

# Legacy rhs-relative threshold, used only for reports lacking scale_norm.
SOLVE_RESIDUAL_RTOL = 1e-3


def check_solve(report, rtol: float = SOLVE_BACKWARD_RTOL) -> None:
    """Host-side solver health check; raises SolveFailedError on blow-up.

    Checks the normwise backward error plus each RHS column's backward
    error, so one degenerate displacement axis cannot hide inside the
    Frobenius aggregate."""
    if getattr(report, "scale_norm", None) is None:
        res, rhs = (float(v) for v in profiling.to_host(torch.stack(
            [report.residual_norm, report.rhs_norm])))
        if not math.isfinite(res) or (
            rhs > 0 and res > SOLVE_RESIDUAL_RTOL * max(rhs, 1e-30)
        ):
            raise SolveFailedError(
                f"RBF solve failed: residual {res:.3e} vs rhs {rhs:.3e} "
                f"(rtol {SOLVE_RESIDUAL_RTOL:g}) — singular or "
                "ill-conditioned system"
            )
        return

    # one device->host copy for all scalars
    parts = [report.residual_norm, report.rhs_norm, report.scale_norm]
    if report.col_backward is not None:
        parts.append(report.col_backward)
    vals = profiling.to_host(torch.cat([p.reshape(-1).double() for p in parts])).tolist()
    res, rhs, scale = vals[:3]
    col_worst = max(vals[3:], default=0.0)
    backward = res / max(scale, 1e-30)
    if (
        not math.isfinite(res)
        or not math.isfinite(col_worst)
        or backward > rtol
        or col_worst > rtol
    ):
        cond_txt = ""
        if getattr(report, "cond_est", None) is not None:
            cond_txt = f", cond estimate {float(report.cond_est):.2e}"
        raise SolveFailedError(
            f"RBF solve failed: backward error {backward:.3e} "
            f"(worst column {col_worst:.3e}, rtol {rtol:g}; residual "
            f"{res:.3e}, rhs {rhs:.3e}{cond_txt}) — singular or degenerate "
            "system (duplicate/coincident markers?)"
        )


def _frame_list(idx) -> str:
    shown = ", ".join(str(i) for i in idx[:8])
    return shown + (f" (+{len(idx) - 8} more)" if len(idx) > 8 else "")


def check_frames(resid_norms, rest_ctrl, frames, cfg=None, report=None) -> None:
    """Per-frame health check of a batched sequence fit.

    parallel.batched.fit_frames returns per-frame residual norms, so on
    the dense route this is check_solve's no-scale test frame by frame:
    the saddle RHS is the displacement columns over zero tail rows, so
    ||rhs_f|| is ||frames_f - rest||_F.  Raises SolveFailedError naming
    the bad frames, so a degenerate rig never ships a NaN model stack.

    cfg (the fit's config) and report (fit_frames(..., want_report=True)'s
    per-frame SolveReport) serve the Krylov route of a conditionally PD
    kernel (ops/fit.krylov_cpd(cfg, n), Deformer.fit's predicate), which
    converges to the f32 Krylov noise floor: there a healthy frame's
    residual may exceed 1e-3 of its rhs, so each frame is judged as
    check_solve judges one such pose, on its backward error (and each
    column's) at KRYLOV_CPD_BACKWARD_RTOL.  The JAX package's check_frames
    has no such route and rejects a healthy 16k-control TPS shot.  Any
    other cfg keeps the dense test."""
    from facedeform_tpu_torch.ops.fit import krylov_cpd

    r = profiling.to_host(torch.as_tensor(resid_norms)).double().reshape(-1)
    rest = profiling.to_host(torch.as_tensor(rest_ctrl)).double()
    if cfg is not None and krylov_cpd(cfg, rest.shape[0]):
        if report is None:
            raise ValueError(
                "check_frames on the Krylov route of a conditionally PD kernel "
                "judges each frame's backward error: pass report= "
                "(fit_frames(..., want_report=True))")
        scale = profiling.to_host(torch.as_tensor(report.scale_norm)).double().reshape(-1)
        back = r / torch.clamp(scale, min=1e-30)
        col = torch.zeros_like(r)
        if report.col_backward is not None:
            col = profiling.to_host(torch.as_tensor(report.col_backward)).double()
            col = torch.amax(torch.nan_to_num(col.reshape(r.shape[0], -1), nan=math.inf), dim=1)
        rtol = KRYLOV_CPD_BACKWARD_RTOL
        bad = ~torch.isfinite(r) | ~torch.isfinite(col) | (back > rtol) | (col > rtol)
        if bool(bad.any()):
            idx = torch.nonzero(bad).reshape(-1).tolist()
            worst = idx[int(torch.argmax(torch.nan_to_num(back[idx], nan=math.inf)))]
            raise SolveFailedError(
                f"sequence RBF solve failed on frame(s) {_frame_list(idx)}: frame "
                f"{worst} backward error {float(back[worst]):.3e} (worst column "
                f"{float(col[worst]):.3e}, rtol {rtol:g}; residual {float(r[worst]):.3e}) "
                "— singular or degenerate system (duplicate/coincident markers?)"
            )
        return
    rhs = torch.linalg.norm(
        profiling.to_host(torch.as_tensor(frames)).double() - rest[None], dim=(1, 2))
    bad = ~torch.isfinite(r) | (
        (rhs > 0) & (r > SOLVE_RESIDUAL_RTOL * torch.clamp(rhs, min=1e-30)))
    if bool(bad.any()):
        idx = torch.nonzero(bad).reshape(-1).tolist()
        finite = torch.where(torch.isfinite(r[idx]), r[idx], torch.full_like(r[idx], math.inf))
        worst = idx[int(torch.argmax(finite))]
        raise SolveFailedError(
            f"sequence RBF solve failed on frame(s) {_frame_list(idx)}: "
            f"frame {worst} residual {float(r[worst]):.3e} vs rhs "
            f"{float(rhs[worst]):.3e} (rtol {SOLVE_RESIDUAL_RTOL:g}) — singular "
            "or ill-conditioned system"
        )


def frames_solve_ok(report, rtol: float = SOLVE_BACKWARD_RTOL):
    """Per-frame health mask (F,) numpy bool for a report whose fields
    carry a leading frame axis (ops.dbse.weights_lstsq_batched).  Unlike
    check_solve it does not raise: a shot skips the morph pass only on the
    frames whose weight solve failed (the reference's terminationtype
    contract, src/SOP_FaceDeform.cpp:363-368, applied per cook).  One
    device-to-host copy for the whole stack."""
    import numpy as np

    f = int(report.residual_norm.shape[0])
    if getattr(report, "scale_norm", None) is None:
        # check_solve's legacy branch: a zero-RHS frame passes on any
        # finite residual
        vals = profiling.to_host(torch.cat([report.residual_norm.reshape(-1),
                                            report.rhs_norm.reshape(-1)]).float()).numpy()
        res, rhs = vals[:f], vals[f:]
        return np.isfinite(res) & ~(
            (rhs > 0) & (res > SOLVE_RESIDUAL_RTOL * np.maximum(rhs, 1e-30))
        )
    col = report.col_backward
    k = 0 if col is None else int(col.shape[-1])
    parts = [report.residual_norm.reshape(-1), report.scale_norm.reshape(-1)]
    if k:
        parts.append(col.reshape(-1))
    vals = profiling.to_host(torch.cat([p.float() for p in parts])).numpy()
    res, scale = vals[:f], vals[f:2 * f]
    backward = res / np.maximum(scale, 1e-30)
    ok = np.isfinite(res) & (backward <= rtol)
    if k:
        colv = vals[2 * f:].reshape(f, k)
        with np.errstate(invalid="ignore"):
            ok &= np.isfinite(colv).all(axis=1) & (colv.max(axis=1) <= rtol)
    return ok
