"""DBSE — Direct Blendshape Edit / morph-space projection (component F;
port of facedeform_tpu/ops/dbse.py).

The reference (dbse.cpp) builds a blendshape delta matrix B in R^{3V x S}
(dbse.cpp:18-30), Householder-QR-factorizes it (dbse.cpp:31), then derives
per-shape weights and reconstructs P = rest + sum_s B[:, s] * clamp(3 w_s)
(dbse.cpp:60-75, applied at src/SOP_FaceDeform.cpp:460-472).

Two weight paths (SURVEY.md quirk 3):

  * lstsq (default): w = argmin ||B w - d||_2 through the S x S normal
    equations on the device (one full-f32 Gram matmul, B^T d summed in
    float64, then ops.solve.cholesky_solve_refined).  Reconstruction uses
    w directly.
  * parity: the reference's actual computation, column sums of the
    delta-scaled packed Householder QR factor, w = sum_i d_i QRpacked[i, s]
    (dbse.cpp:53-55, summed in float64 as lstsq's B^T d), then the x3
    scale at reconstruction (dbse.cpp:69).  The packed factor is built on
    the host in float64 with Eigen's pivot-free HouseholderQR convention.

weights_robust runs Huber-IRLS on the same Gram solve (a fixed 4 sweeps,
as in the JAX package), so scan outliers cannot drag the shape weights.
Every matmul runs inside utils.precision.highest_precision(): the JAX
package asks for Precision.HIGHEST in each, and on Hopper cuBLAS would
otherwise take TF32 wherever a caller allowed it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from facedeform_tpu_torch.ops.solve import SolveReport, cholesky_solve_refined
from facedeform_tpu_torch.utils import profiling
from facedeform_tpu_torch.utils.precision import highest_precision


def householder_packed(b: np.ndarray) -> np.ndarray:
    """Eigen-convention HouseholderQR packed factor of b (M, S), float64
    (a copy of the JAX package's host routine).

    Matches Eigen::HouseholderQR::matrixQR() (dbse.cpp:31 + dbse.hpp:12):
    column j holds beta_j on the diagonal, R above, and the *essential*
    part of the Householder vector (implicit leading 1) below.
    """
    a = np.array(b, dtype=np.float64, copy=True)
    m, s = a.shape
    for j in range(min(m - 1, s)):
        c0 = a[j, j]
        tail = a[j + 1 :, j]
        tail_sq = float(tail @ tail)
        if tail_sq == 0.0:
            continue  # beta = c0, tau = 0, essential = 0 — nothing to do
        beta = np.sqrt(c0 * c0 + tail_sq)
        if c0 >= 0.0:
            beta = -beta
        essential = tail / (c0 - beta)
        tau = (beta - c0) / beta
        # Apply H = I - tau v v^T to the trailing columns (v = [1; essential]).
        if j + 1 < s:
            block = a[j:, j + 1 :]
            v = np.concatenate([[1.0], essential])
            block -= tau * np.outer(v, v @ block)
        a[j, j] = beta
        a[j + 1 :, j] = essential
    return a


class DBSEModel(NamedTuple):
    """Device-resident blendshape basis.

    deltas: (S, V, 3) per-shape displacement fields (B reshaped);
    packed_qr: (3V, S) Eigen-style packed factor (parity path) or a (1, S)
    zero placeholder on the lstsq path.
    """

    deltas: torch.Tensor
    packed_qr: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.deltas.device


def build_model(
    rest_points: np.ndarray,
    shapes: Sequence[np.ndarray],
    parity: bool = False,
    device="cuda",
) -> DBSEModel:
    """Assemble the blendshape delta basis (dbse.cpp:9-35) on `device`.

    The deltas are differences taken in float64 on the host and rounded
    once, as in the JAX package; the packed factor (parity) is host
    float64.  Shapes whose point count mismatches the rest mesh must be
    filtered by the caller (the node warns and skips them,
    src/SOP_FaceDeform.cpp:201-204).
    """
    rest = np.asarray(rest_points, np.float64)
    deltas = np.stack([np.asarray(s, np.float64) - rest for s in shapes])  # (S, V, 3)
    s, v, _ = deltas.shape
    if parity:
        b = deltas.reshape(s, 3 * v).T  # (3V, S), interleaved xyz like dbse.cpp:26-28
        packed = householder_packed(b).astype(np.float32)
    else:
        packed = np.zeros((1, s), np.float32)
    return DBSEModel(
        deltas=profiling.to_device(deltas.astype(np.float32), device),
        packed_qr=profiling.to_device(packed, device),
    )


def _flat(model: DBSEModel) -> torch.Tensor:
    """B^T as (S, 3V), a view of the deltas."""
    return model.deltas.reshape(model.deltas.shape[0], -1)


def _pose_deltas(model: DBSEModel, poses, rest) -> torch.Tensor:
    """(F, 3V) f32 pose deltas on the model's device from (F, V, 3) poses."""
    dev = model.device
    poses = profiling.to_device(poses, dev, torch.float32)
    rest = profiling.to_device(rest, dev, torch.float32)
    return (poses - rest).reshape(poses.shape[0], -1)


def _solve_normal(g: torch.Tensor, c: torch.Tensor, ridge: float, n_refine: int):
    """(g + ridge tr(g)/S I) w = c for Gram g (..., S, S) and rhs c
    (..., S, 1)."""
    s = g.shape[-1]
    tr = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)
    reg = ridge * tr / s + 1e-30
    eye = torch.eye(s, dtype=g.dtype, device=g.device)
    return cholesky_solve_refined(g + reg[..., None, None] * eye, c, n_refine=n_refine)


# Rows of B (3V, S) converted to float64 at a time by _project (416 MB of
# float64 at S = 52), and the rows each of its partial products sums.
_PROJECT_ROWS = 1 << 20
_PROJECT_SPLIT = 4096


def _project(d: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """d (F, 3V) @ bt.T for a basis bt (S, 3V), summed in float64 and
    rounded once to float32.

    A product of two float32 numbers is exact in float64 and the float64
    sum sits ~1e-16 (relative) from the exact one, so a frame's result does
    not depend on how many frames share the call: one product reads the
    basis once for a whole shot, and each frame still equals its
    single-pose call.  A float32 product would not: cuBLAS picks its
    summation order by shape, and over 3M terms (1M vertices) a shot's
    frame drifts ~1e-6 from its single-pose call (on the card).  The long
    sum is split into _PROJECT_SPLIT-row partial products, one batched
    product, so (F, S) outputs still spread over the whole card; each
    chunk of bt converts in its own layout (no transposing copy)."""
    f, s = d.shape[0], bt.shape[0]
    acc = torch.zeros(f, s, dtype=torch.float64, device=d.device)
    for a in range(0, bt.shape[1], _PROJECT_ROWS):
        dc, bc = d[:, a:a + _PROJECT_ROWS].double(), bt[:, a:a + _PROJECT_ROWS].double()
        r = bc.shape[1]
        k = r - r % _PROJECT_SPLIT
        if k:
            nb = k // _PROJECT_SPLIT
            acc += torch.bmm(dc[:, :k].reshape(f, nb, _PROJECT_SPLIT).transpose(0, 1),
                             bc[:, :k].reshape(s, nb, _PROJECT_SPLIT).permute(1, 2, 0)).sum(0)
        if k < r:
            acc += dc[:, k:] @ bc[:, k:].T
    return acc.float()


def _lstsq(model: DBSEModel, d: torch.Tensor, ridge: float, n_refine: int):
    """Weights (F, S) and the per-frame report for pose deltas d (F, 3V).
    The Gram is pose-independent: one matmul serves every frame, and one
    _project gives every frame's B^T d."""
    b = _flat(model)
    with highest_precision():
        g = b @ b.T                                   # (S, S)
    c = _project(d, b)                                # (F, S)
    f = d.shape[0]
    w, report = _solve_normal(g.expand(f, *g.shape), c[..., None], ridge, n_refine)
    return w[..., 0], report


def _squeeze_report(report: SolveReport) -> SolveReport:
    return SolveReport(*(None if v is None else v[0] for v in report))


def weights_lstsq(
    model: DBSEModel, current, rest, ridge: float = 1e-6, n_refine: int = 2,
) -> tuple[torch.Tensor, SolveReport]:
    """Least-squares blendshape weights (S,) for one pose (V, 3):
    w = (B^T B + ridge tr/S I)^-1 B^T d with d = current - rest."""
    d = _pose_deltas(model, torch.as_tensor(current)[None], rest)
    w, report = _lstsq(model, d, ridge, n_refine)
    return w[0], _squeeze_report(report)


def weights_lstsq_batched(
    model: DBSEModel, poses, rest, ridge: float = 1e-6,
) -> tuple[torch.Tensor, SolveReport]:
    """(F, V, 3) scanned poses -> (F, S) weights; the report's fields carry
    a leading frame axis (check with errors.frames_solve_ok semantics: per
    frame, not check_solve)."""
    return _lstsq(model, _pose_deltas(model, poses, rest), ridge, 2)


def weights_parity(model: DBSEModel, current, rest) -> torch.Tensor:
    """The reference's column-sum weights (dbse.cpp:53-55), verbatim:
    w_s = sum_i d_i * packedQR[i, s] with d the interleaved-xyz delta."""
    return weights_parity_batched(model, torch.as_tensor(current)[None], rest)[0]


def weights_parity_batched(model: DBSEModel, poses, rest) -> torch.Tensor:
    """(F, V, 3) poses -> (F, S) reference-recipe weights (dbse.cpp:53-55)."""
    return _project(_pose_deltas(model, poses, rest), model.packed_qr.T)


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median of a 1-D tensor, the mean of the two middle values for an
    even count (jnp.median's; torch.median returns the lower one)."""
    s = torch.sort(x).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return 0.5 * (s[n // 2 - 1] + s[n // 2])


def huber_scale(r: torch.Tensor) -> torch.Tensor:
    """Huber threshold delta from nonnegative residual norms r (V,).

    delta = 1.345 * sigma_hat with sigma_hat the MAD scale estimate
    (1.4826 * median |r - median r|).  When the MAD collapses (over half
    the vertices fit exactly) the floor 1e-3 * mean(r) keeps delta > 0; a
    uniform rescale of u cancels between Gram and right-hand side, so the
    floor can only push the iteration toward plain least squares.
    """
    med = _median(r)
    sigma = 1.4826 * _median(torch.abs(r - med))
    return torch.maximum(1.345 * sigma, 1e-3 * torch.mean(r))


def huber_vertex_weights(r: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """IRLS per-vertex weights u_v = psi(r)/r for the Huber loss:
    1 inside the threshold, delta/r beyond it (r = 0 maps to 1)."""
    return torch.where(r <= delta, torch.ones_like(r), delta / torch.clamp(r, min=1e-20))


def _robust(model: DBSEModel, d: torch.Tensor, ridge: float, n_iter: int, n_refine: int):
    """Huber-IRLS weights (S,) and report for one pose delta d (3V,)."""
    b = _flat(model)                                  # (S, 3V)
    s = b.shape[0]
    d3 = d.reshape(-1, 3)

    def solve(u):
        bu = (b.reshape(s, -1, 3) * u[None, :, None]).reshape(s, -1)
        with highest_precision():
            g = bu @ b.T
            c = bu @ d
        return _solve_normal(g, c[:, None], ridge, n_refine)

    u = torch.ones(d3.shape[0], dtype=torch.float32, device=d.device)
    w, report = solve(u)
    for _ in range(n_iter):
        with highest_precision():
            fit = (w[:, 0] @ b).reshape(-1, 3)
        r = torch.linalg.norm(fit - d3, dim=1)
        u = huber_vertex_weights(r, huber_scale(r))
        w, report = solve(u)
    return w[:, 0], report


def weights_robust(
    model: DBSEModel, current, rest, ridge: float = 1e-6, n_iter: int = 4,
    n_refine: int = 2,
) -> tuple[torch.Tensor, SolveReport]:
    """Huber-IRLS blendshape weights, robust to scan outliers.

    Minimizes sum_v huber(||B_v w - d_v||) by iteratively reweighted least
    squares on the S x S Gram solve:

        u_v = min(1, delta / r_v)   (delta re-estimated each sweep from
                                     the residual MAD)
        w   = solve(B^T U B + reg,  B^T U d)

    n_iter reweight sweeps after the plain least-squares start (4, the
    JAX package's fixed count; it has no convergence signal).
    """
    d = _pose_deltas(model, torch.as_tensor(current)[None], rest)[0]
    return _robust(model, d, ridge, n_iter, n_refine)


def weights_robust_batched(
    model: DBSEModel, poses, rest, ridge: float = 1e-6,
) -> tuple[torch.Tensor, SolveReport]:
    """(F, V, 3) scanned poses -> (F, S) Huber-IRLS weights; the report's
    fields carry a leading frame axis.  Each frame runs its own IRLS (its
    vertex weights differ), one after another."""
    d = _pose_deltas(model, poses, rest)
    outs = [_robust(model, df, ridge, 4, 2) for df in d]
    w = torch.stack([o[0] for o in outs])
    report = SolveReport(*(
        None if vals[0] is None else torch.stack(vals)
        for vals in zip(*[o[1] for o in outs])))
    return w, report


def reconstruct(
    model: DBSEModel,
    weights: torch.Tensor,
    clamp: Optional[Tuple[float, float]],
    parity_scale: bool,
) -> torch.Tensor:
    """Displacement field from weights: sum_s deltas[s] * cw_s (dbse.cpp:60-75).

    parity_scale applies the reference's magic x3 (dbse.cpp:69); clamping
    (doclampweight/weightrange, src/SOP_FaceDeform.cpp:454-458) applies to
    the scaled weight, as SYSclamp(w, lo, hi) at dbse.cpp:71.  Weights may
    carry leading axes: (S,) -> (V, 3), an animated shot's (F, S) ->
    (F, V, 3).
    """
    w = profiling.to_device(weights, model.device, torch.float32)
    if parity_scale:
        w = w * 3.0
    if clamp is not None:
        lo, hi = clamp
        w = torch.clamp(w, float(lo), float(hi))
    s, v = model.deltas.shape[0], model.deltas.shape[1]
    with highest_precision():
        out = w.reshape(-1, s) @ _flat(model)
    return out.reshape(*w.shape[:-1], v, 3)


def morph_pass(
    positions: torch.Tensor,
    rest: torch.Tensor,
    disp: torch.Tensor,
    dofalloff: bool,
    falloffradius: float,
) -> torch.Tensor:
    """The morph-space position update (src/SOP_FaceDeform.cpp:460-472):

        P = rest + disp [+ (P_current - rest) * falloffradius]

    The bracketed residual term only fires when dofalloff is on and
    falloffradius != 0 (:467-470): the reference's falloffradius is
    morph-space-only despite its name (SURVEY.md quirk 5).  Broadcasts
    over a leading frame axis: (F, V, 3) positions/disp with (V, 3) rest.
    """
    if bool(dofalloff) and float(falloffradius) != 0.0:
        return rest + disp + (positions - rest) * float(falloffradius)
    return rest + disp


def morph_apply(
    model: DBSEModel,
    positions,
    rest,
    weights: torch.Tensor,
    cfg,
    params,
) -> torch.Tensor:
    """The morph stage: clamp set-up -> reconstruct -> morph_pass, on the
    model's device.  positions/weights may carry a leading frame axis:
    (F, V, 3) with (F, S) morphs a whole shot.  The parity path scales by
    3 (not cfg.dbse_lstsq) and the clamp applies when cfg.doclampweight."""
    dev = model.device
    positions = profiling.to_device(positions, dev, torch.float32)
    rest = profiling.to_device(rest, dev, torch.float32)
    clamp = (params.weight_lo, params.weight_hi) if cfg.doclampweight else None
    disp = reconstruct(model, weights, clamp, parity_scale=not cfg.dbse_lstsq)
    return morph_pass(positions, rest, disp, cfg.dofalloff, params.falloffradius)
