"""Pose-space deformation (PSD): sculpted corrections driven by rig pose
(port of facedeform_tpu/ops/psd.py).

An artist poses the rig, sculpts the mesh the deformer got wrong, and
expects the fix to reproduce exactly whenever the rig hits that pose
again and to blend smoothly into nearby poses (Lewis/Cordner/Fong,
SIGGRAPH 2000): the model-space RBF machinery applied in pose space.

* A pose is the rig displacement flattened to f = (posed - rest).ravel()
  in R^(3N).
* K example poses give features F (K, D) and corrections C (K, V, 3) =
  sculpt_k - full_pipeline_output(pose_k): they absorb whatever the base
  pipeline does at the example poses, so adding the interpolated
  correction reproduces each sculpt exactly at its own pose.
* Cardinal RBF interpolation in pose space: (Phi + lam I) A = I_K with
  Phi_jk = phi(|f_j - f_k| / eps), solved by the refined LU of
  ops/solve.py; weights at a query pose q are w = phi_q @ A, with
  w(f_j) = e_j at lam = 0.
* The mesh-space apply is one (K) x (K, 3V) contraction.

The default kernel is GAUSSIAN (positive definite: lam = 0 is solvable,
and weights fade to zero far from every example).  normalize=True
rescales weights toward a partition of unity where their sum is
significant.  Every matmul runs under utils.precision.highest_precision:
a TF32 contraction on the card would break an example pose's exact
sculpt reproduction.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from facedeform_tpu_torch.config import RBFKernel
from facedeform_tpu_torch.ops.kernels import apply_kernel, kernel_is_pd
from facedeform_tpu_torch.ops.solve import SolveReport, lu_solve_refined
from facedeform_tpu_torch.utils import profiling
from facedeform_tpu_torch.utils.precision import highest_precision

def pairwise_sqdist_nd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(A, D), (B, D) -> (A, B) exact-difference squared distances (pose
    descriptors live in R^(3N); kernels.pairwise_sqdist is 3-D only)."""
    d = x[:, None, :] - y[None, :, :]
    return torch.sum(d * d, dim=-1)


class PSDModel(NamedTuple):
    """Solved pose-space interpolation.

    features:    (K, D) f32 example pose descriptors.
    alpha:       (K, K) f32 cardinal solve (Phi + lam I)^-1.
    corrections: (K, V, 3) f32 sculpt-minus-base deltas, rest order.
    eps:         () f32 kernel radius in pose space.
    """

    features: torch.Tensor
    alpha: torch.Tensor
    corrections: torch.Tensor
    eps: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.features.device


def features_from_rig(rest_rig: np.ndarray, posed_rig: np.ndarray) -> np.ndarray:
    """Pose descriptor: flattened marker displacement (D = 3N)."""
    rest = np.asarray(rest_rig, np.float32)
    posed = np.asarray(posed_rig, np.float32)
    if rest.shape != posed.shape:
        raise ValueError(
            f"posed rig shape {posed.shape} != rest rig shape {rest.shape}"
        )
    return (posed - rest).reshape(-1)


def rigid_align(rest_rig: np.ndarray, posed_rig: np.ndarray):
    """Best-fit rigid registration of a posed rig onto the rest rig.

    Kabsch in float64 on the host (N is rig-sized): returns (aligned, r)
    where aligned = (posed - posed_mean) @ r + rest_mean is the posed rig
    with its rigid motion removed and r is the rest->posed rotation in
    ROW convention: a row vector in the rest (head-local) frame maps to
    world as v_world = v_local @ r.T, so a world-space field moves into
    the local frame as c_local = c_world @ r.

    A proper rotation is enforced (det +1 via the sign-flip column), so
    mirror-image poses align through the nearest rotation, never a
    reflection.  Needs >= 3 markers.
    """
    rest = np.asarray(rest_rig, np.float64)
    posed = np.asarray(posed_rig, np.float64)
    if rest.shape != posed.shape:
        raise ValueError(
            f"posed rig shape {posed.shape} != rest rig shape {rest.shape}"
        )
    if rest.ndim != 2 or rest.shape[1] != 3 or rest.shape[0] < 3:
        raise ValueError(
            "rigid_align needs an (N>=3, 3) rig; got "
            f"{rest.shape} (a rotation is underdetermined below 3 markers)"
        )
    rest_c = rest - rest.mean(0)
    posed_mean = posed.mean(0)
    posed_c = posed - posed_mean
    h = rest_c.T @ posed_c                      # (3, 3) covariance
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    # rest->posed rotation (column convention R = V diag(1,1,d) U^T);
    # posed_c ~= rest_c @ r.T in row convention
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    aligned = posed_c @ r + rest.mean(0)
    return aligned.astype(np.float32), r.astype(np.float32)


def auto_eps(features: np.ndarray) -> float:
    """Median pairwise example distance: the package's auto-radius
    convention (cf. ops/pu.py eps='auto'), here over the K examples."""
    f = np.asarray(features, np.float64)
    d2 = ((f[:, None, :] - f[None, :, :]) ** 2).sum(-1)
    off = d2[~np.eye(len(f), dtype=bool)]
    if off.size == 0:  # single example: any positive scale works (w(f_0)=1)
        return float(max(np.sqrt((f[0] ** 2).sum()), 1.0))
    return float(max(np.sqrt(np.median(off)), 1e-12))


def fit_psd(
    features: np.ndarray,
    corrections,
    kernel: RBFKernel = RBFKernel.GAUSSIAN,
    eps: Optional[float] = None,
    lam: float = 0.0,
    device="cuda",
) -> tuple[PSDModel, SolveReport]:
    """Solve the pose-space cardinal system (Phi + lam I) A = I_K on
    `device`; corrections (K, V, 3) may be a host array or a tensor.

    Raises ValueError on duplicate example poses (singular at lam = 0,
    and two identical poses with different sculpts are a contradiction
    the artist should resolve) and on a non-PD kernel at lam = 0.
    """
    feats = np.asarray(features, np.float32)
    if feats.ndim != 2:
        raise ValueError(f"features must be (K, D), got {feats.shape}")
    k = feats.shape[0]
    corr_shape = tuple(corrections.shape)
    if corr_shape[:1] != (k,) or len(corr_shape) != 3 or corr_shape[-1] != 3:
        raise ValueError(
            f"corrections must be (K={k}, V, 3), got {corr_shape}"
        )
    kernel = RBFKernel(kernel)
    if eps is None:
        eps = auto_eps(feats)
    if not np.isfinite(eps) or eps <= 0:
        raise ValueError(f"psd eps must be positive, got {eps}")

    # duplicate-pose check on the host (K is tiny): scale-relative tolerance
    d2 = ((feats.astype(np.float64)[:, None, :]
           - feats.astype(np.float64)[None, :, :]) ** 2).sum(-1)
    scale2 = max(float(d2.max()), 1e-30)
    iu = np.triu_indices(k, 1)
    dup = np.flatnonzero(d2[iu] <= 1e-12 * scale2)
    if dup.size:
        a, b = iu[0][dup[0]], iu[1][dup[0]]
        raise ValueError(
            f"duplicate example poses {int(a)} and {int(b)}: pose-space "
            "distance ~0; merge the sculpts or perturb one pose"
        )
    if float(lam) == 0.0 and not kernel_is_pd(kernel):
        raise ValueError(
            f"kernel {kernel.name} is not positive definite; pose-space "
            "fits have no polynomial tail, pass lam > 0"
        )

    f_t = profiling.to_device(feats, device)
    corr_t = profiling.to_device(corrections, device, torch.float32)
    eps_t = profiling.to_device(eps, device, torch.float32)
    phi = apply_kernel(kernel, pairwise_sqdist_nd(f_t, f_t), eps_t)
    eye = torch.eye(k, dtype=torch.float32, device=device)
    a = phi + profiling.to_device(lam, device, torch.float32) * eye
    alpha, report = lu_solve_refined(a, eye)
    return PSDModel(f_t, alpha, corr_t, eps_t), report


def psd_weights(
    model: PSDModel,
    feats,
    kernel: RBFKernel = RBFKernel.GAUSSIAN,
    normalize: bool = False,
) -> torch.Tensor:
    """Pose-space weights for one (D,) or a batch (..., D) of poses.

    normalize=True rescales to sum(w) = 1 where the sum is significant:
    w / sign(s) max(|s|, delta) is EXACTLY w / s once |s| >= delta = 1e-2,
    and fades to the raw weights when every example is out of kernel
    reach, so it never divides by a vanishing sum.  At an example pose
    w = e_j sums to 1, so normalization keeps exact sculpt reproduction
    (a soft form s / (s^2 + 1e-4) cost 1e-4 there, double the 5e-5
    budget).
    """
    feats = profiling.to_device(feats, model.device, torch.float32)
    squeeze = feats.ndim == 1
    q = torch.atleast_2d(feats)
    phi = apply_kernel(kernel, pairwise_sqdist_nd(q, model.features), model.eps)
    with highest_precision():
        w = phi @ model.alpha
    if normalize:
        s = torch.sum(w, dim=-1, keepdim=True)
        denom = torch.where(torch.abs(s) >= 1e-2, s,
                            torch.where(s < 0, -1e-2, 1e-2))
        # blend to identity (raw w) as |s| -> 0 so far-from-example poses
        # keep the fade-out instead of being amplified by 1/delta
        gate = torch.clamp(torch.abs(s) / 1e-2, max=1.0)
        w = w * (gate / denom + (1.0 - gate))
    return w[0] if squeeze else w


def psd_delta(
    model: PSDModel,
    feats,
    kernel: RBFKernel = RBFKernel.GAUSSIAN,
    normalize: bool = False,
) -> torch.Tensor:
    """Blended correction field: (V, 3) for one pose, (F, V, 3) batched.
    One (..., K) x (K, 3V) contraction in full f32: the corrections are
    read once per call, so a shot should batch its poses."""
    w = psd_weights(model, feats, kernel, normalize)
    kk, v, _ = model.corrections.shape
    flat = model.corrections.reshape(kk, v * 3)
    with highest_precision():
        out = torch.atleast_2d(w) @ flat
    return out.reshape(w.shape[:-1] + (v, 3)) if w.ndim > 1 else out.reshape(v, 3)


def pose_feature(rest_rig: np.ndarray, posed_rig: np.ndarray, align: bool = False):
    """(feature (D,), rotation (3, 3) | None) for one query pose.  With
    align=True the descriptor is computed on the rigid-registered pose
    (rigid_align), invariant to head motion, and the returned rest->posed
    rotation maps a rest-frame correction back to world
    (c_world = c_local @ r.T)."""
    if not align:
        return features_from_rig(rest_rig, posed_rig), None
    aligned, r = rigid_align(rest_rig, posed_rig)
    return features_from_rig(rest_rig, aligned), r


@dataclasses.dataclass(frozen=True)
class PSDDeformer:
    """Solved PSD artifact: the model plus its kernel/normalize/align
    knobs; apply composes on top of any base pipeline output (the node
    wires it in when cook(examples=...) is given).

    align=True makes the model rigid-equivariant: descriptors come from
    Kabsch-registered poses and the stored corrections live in the rest
    (head-local) frame, rotated back to world by each query pose's own
    rotation.
    """

    model: PSDModel
    kernel: RBFKernel = RBFKernel.GAUSSIAN
    normalize: bool = False
    report: Optional[SolveReport] = None
    align: bool = False

    @staticmethod
    def fit(
        rest_rig: np.ndarray,
        posed_rigs: np.ndarray,
        corrections: np.ndarray,
        kernel: RBFKernel = RBFKernel.GAUSSIAN,
        eps: Optional[float] = None,
        lam: float = 0.0,
        normalize: bool = False,
        align: bool = False,
        device="cuda",
    ) -> "PSDDeformer":
        """posed_rigs: (K, N, 3) example rig poses; corrections: (K, V, 3)
        world-space sculpt deltas (rotated into the rest frame internally
        when align=True)."""
        posed = np.asarray(posed_rigs, np.float32)
        corr = np.asarray(corrections, np.float32)
        feats, corr_fit = [], []
        for i in range(posed.shape[0]):
            f, r = pose_feature(rest_rig, posed[i], align)
            feats.append(f)
            corr_fit.append(corr[i] @ r if r is not None else corr[i])
        model, report = fit_psd(
            np.stack(feats), np.stack(corr_fit), kernel, eps, lam, device=device
        )
        return PSDDeformer(model, kernel, normalize, report, align)

    def weights(self, rest_rig: np.ndarray, posed_rig: np.ndarray) -> torch.Tensor:
        f, _ = pose_feature(rest_rig, posed_rig, self.align)
        return psd_weights(self.model, f, self.kernel, self.normalize)

    def delta(self, rest_rig: np.ndarray, posed_rig: np.ndarray) -> torch.Tensor:
        f, r = pose_feature(rest_rig, posed_rig, self.align)
        d = psd_delta(self.model, f, self.kernel, self.normalize)
        if r is not None:
            with highest_precision():
                d = d @ profiling.to_device(r.T, d.device)
        return d

    def delta_frames(self, rest_rig: np.ndarray, posed_rigs: np.ndarray) -> torch.Tensor:
        """(F, V, 3) corrections for a whole shot in one contraction."""
        posed = np.asarray(posed_rigs, np.float32)
        feats, rots = [], []
        for i in range(posed.shape[0]):
            f, r = pose_feature(rest_rig, posed[i], self.align)
            feats.append(f)
            rots.append(r)
        d = psd_delta(self.model, np.stack(feats), self.kernel, self.normalize)
        if self.align:
            # per-frame world rotation: (F, V, 3) x (F, 3, 3) -> (F, V, 3)
            rot = profiling.to_device(np.stack(rots), d.device)
            with highest_precision():
                d = torch.einsum("fvc,fdc->fvd", d, rot)
        return d
