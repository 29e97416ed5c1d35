"""Skinning decomposition: bake the RBF deformer to linear blend skinning
(port of facedeform_tpu/ops/skinning.py).

Engines evaluate LINEAR BLEND SKINNING (per-vertex bone weights plus
per-pose rigid bone transforms), not RBF fields.  This module samples the
deformer over a set of poses and decomposes

    P[f, v] ~= sum_b W[v, b] * (X[v] @ R[f, b].T + t[f, b])

into B virtual bones: Smooth Skinning Decomposition with Rigid Bones (Le &
Deng, SIGGRAPH Asia 2012), as the JAX package lays it out:

* every stage is a dense (V, B)-shaped contraction: k-means assignment
  distances, weighted Procrustes moments and the weight-solve gradient;
* the weight solve is projected gradient over the whole (V, B) weight
  matrix (diagonal-preconditioned, capped-simplex projection with a top-k
  support cap, exact line search), not a per-vertex NNLS loop;
* the host parts (k-NN by cKDTree, k-means++ seeding on float64 with
  np.random.default_rng(seed)) are the JAX package's, so both start from
  the same init.

Where the JAX package scans frame by frame, the port keeps one PGD call's
per-frame bone bases on the device when they fit BASIS_CACHE_BYTES (1.5 GB
at 1M vertices x 16 bones x 8 frames) and recomputes them per frame past
it; sums over frames still run in frame order.  Every matmul runs inside
utils.precision.highest_precision() (no TF32: its 10-bit mantissa would not
hold the stages' tolerances).

The vertex-axis reduction hook of the JAX module (`axis_name`, for its
sharded fit) is left out; `valid` stays on the stages that take it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from facedeform_tpu_torch.utils.precision import highest_precision
from facedeform_tpu_torch.utils.profiling import StageTimes, stage

#: bytes of per-frame (V, B, 3) bone bases one PGD call keeps on the device;
#: keeping them makes the alternation 1.41x faster than recomputing them on
#: each pass at 1M vertices x 16 bones x 8 poses on an H100 (3.26 s against
#: 4.61 s, 1.2 GiB more peak memory; chip_smoke.py --skin-bases)
BASIS_CACHE_BYTES = 8 << 30
#: squarings of the shifted Horn matrix: the top eigenvector's share grows
#: as the eigenvalue ratio to the power 2^k, so 40 resolve relative gaps
#: far below float32's resolution
TOP_EIG_SQUARINGS = 40


# --------------------------------------------------------------- projection
def project_capped_simplex(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Row-wise Euclidean projection of (V, B) onto the simplex
    {w >= 0, sum w = 1} restricted to `mask` (True = allowed support).

    Sort-based water-filling; masked-out entries are pushed to -1e30
    before the threshold search and pinned to 0.  Callers guarantee at
    least one allowed bone per row."""
    wm = torch.where(mask, w, torch.full_like(w, -1e30))
    s = -torch.sort(-wm, dim=-1).values
    cs = torch.cumsum(s, dim=-1)
    k = torch.arange(1, w.shape[-1] + 1, dtype=w.dtype, device=w.device)
    tau = (cs - 1.0) / k
    n_active = torch.sum(s > tau, dim=-1, keepdim=True)
    tau_star = torch.gather(tau, -1, (n_active - 1).clamp(min=0))
    return torch.where(mask, torch.clamp(wm - tau_star, min=0.0), torch.zeros_like(w))


# ----------------------------------------------------- local rigid features
def _top_eigenvector(n: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the largest eigenvalue of symmetric (..., 4, 4)
    matrices, in float64: n + ||n||_F I has the same eigenvectors and no
    negative eigenvalue, so repeated squaring (normalized each time)
    converges to the projector on the top eigenvector, whose largest
    column two power steps then polish.  cuSOLVER's batched eigh rejects
    a batch of 1M 4x4 matrices (CUSOLVER_STATUS_INVALID_VALUE sizing its
    workspace), and this needs no solver: batched 4x4 products only.  A
    zero matrix gives (0, 0, 0, 1), LAPACK's last eigenvector of it."""
    m = n.double()
    m = m + torch.linalg.matrix_norm(m)[..., None, None] * torch.eye(
        4, dtype=m.dtype, device=m.device)
    p = m
    for _ in range(TOP_EIG_SQUARINGS):
        p = p / torch.clamp(torch.amax(torch.abs(p), dim=(-2, -1), keepdim=True), min=1e-300)
        p = p @ p
    col = torch.argmax(torch.linalg.vector_norm(p, dim=-2), -1)
    v = torch.gather(p, -1, col[..., None, None].expand(*p.shape[:-1], 1))[..., 0]
    for _ in range(2):
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-300)
        v = (m @ v[..., None])[..., 0]
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    last = torch.zeros_like(v)
    last[..., 3] = 1.0
    return torch.where(norm > 0, v / torch.clamp(norm, min=1e-300), last).float()


def _horn_quaternions(s: torch.Tensor) -> torch.Tensor:
    """Batched rotation quaternions (w, x, y, z) from (..., 3, 3) Procrustes
    covariances S_ij = sum_k x_i p_j: the top eigenvector of Horn's
    symmetric 4x4 (well defined for the rank-2 covariances of near-planar
    surface neighbourhoods), sign fixed to the w >= 0 hemisphere."""
    sxx, sxy, sxz = s[..., 0, 0], s[..., 0, 1], s[..., 0, 2]
    syx, syy, syz = s[..., 1, 0], s[..., 1, 1], s[..., 1, 2]
    szx, szy, szz = s[..., 2, 0], s[..., 2, 1], s[..., 2, 2]
    n = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
        torch.stack([szx - sxz, sxy + syx, syy - sxx - szz, syz + szy], -1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, szz - sxx - syy], -1),
    ], -2)
    q = _top_eigenvector(n)
    return torch.where(q[..., 0:1] < 0, -q, q)


def _quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit quaternion (w, x, y, z) -> (..., 3, 3) rotation."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _rigid_feats(x: torch.Tensor, frames: torch.Tensor, nbr: torch.Tensor,
                 inv_scale: float) -> torch.Tensor:
    """(V, 7F) per-frame local rigid-transform features: a rigid (R, t)
    fitted to each vertex's k-NN neighbourhood motion (Horn quaternions),
    [q, t * inv_scale] per frame.  Rigid-coherent regions share them
    exactly; they vary only across true motion boundaries."""
    xn = x[nbr]                                         # (V, K, 3)
    xbar = xn.mean(1)
    xc = xn - xbar[:, None]
    out = []
    with highest_precision():
        for p_f in frames:
            pn = p_f[nbr]
            pbar = pn.mean(1)
            pc = pn - pbar[:, None]
            s = torch.einsum("vki,vkj->vij", xc, pc)
            q = _horn_quaternions(s)
            r = _quat_to_mat(q)
            t = pbar - torch.einsum("vij,vj->vi", r, xbar)
            out.append(torch.cat([q, t * inv_scale], -1))
    return torch.stack(out, 1).reshape(x.shape[0], -1)


def _local_rigid_features(x: np.ndarray, p: np.ndarray, k_neighbors: int,
                          device) -> torch.Tensor:
    """k-NN on the rest points on the host (scipy), features on `device`."""
    from scipy.spatial import cKDTree

    k = int(min(k_neighbors, x.shape[0]))
    _, nbr = cKDTree(x).query(x, k=k, workers=-1)
    nbr = np.ascontiguousarray(np.atleast_2d(nbr.T).T, np.int64)
    bbox = float(np.linalg.norm(x.max(0) - x.min(0)))
    return _rigid_feats(
        torch.as_tensor(x, device=device), torch.as_tensor(p, device=device),
        torch.as_tensor(nbr, device=device), float(np.float32(1.0 / max(bbox, 1e-12))),
    )


# ------------------------------------------------------------------ k-means
def _kmeans_labels(feats: torch.Tensor, cent0: torch.Tensor, n_clusters: int,
                   iters: int, valid: torch.Tensor) -> torch.Tensor:
    """Lloyd iterations on (V, D) features from centroids cent0 (B, D);
    returns labels.  Assignment distances are one (V, D) @ (D, B) matmul
    (||x||^2 drops out of the argmin); an empty cluster keeps its
    centroid; `valid` (V,) zeroes padded rows out of the centroid sums."""
    cent = cent0
    with highest_precision():
        for _ in range(iters):
            d2 = torch.sum(cent * cent, -1)[None, :] - 2.0 * (feats @ cent.T)
            labels = torch.argmin(d2, -1)
            one_hot = F.one_hot(labels, n_clusters).to(feats.dtype) * valid[:, None]
            sums = one_hot.T @ feats
            counts = one_hot.sum(0)[:, None]
            cent = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), cent)
        d2 = torch.sum(cent * cent, -1)[None, :] - 2.0 * (feats @ cent.T)
    return torch.argmin(d2, -1)


def _kmeanspp_indices(feats64: np.ndarray, n_clusters: int,
                      rng: np.random.Generator) -> np.ndarray:
    """k-means++ seeding on host float64 (B sequential steps), the JAX
    package's draws and arithmetic (rows reduced in chunks: a row's sum
    does not depend on the chunk)."""
    v = feats64.shape[0]

    def dist2(row):
        return np.concatenate([((feats64[i:i + 65536] - row) ** 2).sum(-1)
                               for i in range(0, v, 65536)])

    idx = [int(rng.integers(0, v))]
    d2 = dist2(feats64[idx[0]])
    for _ in range(1, n_clusters):
        total = float(d2.sum())
        if total <= 0:  # fewer distinct trajectories than bones
            idx.append(int(rng.integers(0, v)))
            continue
        nxt = int(rng.choice(v, p=d2 / total))
        idx.append(nxt)
        d2 = np.minimum(d2, dist2(feats64[nxt]))
    return np.asarray(idx, np.int32)


# ----------------------------------------------------------------- moments
def _procrustes_transforms(x, frames, w, eps=1e-8):
    """Weighted Procrustes per (frame, bone): the optimal rigid (R, t),
    from (B, V) @ (V, k) moment contractions per frame and one batched
    SVD of the (F, B) 3x3 covariances.

    The moments are taken about the mean rest point and each frame's mean
    point (the covariance does not depend on the origin): uncentered f32
    moments of a mesh far from the origin cancel to a few digits (the JAX
    package's are ~1e-3 off on tests/test_skinning.py's mesh at |x| ~ 60),
    centered ones keep the covariance to f32 rounding."""
    v = x.shape[0]
    x0 = torch.mean(x, 0)
    xs = x - x0
    with highest_precision():
        sw_safe = torch.clamp(torch.sum(w, 0), min=eps)               # (B,)
        xc = (w.T @ xs) / sw_safe[:, None]                            # (B, 3)
        s_f, pc_f = [], []
        for p in frames:
            p0 = torch.mean(p, 0)
            ps = p - p0
            pc = (w.T @ ps) / sw_safe[:, None]
            z = (ps[:, :, None] * xs[:, None, :]).reshape(v, 9)
            m = (w.T @ z).reshape(-1, 3, 3)
            s_f.append(m - sw_safe[:, None, None] * pc[:, :, None] * xc[:, None, :])
            pc_f.append(pc + p0)
        xc = xc + x0
        s, pc = torch.stack(s_f), torch.stack(pc_f)                  # (F,B,3,3), (F,B,3)
        u, _, vt = torch.linalg.svd(s)
        det = torch.linalg.det(u @ vt)
        d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
        r = (u * d[..., None, :]) @ vt                                # (F, B, 3, 3)
        t = pc - torch.einsum("fbij,bj->fbi", r, xc)
    return r, t


def _frame_basis(x, r_f, t_f):
    """(V, B, 3) bone-transformed rest positions for one frame: one
    (V, 3) @ (3, 3B) product."""
    b = r_f.shape[0]
    with highest_precision():
        y = (x @ r_f.reshape(b * 3, 3).T).reshape(x.shape[0], b, 3)
    return y + t_f[None, :, :]


def _centered_bases(x, r, t):
    """Per-frame (V, B, 3) bases minus the rest positions."""
    for f in range(r.shape[0]):
        yield _frame_basis(x, r[f], t[f]) - x[:, None, :]


class _Bases:
    """The frames' centered bases for one set of transforms, in frame
    order: kept on the device when they fit BASIS_CACHE_BYTES, else
    recomputed on each pass."""

    def __init__(self, x, r, t):
        self.args = (x, r, t)
        n_bytes = r.shape[0] * x.shape[0] * r.shape[1] * 3 * x.element_size()
        self.kept = list(_centered_bases(x, r, t)) if n_bytes <= BASIS_CACHE_BYTES else None

    def __iter__(self):
        return iter(self.kept) if self.kept is not None else _centered_bases(*self.args)


def _combine(w, y):
    """sum_b w[v, b] y[v, b, :] -> (V, 3)."""
    return torch.sum(w[:, :, None] * y, 1)


def _weights_pgd(x, frames, r, t, w0, mask, iters, nbr=None, deg=None, smooth_lam=0.0):
    """Projected gradient on the masked simplex, exact line search.

    Objective per vertex: sum_f |sum_b w_vb y_fvb - p_fv|^2 with y the
    bone-transformed positions, in the displacement form (the bases minus
    the rest position: same minimizer, displacement-scale columns, so the
    diagonal preconditioner reflects the curvature).  Each iteration
    moves along d = P(w - g/diag) - w by the exact quadratic step
    alpha* = -g.d / (d^T H d) clipped to [0, 1] (the full Jacobi step
    diverges on correlated bone bases).  With `nbr`/`deg`/`smooth_lam`
    the graph-Laplacian term smooth_lam * sum_edges ||w_u - w_v||^2 joins
    (nbr self-padded; the line-search denominator uses the bound
    d^T L d <= 2 sum_v deg_v |d_v|^2).  `mask` pins pruned bones to 0."""
    bases = _Bases(x, r, t)
    disp = [p - x for p in frames]
    diag = torch.zeros_like(w0)
    for y in bases:
        diag = diag + torch.sum(y * y, -1)

    def grad(w):
        g = torch.zeros_like(w)
        for y, dp in zip(bases, disp):
            resid = _combine(w, y) - dp
            g = g + torch.sum(resid[:, None, :] * y, -1)
        return g

    def curvature(dirn):
        c = torch.zeros_like(w0[:, 0])
        for y in bases:
            a = _combine(dirn, y)
            c = c + torch.sum(a * a, -1)
        return c

    # land the start on the masked simplex: the line-search blend keeps
    # any support the start had, so the cap then holds on exit
    w = project_capped_simplex(w0, mask)
    for _ in range(iters):
        g, d = grad(w), diag
        if nbr is not None:
            # L w with self-padded neighbour rows: Dmax * w_v - sum_j w[nbr]
            lw = nbr.shape[1] * w - torch.sum(w[nbr], 1)
            g = g + smooth_lam * lw
            d = d + smooth_lam * deg[:, None]
        # Levenberg-style floor tied to the row's strongest curvature
        d = d + 0.05 * torch.amax(d, -1, keepdim=True) + 1e-12
        dirn = project_capped_simplex(w - g / d, mask) - w
        num = -torch.sum(g * dirn, -1)
        den = curvature(dirn)
        if nbr is not None:
            den = den + 2.0 * smooth_lam * deg * torch.sum(dirn * dirn, -1)
        alpha = torch.clamp(num / torch.clamp(den, min=1e-20), 0.0, 1.0)
        w = w + alpha[:, None] * dirn
    return w


def _per_bone_err2(x, frames, r, t):
    """(V, B) squared reconstruction error, summed over frames, of
    assigning each vertex wholly to each bone."""
    e = torch.zeros(x.shape[0], r.shape[1], dtype=x.dtype, device=x.device)
    for f in range(r.shape[0]):
        y = _frame_basis(x, r[f], t[f]) - frames[f][:, None, :]
        e = e + torch.sum(y * y, -1)
    return e


def _ssdr_rounds(x, frames, w0, outer, pgd_iters, max_influences, hard_rounds, valid,
                 nbr=None, deg=None, smooth_lam=0.0, times=None):
    """Hard rigid-k-means rounds, then Procrustes <-> PGD alternation.

    The hard rounds reassign each vertex to the bone whose rigid transform
    reconstructs it best; the support is pruned to `max_influences` (by
    rank, so exact ties cannot overflow the cap) only at the last soft
    round.  `valid` (V,) gates padded rows; the re-mask after every PGD
    call matters to a caller that pads (the masked projection re-fills a
    zero row)."""
    n_bones = w0.shape[1]
    w = w0
    with stage("hard_rounds", times):
        for _ in range(hard_rounds):
            r, t = _procrustes_transforms(x, frames, w)
            labels = torch.argmin(_per_bone_err2(x, frames, r, t), -1)
            w = F.one_hot(labels, n_bones).to(w.dtype) * valid[:, None]
    with stage("alternation", times):
        full = torch.ones_like(w, dtype=torch.bool)
        for i in range(outer):
            r, t = _procrustes_transforms(x, frames, w)
            if i == outer - 1:
                order = torch.argsort(-w, dim=-1, stable=True)
                mask = torch.argsort(order, dim=-1, stable=True) < max_influences
            else:
                mask = full
            w = _weights_pgd(x, frames, r, t, w, mask, pgd_iters, nbr, deg, smooth_lam)
            w = w * valid[:, None]
        r, t = _procrustes_transforms(x, frames, w)
    return w, r, t


class SkinningModel(NamedTuple):
    """LBS decomposition: per-pose bone transforms + vertex weights.

    weights:    (V, B) f32, rows on the simplex, <= max_influences
                nonzeros each.
    rotations:  (F, B, 3, 3) f32 per training-pose bone rotations.
    translations: (F, B, 3) f32.
    rest:       (V, 3) f32 rest positions the weights were fitted against.
    """

    weights: torch.Tensor
    rotations: torch.Tensor
    translations: torch.Tensor
    rest: torch.Tensor

    @property
    def n_bones(self) -> int:
        return self.weights.shape[1]

    @property
    def n_frames(self) -> int:
        return self.rotations.shape[0]


def lbs_apply(weights, rest, r, t):
    """Pose (V, 3) positions from (V, B) weights and one frame's
    (B, 3, 3)/(B, 3) transforms: the engine-side evaluation."""
    return _combine(weights, _frame_basis(rest, r, t))


@dataclasses.dataclass(frozen=True)
class SkinningReport:
    """Decomposition quality: worst/RMS reconstruction distance over the
    training poses, in mesh units.  `weight_roughness` (with `edges`) is
    the RMS per-edge weight jump sqrt(mean_edges ||w_u - w_v||^2)."""

    rmse: float
    max_err: float
    bbox_diag: float
    weight_roughness: Optional[float] = None

    @property
    def relative_rmse(self) -> float:
        return self.rmse / max(self.bbox_diag, 1e-12)


def validate_inputs(rest_points, posed_frames, n_bones: int,
                    max_influences: int) -> tuple[np.ndarray, np.ndarray]:
    """The input contract of fit_skinning: (V, 3) rest, (F, V, 3) frames."""
    x = np.asarray(rest_points, np.float32)
    p = np.asarray(posed_frames, np.float32)
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"rest_points must be (V, 3), got {x.shape}")
    if p.ndim != 3 or p.shape[1:] != x.shape:
        raise ValueError(
            f"posed_frames must be (F,) + {x.shape}, got {p.shape}"
        )
    v = x.shape[0]
    if not 1 <= n_bones <= min(v, 256):
        raise ValueError(f"n_bones={n_bones} out of range [1, min(V, 256)]")
    if not 1 <= max_influences <= n_bones:
        raise ValueError(
            f"max_influences={max_influences} must be in [1, n_bones]"
        )
    return x, p


def fit_skinning(
    rest_points: np.ndarray,
    posed_frames: np.ndarray,
    n_bones: int = 16,
    max_influences: int = 4,
    outer_iters: int = 8,
    pgd_iters: int = 24,
    kmeans_iters: int = 15,
    hard_rounds: int = 5,
    k_neighbors: int = 8,
    seed: int = 0,
    edges: Optional[np.ndarray] = None,
    smooth_lambda: float = 0.0,
    device="cuda",
    times: Optional[StageTimes] = None,
) -> tuple[SkinningModel, SkinningReport]:
    """Decompose sampled deformations into LBS bones + weights on `device`.

    rest_points: (V, 3); posed_frames: (F, V, 3), typically the deformer's
    output over a pose sweep.  Initialization is k-means++ over per-vertex
    local rigid-transform features (k-NN Procrustes per frame,
    `k_neighbors`), then hard rounds and the alternation.

    edges: optional (E, 2) mesh edges (geometry.topology.unique_edges).
    With `smooth_lambda > 0` the weight solve adds the Laplacian term
    smooth_lambda * sum_edges ||w_u - w_v||^2, scaled by the shot's mean
    squared displacement x F so the knob is unitless, over a neighbour
    table capped at ops.jacobian.TRANSPORT_MAX_DEGREE (stride-sampled: a
    1M UV sphere's ~1000-degree poles would make a 64 GB (V, Dmax, B)
    gather).  Edges alone (lambda 0) populate report.weight_roughness.
    `times` collects the stages' walls (features, kmeans, hard_rounds,
    alternation, report), fenced.
    """
    x, p = validate_inputs(rest_points, posed_frames, n_bones, max_influences)
    v = x.shape[0]
    dev = torch.device(device)

    nbr = deg = None
    lam_eff = 0.0
    if float(smooth_lambda) > 0.0 and (edges is None or np.asarray(edges).size == 0):
        raise ValueError(
            "smooth_lambda > 0 needs mesh edges (pass edges= from "
            "geometry.topology.unique_edges; point clouds have none)"
        )
    if edges is not None:
        e = np.asarray(edges, np.int64)
        if e.ndim != 2 or e.shape[1] != 2:
            raise ValueError(f"edges must be (E, 2), got {e.shape}")
        if e.size and (e.min() < 0 or e.max() >= v):
            raise ValueError("edges index outside [0, V)")
        if float(smooth_lambda) > 0.0 and e.size:
            from facedeform_tpu_torch.geometry.topology import padded_neighbors
            from facedeform_tpu_torch.ops.jacobian import TRANSPORT_MAX_DEGREE

            nbr_np, deg_np = padded_neighbors(v, e, max_degree=TRANSPORT_MAX_DEGREE)
            nbr = torch.as_tensor(nbr_np, dtype=torch.int64, device=dev)
            deg = torch.as_tensor(deg_np, device=dev)
            # unitless knob: the data term's natural magnitude
            disp2 = float(np.mean((p - x[None]) ** 2) * 3.0) * p.shape[0]
            lam_eff = float(smooth_lambda) * max(disp2, 1e-12)

    xt = torch.as_tensor(x, device=dev)
    pt = torch.as_tensor(p, device=dev)
    with stage("features", times):
        feats = _local_rigid_features(x, p, k_neighbors, dev)
        feats_np = feats.cpu().numpy()
    with stage("kmeans", times):
        rng = np.random.default_rng(seed)
        init_idx = _kmeanspp_indices(feats_np.astype(np.float64), n_bones, rng)
        valid = torch.ones(v, dtype=torch.float32, device=dev)
        labels = _kmeans_labels(feats, feats[torch.as_tensor(init_idx, device=dev).long()],
                                n_bones, kmeans_iters, valid)
        w0 = F.one_hot(labels, n_bones).float()

    w, r, t = _ssdr_rounds(xt, pt, w0, int(outer_iters), int(pgd_iters), int(max_influences),
                           int(hard_rounds), valid, nbr=nbr, deg=deg, smooth_lam=lam_eff,
                           times=times)
    model = SkinningModel(w, r, t, xt)

    # the report's scalars come to the host in one transfer
    with stage("report", times):
        err2 = _reconstruction_err2(model, pt)
        scalars = [torch.mean(err2), torch.amax(err2)]
        has_edges = edges is not None and np.asarray(edges).size
        if has_edges:
            e_dev = torch.as_tensor(np.asarray(edges, np.int64), device=dev)
            jump2 = torch.sum((w[e_dev[:, 0]] - w[e_dev[:, 1]]) ** 2, -1)
            scalars.append(torch.sqrt(torch.mean(jump2)))
        vals = torch.stack(scalars).tolist()
    report = SkinningReport(
        rmse=float(np.sqrt(vals[0])),
        max_err=float(np.sqrt(vals[1])),
        bbox_diag=float(np.linalg.norm(x.max(0) - x.min(0))),
        weight_roughness=vals[2] if has_edges else None,
    )
    return model, report


def _reconstruction_err2(model: SkinningModel, frames: torch.Tensor) -> torch.Tensor:
    """(F, V) squared reconstruction distances over the training poses."""
    return torch.stack([
        torch.sum((lbs_apply(model.weights, model.rest, model.rotations[f],
                             model.translations[f]) - frames[f]) ** 2, -1)
        for f in range(frames.shape[0])
    ])
