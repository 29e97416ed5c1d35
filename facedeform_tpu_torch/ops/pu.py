"""Partition-of-unity (PU) RBF deformation for any-N rigs (port of
facedeform_tpu/ops/pu.py).

One global dense solve stops scaling at tens of thousands of controls.
The PU route covers the control cloud with K overlapping spatial patches,
solves each patch's small dense system, and blends the local interpolants
with compactly supported weights

    s(x) = sum_k W_k(x) s_k(x) / sum_k W_k(x),
    W_k(x) = wendland(|x - c_k| / R_k).

The fit is a batch of (P + m)^2 saddle systems (a leading patch axis
where JAX vmaps), assembled in float64 and split into f32 words, solved by
an f32 LU with float64-residual refinement (ops/solve.py).  The eval walks
(query tile, patch) blocks: the plain composition below (`evaluate_pu`,
`index_add_` where JAX segment-sums) and the CUDA tile kernel of
ops/cuda_pu.py, which the facades take for eps="auto" fits on the card.

Patch k's control set is every control within R_k of its center, so at
lam = 0 every patch covering a control interpolates it and the blend
reproduces the control's displacement.  Query points outside every
support fall back to their nearest patch.  The host-side patch and plan
builders are numpy/scipy, copied from the JAX package so the two packages
build the same arrays bit for bit.

Precision: the JAX package evaluates forced-eps growing-kernel fits in
double-float; the port evaluates them in native float64 (precise=True),
as ops/precise_eval.py does for the global model.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from facedeform_tpu_torch.config import PolyTerm, RBFKernel
from facedeform_tpu_torch.ops.fit import confidence_clipped
from facedeform_tpu_torch.ops.kernels import apply_kernel, phi_prime_s
from facedeform_tpu_torch.ops.precise_eval import GROWING_KERNELS
from facedeform_tpu_torch.ops.solve import SolveReport, df_system, solve_df
from facedeform_tpu_torch.utils import profiling
from facedeform_tpu_torch.utils.profiling import host_f32
from facedeform_tpu_torch.utils.precision import highest_precision

# Bytes of device memory per (P + m)^2 system entry while a chunk of
# patches is fitted: a_hi, a_lo and the f32 LU (12 B), the float64
# system the residual runs against (8 B) and the assembly's float64
# difference, d2 and phi temporaries (~36 B).  The budget, a fifth of the
# H100's 80 GB, leaves room for the eval's 1M-vertex buffers; it fits in
# one chunk a 30k-control rig's 256 patches of P + m = 580 (4.8e9 B) and
# a 53,490-control rig's 512 patches of P + m = 644 (1.19e10 B).  The
# latter's whole node cook on a 1M-vertex mesh peaks at 1.10e10 B on an
# H100, so 56 B an entry bounds the working set from above.
# (The JAX package budgets 2 GB of TPU HBM for ~6 f32 buffers per entry.)
_FIT_BYTES_PER_ENTRY = 56
pu_fit_budget = 16e9
# Bytes per entry a PUFitPlan keeps between poses: the f32 LU and the
# float64 system (12 B), and the f32 words (8 B more) where GMRES-IR reads
# them.  It keeps them where all of them fit pu_fit_budget: a
# 53,490-control rig's 512 patches of P + m = 644 take 2.55e9 B.
_KEPT_BYTES_PER_ENTRY = 12

# Counters (utils/profiling.py): patch sets built (build_patches), eval
# plans built (plan_eval / plan_eval_tiles through PUDeformer.make_plan),
# eval plans found in the cache under a caller's point-set key (the
# node's mesh data id) and PUFitPlan refits solved against kept patch
# factorizations.
for _name in ("pu.patch_sets", "pu.plans", "pu.plan_hits", "pu.fit_hits"):
    profiling.count(_name, 0)


# --------------------------------------------------------------- host build
def _median_nn(pts: np.ndarray) -> float:
    """Median nearest-neighbor distance (the local fill scale)."""
    from scipy.spatial import cKDTree

    if len(pts) < 2:
        return 1.0
    d, _ = cKDTree(pts).query(pts, k=2)
    return float(max(np.median(d[:, 1]), 1e-9))


def _kd_cells(pts: np.ndarray, cell_size: int) -> list:
    """Recursive widest-axis median splits into cells of <= cell_size:
    spatially compact cells (each an intersection of half-spaces)."""
    out: list = []

    def split(idx: np.ndarray) -> None:
        if len(idx) <= cell_size:
            out.append(idx)
            return
        p = pts[idx]
        axis = int(np.argmax(p.max(axis=0) - p.min(axis=0)))
        half = len(idx) // 2
        part = np.argpartition(p[:, axis], half)
        split(idx[part[:half]])
        split(idx[part[half:]])

    split(np.arange(len(pts), dtype=np.int64))
    return out


class PUPatches(NamedTuple):
    """Static (host-built) patch geometry; all arrays numpy."""

    centers: np.ndarray   # (K, 3) f32
    radii: np.ndarray     # (K,)  f32 support radii
    idx: np.ndarray       # (K, P) int32 control indices, -1 padded
    counts: np.ndarray    # (K,)  int32 live controls per patch
    spacing: np.ndarray   # (K,)  f32 median nearest-neighbor distance


@profiling.traced("pu.patches")
def build_patches(
    ctrl: np.ndarray, patch_size: int = 192, overlap: float = 1.3,
    width_bucket: int = 64,
) -> PUPatches:
    """kd-cells -> overlapping ball patches covering every control.

    Patch k's control set is EVERY control within R_k of its center, never
    truncated, so the padded width P is data-driven.  overlap multiplies
    each cell's bounding radius into its support radius (> 1 puts every
    control strictly inside its own cell's support).  width_bucket rounds
    P up to a multiple (default 64); the extra columns are masked padding.
    A span, pu.patches; counted in pu.patch_sets.
    """
    from scipy.spatial import cKDTree

    profiling.count("pu.patch_sets")
    bucket = max(int(width_bucket), 1)
    pad_to = lambda p: -(-p // bucket) * bucket  # noqa: E731

    ctrl = np.asarray(ctrl, np.float32)
    n = ctrl.shape[0]
    if n <= patch_size:
        centers = ctrl.mean(axis=0, keepdims=True)
        r = float(np.linalg.norm(ctrl - centers, axis=1).max()) * overlap
        idx = np.full((1, pad_to(n)), -1, np.int32)
        idx[0, :n] = np.arange(n, dtype=np.int32)
        return PUPatches(
            centers.astype(np.float32),
            np.asarray([max(r, 1e-6)], np.float32),
            idx,
            np.asarray([n], np.int32),
            np.asarray([_median_nn(ctrl)], np.float32),
        )
    slabs = _kd_cells(ctrl, patch_size)
    centers = np.stack([ctrl[s].mean(axis=0) for s in slabs])
    r_slab = np.asarray(
        [np.linalg.norm(ctrl[s] - c, axis=1).max() for s, c in zip(slabs, centers)]
    )
    radii = np.maximum(r_slab * overlap, 1e-6).astype(np.float32)
    tree = cKDTree(ctrl)
    sets = [
        np.asarray(tree.query_ball_point(c, r), np.int32)
        for c, r in zip(centers, radii)
    ]
    pmax = pad_to(max(len(s) for s in sets))
    idx = np.full((len(sets), pmax), -1, np.int32)
    for k, s in enumerate(sets):
        idx[k, : len(s)] = s
    counts = np.asarray([len(s) for s in sets], np.int32)
    spacing = np.asarray([_median_nn(ctrl[s]) for s in slabs], np.float32)
    return PUPatches(centers.astype(np.float32), radii, idx, counts, spacing)


class PUEvalPlan(NamedTuple):
    """Host-built (query-points x patches) tiling for the plain eval.

    tiles_patch[t] is the single patch tile t evaluates; tiles_vidx[t] the
    query-point rows it covers (-1 padding).  `forced` marks fallback
    items (point outside every support -> nearest patch, blend weight 1).
    """

    tiles_patch: np.ndarray  # (T,)  int32
    tiles_vidx: np.ndarray   # (T, tile_v) int32, -1 pad
    forced: np.ndarray       # (T, tile_v) f32 (1.0 = fallback item)
    num_points: int


def coverage_and_fallback(patches: PUPatches, points: np.ndarray):
    """Shared coverage/fallback policy of both plan builders (plan_eval and
    cuda_pu.plan_eval_tiles).

    Returns (per_patch_hits, covered, (uncovered_idx, picked_patch)).  At
    r -> R the Wendland weight underflows, and a point whose only weight
    underflows would read as undeformed (a seam at the coverage boundary),
    so points in the (0.9999 R, R] shell also get the nearest-patch
    fallback; a single-patch ratio W s / W equals s at any W > 0.
    """
    from scipy.spatial import cKDTree

    points = np.asarray(points, np.float32)
    v = points.shape[0]
    k_ = patches.centers.shape[0]
    tree = cKDTree(points)
    margin = 0.9999
    per_patch: list = []
    covered = np.zeros(v, bool)
    for k in range(k_):
        hits = np.asarray(
            tree.query_ball_point(patches.centers[k], patches.radii[k]),
            np.int64,
        )
        per_patch.append(hits)
        if hits.size:
            d = np.linalg.norm(points[hits] - patches.centers[k], axis=1)
            covered[hits[d <= margin * patches.radii[k]]] = True
    if covered.all():
        return per_patch, covered, (np.zeros(0, np.int64), np.zeros(0, np.int64))
    un = np.nonzero(~covered)[0]
    ctree = cKDTree(patches.centers)
    # nearest center whose ball is closest RELATIVE to its radius
    kq = min(4, k_)
    dists, nearest = ctree.query(points[un], k=kq)
    dists = np.asarray(dists).reshape(len(un), kq)
    nearest = np.asarray(nearest).reshape(len(un), kq)
    rel = dists / patches.radii[nearest]
    pick = nearest[np.arange(len(un)), rel.argmin(axis=1)]
    return per_patch, covered, (un, pick.astype(np.int64))


def patch_digest(patches: PUPatches) -> bytes:
    """Digest of what the plan builders read of the patches: the centers
    and support radii (coverage_and_fallback).  build_patches is
    deterministic in the rest rig, so a pose-only refit's patches, and the
    plans keyed on this digest, carry over."""
    h = hashlib.blake2b(digest_size=16)
    for a in (patches.centers, patches.radii):
        h.update(np.ascontiguousarray(a, np.float32).tobytes())
    return h.digest()


def plan_eval(
    patches: PUPatches, points: np.ndarray, tile_v: int = 256
) -> PUEvalPlan:
    """Assign every query point its covering patches (+ nearest-patch
    fallback when uncovered), packed into fixed-size per-patch tiles."""
    points = np.asarray(points, np.float32)
    v = points.shape[0]
    k_ = patches.centers.shape[0]
    per_patch, covered, (un, pick) = coverage_and_fallback(patches, points)
    forced_lists: list[list[int]] = [[] for _ in range(k_)]
    for vi, k in zip(un, pick):
        forced_lists[int(k)].append(int(vi))

    tiles_patch, tiles_vidx, tiles_forced = [], [], []
    for k in range(k_):
        items = list(per_patch[k]) + forced_lists[k]
        flags = [0.0] * len(per_patch[k]) + [1.0] * len(forced_lists[k])
        for i in range(0, len(items), tile_v):
            chunk_i = items[i: i + tile_v]
            chunk_f = flags[i: i + tile_v]
            pad = tile_v - len(chunk_i)
            tiles_patch.append(k)
            tiles_vidx.append(chunk_i + [-1] * pad)
            tiles_forced.append(chunk_f + [0.0] * pad)
    if not tiles_patch:  # degenerate: no patches (empty rig) — no tiles
        tiles_patch, tiles_vidx, tiles_forced = [0], [[-1] * tile_v], [[0.0] * tile_v]
    return PUEvalPlan(
        tiles_patch=np.asarray(tiles_patch, np.int32),
        tiles_vidx=np.asarray(tiles_vidx, np.int32),
        forced=np.asarray(tiles_forced, np.float32),
        num_points=v,
    )


def _lru_hit(cache: dict, key):
    """Bounded-LRU lookup: a hit re-inserts at MRU position."""
    val = cache.pop(key, None)
    if val is not None:
        cache[key] = val
    return val


def _lru_put(cache: dict, key, val, cap: int = 8) -> None:
    """Bounded-LRU insert: evict the oldest entries past `cap`."""
    cache.pop(key, None)
    while len(cache) >= cap:
        cache.pop(next(iter(cache)))
    cache[key] = val


# ------------------------------------------------------------ model + solve
class PUModel(NamedTuple):
    """Fitted PU model, every tensor on one device (kernel/term are passed
    separately).  The lo words carry the sub-f32 bits of the refined
    solves, so models cross between the two packages both ways."""

    centers: torch.Tensor  # (K, 3)
    radii: torch.Tensor    # (K,)
    ctrl: torch.Tensor     # (K, P, 3) padded patch controls
    valid: torch.Tensor    # (K, P) f32 mask
    w_hi: torch.Tensor     # (K, P, 3) local RBF weights, hi and lo words
    w_lo: torch.Tensor     # (K, P, 3)
    poly_hi: torch.Tensor  # (K, m, 3) local polynomial tails (centered basis)
    poly_lo: torch.Tensor  # (K, m, 3)
    eps: torch.Tensor      # (K,) per-patch kernel radius

    @property
    def device(self) -> torch.device:
        return self.centers.device


def _n_poly(term: PolyTerm) -> int:
    return {PolyTerm.LINEAR: 4, PolyTerm.CONSTANT: 1, PolyTerm.ZERO: 0}[
        PolyTerm(term)
    ]


def _patch_poly_basis(local: torch.Tensor, valid: torch.Tensor, term: PolyTerm):
    """(..., P, m) basis on CENTERED coordinates; padded rows zeroed."""
    m = _n_poly(term)
    if m == 0:
        return local.new_zeros(local.shape[:-1] + (0,))
    cols = [torch.ones_like(local[..., 0])]
    if m == 4:
        cols += [local[..., 0], local[..., 1], local[..., 2]]
    return torch.stack(cols, dim=-1) * valid[..., None]


def _assemble_patch(ctrl, valid, centers, kernel, term, eps, lam, tail_reg=1e-8):
    """A batch of patch saddle systems split into f32 words (a_hi, a_lo),
    (C, P + m, P + m) each, and the centered controls (C, P, 3).

    ctrl (C, P, 3), valid (C, P), centers (C, 3), eps (C,), lam (C, P).
    Coordinates are centered on the patch; phi comes in float64 from the
    f32 centered coordinates and is split into hi/lo words; the ridge is
    added to the hi word (the JAX package's double-float assembly does the
    same); padded rows/cols become identity rows (their rhs is zero, so
    their solution is 0); the tail block is -tail_reg * I.
    """
    c_, p_, _ = ctrl.shape
    local = (ctrl - centers[:, None, :]) * valid[..., None]
    l64 = local.double()
    d2 = sum((l64[:, :, None, a] - l64[:, None, :, a]) ** 2 for a in range(3))
    phi = apply_kernel(kernel, d2, eps.double()[:, None, None])
    phi_hi = phi.float()
    phi_lo = (phi - phi_hi.double()).float()
    del d2, phi
    mask2 = (valid[:, :, None] * valid[:, None, :]) > 0
    eye = torch.eye(p_, dtype=torch.float32, device=ctrl.device).expand(c_, p_, p_)
    phi_hi = torch.where(mask2, phi_hi + torch.diag_embed(lam), eye)
    phi_lo = torch.where(mask2, phi_lo, torch.zeros_like(phi_lo))
    pb = _patch_poly_basis(local, valid, term)             # (C, P, m)
    m = pb.shape[-1]
    if m == 0:
        return phi_hi, phi_lo, local
    tail = (-tail_reg * torch.eye(m, dtype=torch.float32, device=ctrl.device)).expand(c_, m, m)
    a_hi = torch.cat([torch.cat([phi_hi, pb], dim=2),
                      torch.cat([pb.transpose(1, 2), tail], dim=2)], dim=1)
    a_lo = torch.zeros_like(a_hi)
    a_lo[:, :p_, :p_] = phi_lo
    return a_hi, a_lo, local


def _nanmax0(x: torch.Tensor) -> torch.Tensor:
    """Max over axis 0 ignoring NaN (NaN where a column is all NaN)."""
    nan = torch.isnan(x)
    out = torch.where(nan, torch.full_like(x, -float("inf")), x).amax(0)
    return torch.where(nan.all(0), torch.full_like(out, float("nan")), out)


class PUFactorization(NamedTuple):
    """The pose-independent half of a PU fit (factor_pu): the patches,
    their geometry and fit settings on the device, and, where kept, every
    chunk's patch systems as solve.DFSystem (the f32 LU, the float64
    system the residuals read, the norms).  A pose enters only through
    the right-hand side (solve_pu)."""

    patches: PUPatches
    kernel: RBFKernel
    term: PolyTerm
    idx: torch.Tensor      # (K, P) int64 control rows, padding at row 0
    ctrl: torch.Tensor     # (K, P, 3) padded patch controls
    valid: torch.Tensor    # (K, P) f32 mask
    centers: torch.Tensor  # (K, 3)
    radii: torch.Tensor    # (K,)
    eps: torch.Tensor      # (K,) per-patch kernel radius
    lam: torch.Tensor      # (K, P) per-control ridge
    chunk: int             # patches assembled and solved at once
    gmres_ir: bool         # forced eps: GMRES-IR; "auto": stationary sweeps
    systems: Optional[tuple]  # each chunk's DFSystem; None: built every solve

    def chunks(self) -> list:
        return [slice(s, s + self.chunk) for s in range(0, self.idx.shape[0], self.chunk)]


def _chunk_system(fac: PUFactorization, sl: slice):
    """A chunk of patches' saddle systems, assembled (a span, pu.assemble)
    and factored (fit.factor)."""
    with profiling.span("pu.assemble"):
        a_hi, a_lo, _ = _assemble_patch(fac.ctrl[sl], fac.valid[sl], fac.centers[sl],
                                        fac.kernel, fac.term, fac.eps[sl], fac.lam[sl])
    return df_system(a_hi, a_lo, fac.gmres_ir)


def factor_pu(rest_np, patches, kernel, term, eps, lam, chunk, device, confidence=None,
              keep=False) -> PUFactorization:
    """The pose-independent half of a PU fit on `device`.  keep=True also
    assembles and factors every chunk's patch systems, where they fit
    pu_fit_budget at _KEPT_BYTES_PER_ENTRY (their working set while
    factored is one chunk's more); otherwise solve_pu builds each chunk's
    in turn, as a one-pose fit wants."""
    k_, p_ = patches.idx.shape
    safe_idx = np.maximum(patches.idx, 0)
    valid = (patches.idx >= 0).astype(np.float32)
    if confidence is not None:
        if float(lam) == 0.0:
            # lam / c stays 0 at lam = 0: confidence would be a silent no-op
            raise ValueError(
                "confidence weighting needs lam > 0 (weighted ridge "
                "lam / c); exact interpolation (lam = 0, the QNN recipe) "
                "makes it a no-op"
            )
        c = confidence_clipped(confidence, rest_np.shape[0]).numpy()
        lam_pat = (np.float32(lam) / c)[safe_idx].astype(np.float32)  # (K, P)
    else:
        lam_pat = np.full((k_, p_), float(lam), np.float32)

    if isinstance(eps, str):
        if eps != "auto":
            raise ValueError(f"eps must be a float or 'auto', got {eps!r}")
        eps_arr = (2.0 * patches.spacing).astype(np.float32)
    else:
        eps_arr = np.full(k_, float(eps), np.float32)
    # auto-eps patches are well conditioned (~2e6 at the spacing scale), so
    # stationary refinement contracts; a forced global eps can reach cond
    # ~5e10 and keeps the Krylov (GMRES-IR) correction
    gmres_ir = not isinstance(eps, str)
    entries = (p_ + _n_poly(term)) ** 2
    if chunk is None:
        chunk = max(8, int(pu_fit_budget // (entries * _FIT_BYTES_PER_ENTRY)))

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    fac = PUFactorization(
        patches, RBFKernel(kernel), PolyTerm(term), t(safe_idx).long(),
        *map(t, (rest_np[safe_idx], valid, patches.centers, patches.radii, eps_arr, lam_pat)),
        chunk=chunk, gmres_ir=gmres_ir, systems=None)
    kept = k_ * entries * (_KEPT_BYTES_PER_ENTRY + (8 if gmres_ir else 0))
    if keep and kept <= pu_fit_budget:
        fac = fac._replace(systems=tuple(_chunk_system(fac, sl) for sl in fac.chunks()))
    return fac


def solve_pu(fac: PUFactorization, delta):
    """A pose's half of a PU fit: the right-hand side gathered from the
    controls' displacements on the device (delta (N, 3), or (F, N, 3) for
    F frames in 3F columns), each chunk solved against its kept systems
    (or systems built here) by 3 sweeps of float64-residual refinement.

    Returns (PUModel built from the first 3 solution columns, aggregate
    SolveReport over every patch and column, raw (x_hi, x_lo) of shape
    (K, P + m, C) for callers that carry extra frame columns).
    """
    k_, p_ = fac.idx.shape
    m = _n_poly(fac.term)
    d = torch.as_tensor(np.ascontiguousarray(delta), device=fac.idx.device)
    if d.ndim == 2:
        rhs = d[fac.idx]                                  # (K, P, 3)
    else:
        # (F, K, P, 3) -> (K, P, F*3): frame f occupies columns 3f..3f+2
        rhs = d[:, fac.idx].permute(1, 2, 0, 3).reshape(k_, p_, 3 * d.shape[0]).contiguous()
    outs = []
    for i, sl in enumerate(fac.chunks()):
        s = fac.systems[i] if fac.systems is not None else _chunk_system(fac, sl)
        r = rhs[sl]
        b = torch.cat([r * fac.valid[sl][..., None], r.new_zeros((r.shape[0], m, r.shape[-1]))],
                      dim=1)
        outs.append(solve_df(s, b, 3))
    x_hi = torch.cat([o[0][0] for o in outs])
    x_lo = torch.cat([o[0][1] for o in outs])
    rep = SolveReport(*(torch.cat(f) for f in zip(*[o[1] for o in outs])))
    c = lambda a: a.contiguous()  # noqa: E731
    model = PUModel(
        centers=fac.centers, radii=fac.radii, ctrl=fac.ctrl, valid=fac.valid,
        w_hi=c(x_hi[:, :p_, :3]), w_lo=c(x_lo[:, :p_, :3]),
        poly_hi=c(x_hi[:, p_:, :3]), poly_lo=c(x_lo[:, p_:, :3]),
        eps=fac.eps,
    )
    # aggregate health across all patches (the leaves carry a patch axis)
    agg = SolveReport(
        residual_norm=torch.linalg.norm(rep.residual_norm.reshape(-1)),
        rhs_norm=torch.linalg.norm(rep.rhs_norm.reshape(-1)),
        # norm of the per-patch denominators: backward_error() stays a
        # normwise aggregate over the batched solves
        scale_norm=torch.linalg.norm(rep.scale_norm.reshape(-1)),
        cond_est=None,
        # per-COLUMN worst over all patches, (C,): localizes a bad solve
        # to its frame in a 3F-column shot fit
        col_backward=_nanmax0(rep.col_backward),
    )
    return model, agg, (x_hi, x_lo)


@profiling.traced("pu.fit")
def _fit_pu_once(rest_np, patches, delta, kernel, term, eps, lam, chunk, device,
                 confidence=None):
    """A one-off fit: factor_pu and solve_pu in one span, pu.fit, each
    chunk's systems built, solved and freed in turn."""
    fac = factor_pu(rest_np, patches, kernel, term, eps, lam, chunk, device, confidence)
    return solve_pu(fac, delta)


def _no_mesh(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{what}(mesh=...) shards patches across devices: multi-GPU is "
            "slice H of the port (parallel/pu_sharded.py), not ported yet"
        )


def fit_pu(
    rest_ctrl,
    deformed_ctrl,
    kernel: RBFKernel = RBFKernel.THIN_PLATE,
    term: PolyTerm = PolyTerm.LINEAR,
    eps="auto",
    lam: float = 0.01,
    patch_size: int = 192,
    overlap: float = 1.3,
    # None = auto: the largest chunk whose working set fits pu_fit_budget
    chunk: Optional[int] = None,
    patches: Optional[PUPatches] = None,
    mesh=None,
    confidence=None,
    device="cuda",
) -> tuple[PUModel, SolveReport]:
    """Fit a PU-RBF displacement model at any N on `device`.

    `confidence` ((N,) per-marker quality in (0, 1]) applies the weighted
    ridge lam_i = lam / c_i within every patch (needs lam > 0).
    eps="auto" sets each patch's kernel radius to 2x its median
    nearest-neighbor spacing and refines stationarily; a float forces one
    shared radius and refines by GMRES-IR.  `patches` may be passed in
    (callers cache them per rig); `chunk` bounds the patches solved at
    once.  mesh= (sharding across devices) raises: slice H.
    """
    _no_mesh(mesh, "fit_pu")
    rest_np = host_f32(rest_ctrl)
    delta = host_f32(deformed_ctrl) - rest_np
    if patches is None:
        patches = build_patches(rest_np, patch_size, overlap)
    model, agg, _ = _fit_pu_once(rest_np, patches, delta, kernel, term, eps, lam,
                                 chunk, device, confidence=confidence)
    return model, agg


def fit_pu_frames(
    rest_ctrl,
    deformed_frames,
    kernel: RBFKernel = RBFKernel.THIN_PLATE,
    term: PolyTerm = PolyTerm.LINEAR,
    eps="auto",
    lam: float = 0.01,
    patch_size: int = 192,
    overlap: float = 1.3,
    chunk: Optional[int] = None,
    patches: Optional[PUPatches] = None,
    mesh=None,
    confidence=None,
    device="cuda",
) -> tuple[list[PUModel], SolveReport]:
    """Fit F posed frames of one rest rig: (N, 3), (F, N, 3) -> F models.

    Every patch system depends only on the rest rig, so all F frames share
    one assembly and batched LU factorization and differ only in 3F
    right-hand-side columns (refined in 3-column blocks, so each frame's
    weights equal a single-pose fit_pu's).  Returns per-frame PUModels
    (static geometry shared by reference) and one aggregate SolveReport.
    """
    _no_mesh(mesh, "fit_pu_frames")
    rest_np = host_f32(rest_ctrl)
    frames = host_f32(deformed_frames)
    if frames.ndim != 3 or frames.shape[1:] != rest_np.shape:
        raise ValueError(
            f"deformed_frames {frames.shape} must be (F,) + rest "
            f"{rest_np.shape}"
        )
    f_n = frames.shape[0]
    if patches is None:
        patches = build_patches(rest_np, patch_size, overlap)
    p_ = patches.idx.shape[1]
    base, agg, (x_hi, x_lo) = _fit_pu_once(
        rest_np, patches, frames - rest_np[None], kernel, term, eps, lam, chunk, device,
        confidence=confidence,
    )

    def col(a, f):
        return a.reshape(a.shape[0], a.shape[1], f_n, 3)[:, :, f].contiguous()

    models = []
    for f in range(f_n):
        hi, lo = col(x_hi, f), col(x_lo, f)
        models.append(base._replace(
            w_hi=hi[:, :p_].contiguous(), w_lo=lo[:, :p_].contiguous(),
            poly_hi=hi[:, p_:].contiguous(), poly_lo=lo[:, p_:].contiguous()))
    return models, agg


# --------------------------------------------------------------- plain eval
def _tile_frame(model: PUModel, kidx, vidx, pts, num_points: int):
    """A block of tiles' centered geometry: (x, xl, local, valid) of shapes
    (B, tv, 3), (B, tv, 3), (B, P, 3), (B, P).  Shared by the value eval
    and the Jacobian so both see the same masked patch frame."""
    x = pts[torch.clamp(vidx, 0, num_points - 1)]
    valid = model.valid[kidx]
    center = model.centers[kidx][:, None, :]
    local = (model.ctrl[kidx] - center) * valid[..., None]
    return x, x - center, local, valid


def _tile_f32_disp(model: PUModel, kidx, xl, local, valid, kernel, term):
    """Plain-f32 local interpolants of a block of tiles on centered queries;
    returns (disp (B, tv, 3), phi, d2).  d2 by the expansion identity, as
    the JAX package's XLA path; the Jacobian consumes the same disp/phi."""
    with highest_precision():
        d2 = (torch.sum(xl * xl, -1)[..., None]
              - 2.0 * (xl @ local.transpose(1, 2))
              + torch.sum(local * local, -1)[:, None, :])
        d2 = torch.clamp(d2, min=0.0)
        phi = apply_kernel(kernel, d2, model.eps[kidx][:, None, None]) * valid[:, None, :]
        disp = phi @ model.w_hi[kidx] + phi @ model.w_lo[kidx]
        if model.poly_hi.shape[1]:
            pb = _patch_poly_basis(xl, torch.ones_like(xl[..., 0]), term)
            disp = disp + pb @ (model.poly_hi[kidx] + model.poly_lo[kidx])
    return disp, phi, d2


def _tile_f64_disp(model: PUModel, kidx, xl, local, valid, kernel, term):
    """Float64 local interpolants (the JAX package's double-float tiles):
    exact differences, phi, the contraction against w_hi + w_lo and the
    tail against poly_hi + poly_lo in float64, rounded to f32 once."""
    x64, l64 = xl.double(), local.double()
    d2 = sum((x64[:, :, None, a] - l64[:, None, :, a]) ** 2 for a in range(3))
    phi = apply_kernel(kernel, d2, model.eps[kidx].double()[:, None, None])
    phi = phi * valid.double()[:, None, :]
    disp = phi @ (model.w_hi[kidx].double() + model.w_lo[kidx].double())
    if model.poly_hi.shape[1]:
        pb = _patch_poly_basis(x64, torch.ones_like(x64[..., 0]), term)
        disp = disp + pb @ (model.poly_hi[kidx].double() + model.poly_lo[kidx].double())
    return disp.float()


def _tile_blend_weight(model: PUModel, kidx, xl, vidx, force):
    """Wendland partition weight with the forced-fallback and padding
    gates applied; returns (bw, d2c, r_k)."""
    d2c = torch.sum(xl * xl, -1)
    r_k = torch.clamp(model.radii[kidx], min=1e-30)[:, None]
    bw = apply_kernel(RBFKernel.WENDLAND_C2, d2c, r_k)
    bw = torch.where(force > 0, torch.ones_like(bw), bw)          # fallback items
    return torch.where(vidx >= 0, bw, torch.zeros_like(bw)), d2c, r_k  # padding


# Tiles (or tile items) per batched block of the plain evals: a block's
# (64, 256, P) f32 intermediates stay under ~40 MB at P = 576.
_TILES_PER_BLOCK = 64


def _plan_tensors(points, tiles_patch, tiles_vidx, forced):
    dev = points.device
    return (torch.as_tensor(tiles_patch, device=dev).long(),
            torch.as_tensor(tiles_vidx, device=dev).long(),
            torch.as_tensor(forced, dtype=torch.float32, device=dev))


def evaluate_pu(
    model: PUModel,
    points: torch.Tensor,
    tiles_patch,
    tiles_vidx,
    forced,
    kernel: RBFKernel,
    term: PolyTerm,
    num_points: int,
    precise: bool = True,
) -> torch.Tensor:
    """PU displacement field (V, 3) from a plan_eval() tiling, plain.

    Per block of tiles: (tile_v x P) distance -> phi -> contraction
    against each tile's patch, the Wendland blend weight, then index_add_
    over query rows normalizes the partition.  precise=True evaluates
    growing kernels (TPS/MQ/linear/cubic) in float64; otherwise, and for
    decaying kernels always, f32.
    """
    kernel = RBFKernel(kernel)
    pts = points.float()
    kp, vi, fo = _plan_tensors(pts, tiles_patch, tiles_vidx, forced)
    use64 = precise and kernel in GROWING_KERNELS
    acc_d = pts.new_zeros((num_points + 1, 3))
    acc_w = pts.new_zeros((num_points + 1,))
    for s in range(0, kp.shape[0], _TILES_PER_BLOCK):
        kidx, vidx, force = (a[s:s + _TILES_PER_BLOCK] for a in (kp, vi, fo))
        _, xl, local, valid = _tile_frame(model, kidx, vidx, pts, num_points)
        if use64:
            disp = _tile_f64_disp(model, kidx, xl, local, valid, kernel, term)
        else:
            disp, _, _ = _tile_f32_disp(model, kidx, xl, local, valid, kernel, term)
        w, _, _ = _tile_blend_weight(model, kidx, xl, vidx, force)
        seg = torch.where(vidx >= 0, vidx, num_points).reshape(-1)
        acc_d.index_add_(0, seg, (disp * w[..., None]).reshape(-1, 3))
        acc_w.index_add_(0, seg, w.reshape(-1))
    acc_d, acc_w = acc_d[:num_points], acc_w[:num_points]
    # the plan's coverage margin gives every live point a weight > ~5e-17
    # or a forced fallback item; the where keeps empty rows finite
    return torch.where((acc_w > 1e-30)[:, None],
                       acc_d / torch.clamp(acc_w, min=1e-30)[:, None],
                       torch.zeros_like(acc_d))


def jacobian_pu(
    model: PUModel,
    points: torch.Tensor,
    tiles_patch,
    tiles_vidx,
    forced,
    kernel: RBFKernel,
    term: PolyTerm,
    num_points: int,
) -> torch.Tensor:
    """Spatial Jacobian of the PU displacement field; (V, 3, 3) f32.

    s(x) = sum_k W_k s_k / sum_k W_k, so by the quotient rule

        J = [sum_k (W_k J_k + s_k (grad W_k)^T)] / SW
            - s(x) [sum_k grad W_k]^T / SW

    with J_k the local interpolant's analytic Jacobian and grad W_k the
    Wendland blend gradient (0 for forced fallback items, whose weight is
    the constant 1).  One index_add_ accumulates the four per-item
    quantities packed as 16 columns.  f32: it feeds normal transport.
    """
    kernel = RBFKernel(kernel)
    pts = points.float()
    kp, vi, fo = _plan_tensors(pts, tiles_patch, tiles_vidx, forced)
    m = model.poly_hi.shape[1]
    acc = pts.new_zeros((num_points + 1, 16))
    for s in range(0, kp.shape[0], _TILES_PER_BLOCK):
        kidx, vidx, force = (a[s:s + _TILES_PER_BLOCK] for a in (kp, vi, fo))
        _, xl, local, valid = _tile_frame(model, kidx, vidx, pts, num_points)
        disp, _, d2 = _tile_f32_disp(model, kidx, xl, local, valid, kernel, term)
        w = model.w_hi[kidx] + model.w_lo[kidx]                         # (B, P, 3)
        eps_k = model.eps[kidx][:, None, None]
        inv_e2 = 1.0 / (eps_k * eps_k)
        g = (2.0 * inv_e2) * phi_prime_s(kernel, d2 * inv_e2) * valid[:, None, :]
        with highest_precision():
            # J_k = (g @ w) xl^T - g @ (w outer local)
            sum_gw = g @ w                                              # (B, tv, 3)
            w_outer = (w[..., :, None] * local[..., None, :]).reshape(w.shape[0], -1, 9)
            t = (g @ w_outer).reshape(g.shape[0], g.shape[1], 3, 3)
        jk = sum_gw[..., :, None] * xl[..., None, :] - t
        if m >= 4:
            # centered basis [1, xl]: d(P c)_a / d x_b = c[1 + b, a]
            jk = jk + (model.poly_hi[kidx] + model.poly_lo[kidx])[:, 1:4].transpose(1, 2)[:, None]
        bw, d2c, r_k = _tile_blend_weight(model, kidx, xl, vidx, force)
        gw_scalar = (2.0 / (r_k * r_k)) * phi_prime_s(RBFKernel.WENDLAND_C2, d2c / (r_k * r_k))
        live = (vidx >= 0).float()
        gw = torch.where(force > 0, torch.zeros_like(gw_scalar), gw_scalar)[..., None] \
            * xl * live[..., None]
        num = bw[..., None, None] * jk + disp[..., :, None] * gw[..., None, :]
        packed = torch.cat([num.reshape(*num.shape[:2], 9), bw[..., None] * disp, gw,
                            bw[..., None]], dim=-1)                     # (B, tv, 16)
        seg = torch.where(vidx >= 0, vidx, num_points).reshape(-1)
        acc.index_add_(0, seg, packed.reshape(-1, 16))
    acc = acc[:num_points]
    ws = torch.clamp(acc[:, 15:16], min=1e-30)
    live = acc[:, 15] > 1e-30
    a = acc[:, :9].reshape(-1, 3, 3) / ws[:, :, None]
    sx = acc[:, 9:12] / ws                                              # s(x)
    gsum = acc[:, 12:15] / ws
    jac = a - sx[:, :, None] * gsum[:, None, :]
    return torch.where(live[:, None, None], jac, torch.zeros_like(jac))


# ------------------------------------------------------------------ facades
_BACKENDS = ("auto", "plain", "cuda")


class PUDeformer:
    """Solve-once / eval-many facade over fit_pu + the PU evals.

    Eval plans live in `plans`, a bounded LRU (8 entries: a node cook
    serves its mesh and its secondary meshes off one deformer, so one slot
    would rebuild every mesh's host plan each cook) keyed on (patch
    digest, point-set key, route).  The point-set key is the caller's id
    for the points or else a full content digest of their host bytes (a
    prefix key would reuse a stale plan for a buffer that differs only
    past the prefix).  Every frame of a PUSeqDeformer, and every refit of
    a PUFitPlan, shares one such cache.
    """

    def __init__(self, model: PUModel, patches: PUPatches,
                 kernel: RBFKernel, term: PolyTerm, auto_eps: bool = True):
        self.model = model
        self.patches = patches
        self.kernel = RBFKernel(kernel)
        self.term = PolyTerm(term)
        self.auto_eps = auto_eps
        self.report: Optional[SolveReport] = None
        self.plans: dict = {}
        self.plan_digest = patch_digest(patches)

    @property
    def device(self) -> torch.device:
        return self.model.device

    @classmethod
    def fit(cls, rest_ctrl, deformed_ctrl, kernel=RBFKernel.THIN_PLATE,
            term=PolyTerm.LINEAR, eps="auto", lam=0.01,
            patch_size=192, overlap=1.3, mesh=None,
            confidence=None, device="cuda") -> "PUDeformer":
        _no_mesh(mesh, "PUDeformer.fit")
        patches = build_patches(host_f32(rest_ctrl), patch_size, overlap)
        model, report = fit_pu(
            rest_ctrl, deformed_ctrl, kernel, term, eps, lam,
            patches=patches, confidence=confidence, device=device,
        )
        self = cls(model, patches, kernel, term, auto_eps=isinstance(eps, str))
        self.report = report
        return self

    def _points(self, points) -> torch.Tensor:
        return torch.as_tensor(points, dtype=torch.float32, device=self.device).contiguous()

    def _use_tiles(self, backend: str, precise: bool) -> bool:
        if backend not in _BACKENDS:
            # a typo must not fall through to some other path
            raise ValueError(f"unknown backend {backend!r}; expected 'auto', 'plain' or 'cuda'")
        return backend == "cuda" or (
            backend == "auto" and not precise and self.device.type == "cuda")

    def displacement(self, points, plan=None,
                     precise: Optional[bool] = None, backend: str = "auto"):
        """PU displacement at `points` (V, 3) -> (V, 3) on the model's device.

        precise=None picks the f32 eval for eps="auto" fits (well-
        conditioned local bases) and the float64 plain tiles for forced-eps
        fits (flat growing-kernel bases, large cancelling weights).

        backend: "auto" runs the CUDA tile kernel (ops/cuda_pu.py) for the
        f32 eval on a CUDA model and the plain composition otherwise;
        "plain" / "cuda" force a path ("cuda" on a CPU model runs the
        kernel's plain twin).

        plan: the plan TYPE selects the path: a cuda_pu.PUTilePlan drives
        the tile kernel (f32 only), a PUEvalPlan the plain composition.
        Passing a plan skips the content-digest lookup, which needs the
        points' host bytes; per-frame callers build the plan once.
        """
        from facedeform_tpu_torch.ops.cuda_pu import PUTilePlan

        if precise is None:
            precise = not self.auto_eps

        # Explicit plan: its type IS the path selection.
        if isinstance(plan, PUTilePlan):
            if precise:
                raise ValueError(
                    "a PUTilePlan drives the f32 CUDA tile kernel; the "
                    "float64 eval (precise=True, the default for "
                    "forced-global-eps fits) needs the plain path — pass a "
                    "plan_eval() PUEvalPlan or precise=False"
                )
            if backend == "plain":
                raise ValueError("backend='plain' cannot run a PUTilePlan")
            return self._run_tiles(points, plan)
        if isinstance(plan, PUEvalPlan):
            return self._run_plain(points, plan, precise)

        # No plan: route first, then look up or build only the plan that path needs.
        tiles = self._use_tiles(backend, precise)
        plan = self._plan(points, tiles)
        return self._run_tiles(points, plan) if tiles else self._run_plain(points, plan, precise)

    def jacobian(self, points, plan=None) -> torch.Tensor:
        """Spatial Jacobian of the PU displacement field, (V, 3, 3), by the
        plain tile composition (jacobian_pu); takes/caches a plan_eval()
        PUEvalPlan (tile plans drive the value kernel only)."""
        if plan is None:
            plan = self._plan(points, tiles=False)
        elif not isinstance(plan, PUEvalPlan):
            raise ValueError("jacobian needs a plan_eval() PUEvalPlan")
        return jacobian_pu(
            self.model, self._points(points), plan.tiles_patch, plan.tiles_vidx,
            plan.forced, self.kernel, self.term, plan.num_points,
        )

    def make_plan(self, points, backend: str = "auto"):
        """The plan displacement()'s route takes for these points (a tile
        plan for the f32 kernel route, a plain plan otherwise), from the
        cache or built into it.  `backend` mirrors displacement()'s
        forcing."""
        precise = not self.auto_eps
        if backend == "cuda" and precise:
            raise ValueError(
                "backend='cuda' drives the f32 CUDA tile kernel; a "
                "forced-global-eps fit evaluates through the float64 plain "
                "tiles — use backend='plain' or refit with eps='auto'"
            )
        return self._plan(points, self._use_tiles(backend, precise))

    def _plan(self, points, tiles: bool, points_key=None):
        """The one lookup-or-build of an eval plan.  points_key is the
        caller's id for the point set (PUNodeDeformer.apply passes the
        node's mesh data id), so a hit needs no host copy of the points;
        None keys on a digest of their bytes.  A build is a span, pu.plan,
        counted in pu.plans; a hit under the caller's key counts in
        pu.plan_hits."""
        from facedeform_tpu_torch.ops.cuda_pu import plan_eval_tiles

        keyed, points_np = points_key is not None, None
        if not keyed:
            points_np = host_f32(points)
            points_key = (points_np.shape,
                          hashlib.blake2b(points_np.tobytes(), digest_size=16).digest())
        key = (self.plan_digest, points_key, "tiles" if tiles else "plain")
        plan = _lru_hit(self.plans, key)
        if plan is not None:
            if keyed:
                profiling.count("pu.plan_hits")
            return plan
        if points_np is None:
            points_np = host_f32(points)
        profiling.count("pu.plans")
        with profiling.span("pu.plan"):
            plan = (plan_eval_tiles if tiles else plan_eval)(self.patches, points_np)
        _lru_put(self.plans, key, plan)
        return plan

    def _run_tiles(self, points, tplan):
        from facedeform_tpu_torch.ops.cuda_pu import evaluate_pu_tiles

        return evaluate_pu_tiles(self.model, self._points(points), tplan, self.kernel)

    def _run_plain(self, points, plan, precise):
        return evaluate_pu(
            self.model, self._points(points), plan.tiles_patch, plan.tiles_vidx,
            plan.forced, self.kernel, self.term, plan.num_points, precise=precise,
        )


class PUSeqDeformer:
    """Animated-sequence facade over fit_pu_frames: F posed frames of one
    rest rig, any N.  The per-frame models share every static field and the
    eval plan (it depends only on patches and query points), so a shot
    pays one host plan build however many frames it evaluates.
    """

    def __init__(self, models: list, patches: PUPatches,
                 kernel: RBFKernel, term: PolyTerm, auto_eps: bool = True):
        self.patches = patches
        self.kernel = RBFKernel(kernel)
        self.term = PolyTerm(term)
        self.auto_eps = auto_eps
        self.puds = [PUDeformer(m, patches, kernel, term, auto_eps) for m in models]
        # aggregate SolveReport: set by fit(); None when built directly
        self.report: Optional[SolveReport] = None
        for p in self.puds[1:]:
            p.plans = self.puds[0].plans   # one plan cache across all frames

    @property
    def num_frames(self) -> int:
        return len(self.puds)

    @classmethod
    def fit(cls, rest_ctrl, deformed_frames, kernel=RBFKernel.THIN_PLATE,
            term=PolyTerm.LINEAR, eps="auto", lam=0.01,
            patch_size=192, overlap=1.3, mesh=None,
            confidence=None, device="cuda") -> "PUSeqDeformer":
        _no_mesh(mesh, "PUSeqDeformer.fit")
        patches = build_patches(host_f32(rest_ctrl), patch_size, overlap)
        models, report = fit_pu_frames(
            rest_ctrl, deformed_frames, kernel, term, eps, lam,
            patches=patches, confidence=confidence, device=device,
        )
        self = cls(models, patches, kernel, term, auto_eps=isinstance(eps, str))
        self.report = report
        return self

    def displacement_frames(self, points, mesh=None) -> torch.Tensor:
        """(F, V, 3) displacements through one shared plan.

        On a CUDA model fitted with eps="auto" the whole shot runs through
        the tile kernel (cuda_pu.evaluate_pu_tiles_frames): phi and the
        partition weights once per (tile, patch) item, contracted against
        all 3F weight columns, up to 16 frames a launch.  Otherwise each
        frame evaluates through the plain tiles (float64 for forced-eps
        growing kernels).  mesh= raises: slice H.
        """
        from facedeform_tpu_torch.ops.cuda_pu import PUTilePlan, evaluate_pu_tiles_frames

        _no_mesh(mesh, "PUSeqDeformer.displacement_frames")
        pud0 = self.puds[0]
        plan = pud0.make_plan(points)
        if isinstance(plan, PUTilePlan):
            return evaluate_pu_tiles_frames(
                tuple(p.model for p in self.puds), pud0._points(points), plan, self.kernel)
        return torch.stack([p.displacement(points, plan=plan) for p in self.puds])

    def apply_seq(self, points, dist2=None, gate=None, cfg=None,
                  params=None, frame=None,
                  mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
        """((F, V, 3) positions, (V,) falloff): the falloff from capture
        distances (frame-invariant), the gate folded in, each frame's
        displacement added.  `frame` (tangentu, tangentv, N) projects each
        frame's displacement into the tangent basis before the falloff
        multiply, when cfg.tangent is set and a frame is given."""
        from facedeform_tpu_torch.config import DeformConfig, DeformParams
        from facedeform_tpu_torch.ops.falloff import falloff_weight
        from facedeform_tpu_torch.ops.tangent import project_to_tangents

        cfg = cfg or DeformConfig()
        params = (params or DeformParams()).clamped()
        dev = self.puds[0].device
        pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
        v = pts.shape[0]
        d2 = (torch.zeros(v, dtype=torch.float32, device=dev) if dist2 is None
              else torch.as_tensor(dist2, dtype=torch.float32, device=dev))
        g = (torch.ones(v, dtype=torch.float32, device=dev) if gate is None
             else torch.as_tensor(gate, dtype=torch.float32, device=dev))
        w, _ = falloff_weight(d2, params.radius, params.falloffrate,
                              strict_parity=cfg.strict_parity)
        w = w * g
        disp = self.displacement_frames(points, mesh=mesh)
        if cfg.tangent and frame is not None:
            fr = [torch.as_tensor(f, dtype=torch.float32, device=dev) for f in frame]
            disp = torch.stack([project_to_tangents(*fr, disp[f])
                                for f in range(disp.shape[0])])
        return pts[None] + disp * w[None, :, None], w


# --------------------------------------------------------------- node route
def node_fit_kwargs(cfg, params) -> dict:
    """The kernel/term/lam mapping every cfg-driven PU route shares.  QNN
    semantics are EXACT interpolation (the global solver uses lam = 0), so
    the PU route does too; only the explicit families take the user's
    ridge (otherwise the default lam = 0.1 would silently smooth the
    fit)."""
    from facedeform_tpu_torch.config import RBFModelType
    from facedeform_tpu_torch.ops import fit as fit_mod

    lam = 0.0 if cfg.model == RBFModelType.QNN else float(params.clamped().lam)
    return dict(kernel=fit_mod.effective_kernel(cfg), term=cfg.term, lam=lam)


@dataclasses.dataclass(frozen=True)
class PUNodeDeformer:
    """Deformer-compatible facade for the node path (cfg.solver == "pu").

    Exposes the contract FaceDeformNode drives (report, cfg, params,
    device, autotune_backends, apply(points, dist2, frame, group_mask,
    backend, points_key), transform_attrs, principal_stretches): the PU
    displacement field composed with the node's falloff, tangent
    projection and group gate exactly as deformer.apply_fn composes the
    global model's.
    """

    pud: PUDeformer
    cfg: object
    params: object

    @property
    def report(self):
        return self.pud.report

    @property
    def device(self) -> torch.device:
        return self.pud.device

    def autotune_backends(self, num_points: int) -> tuple:
        """The node's autotune has nothing to time: PU picks its own (tile
        kernel) path."""
        return ("auto",)

    @classmethod
    def fit(cls, rest_ctrl, deformed_ctrl, cfg, params, mesh_devices=None,
            confidence=None, device="cuda") -> "PUNodeDeformer":
        """A cold fit: the first pose of a new PUFitPlan."""
        _no_mesh(mesh_devices, "PUNodeDeformer.fit")
        return PUFitPlan(host_f32(rest_ctrl), cfg, params, confidence=confidence,
                         device=device).refit(deformed_ctrl)

    def apply(self, points, dist2=None, frame=None, group_mask=None,
              backend: str = "auto", points_key=None, mesh_devices=None):
        """((V, 3) positions, (V,) falloff) on the model's device.  backend
        "plain"/"cuda" force PUDeformer's path (each with its own plan);
        any other name ("auto", the global family's "cuda_culled", ...)
        takes the auto route.  points_key keys the eval plan (the node
        passes the mesh's position data id) instead of a digest of the
        points' bytes."""
        from facedeform_tpu_torch.ops.falloff import falloff_weight
        from facedeform_tpu_torch.ops.tangent import project_to_tangents

        _no_mesh(mesh_devices, "PUNodeDeformer.apply")
        params = self.params.clamped()
        dev = self.device
        pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
        pu_backend = backend if backend in ("plain", "cuda") else "auto"
        # the route, not the backend's name: "auto" takes a tile plan on the
        # card and a plain one on the CPU
        tiles = self.pud._use_tiles(pu_backend, precise=not self.pud.auto_eps)
        plan = self.pud._plan(points, tiles, points_key)
        disp = self.pud.displacement(pts, plan=plan, backend=pu_backend)
        if self.cfg.tangent and frame is not None:
            disp = project_to_tangents(
                *(torch.as_tensor(f, dtype=torch.float32, device=dev) for f in frame), disp)
        v = pts.shape[0]
        d2 = (torch.zeros(v, dtype=torch.float32, device=dev) if dist2 is None
              else torch.as_tensor(dist2, dtype=torch.float32, device=dev))
        w, active = falloff_weight(d2, params.radius, params.falloffrate,
                                   strict_parity=self.cfg.strict_parity)
        if group_mask is not None:
            active = active & torch.as_tensor(group_mask, dtype=torch.bool, device=dev)
        w = torch.where(active, w, torch.zeros_like(w))
        return pts + disp * w[:, None], w

    def deformed_normals(self, points, normals, weight, frame=None):
        """Transport normals through y = x + w (T) s(x); the contract of
        Deformer.deformed_normals on the PU field."""
        from facedeform_tpu_torch.ops.jacobian import transport_normals

        return transport_normals(self.pud.jacobian(points), normals, weight, self.cfg, frame)

    def transform_attrs(self, points, attrs, weight, frame=None, kinds=None,
                        want_stretch=False, f_map=None):
        """Attribute transport through the PU Jacobian: the contract of
        Deformer.transform_attrs (one Jacobian shared by all attrs and the
        stretches)."""
        from facedeform_tpu_torch.ops.jacobian import transport_attrs

        return transport_attrs(self.pud.jacobian(points), attrs, weight, self.cfg, frame,
                               kinds, want_stretch=want_stretch, f_map=f_map)

    def principal_stretches(self, points, weight, frame=None, f_map=None):
        """Singular values of the applied PU map's deformation gradient."""
        from facedeform_tpu_torch.ops.jacobian import _applied_gradient, principal_stretches

        f = _applied_gradient(self.pud.jacobian(points), weight, self.cfg, frame)
        if f_map is not None:
            f = f_map(f)
        return principal_stretches(f)


@dataclasses.dataclass
class PUFitPlan:
    """The PU route's pose-independent half (deformer.fit_route), built by
    its first fit: the rest rig's patches, their device geometry and,
    where they fit pu_fit_budget, every patch's factorization
    (`factors`, a PUFactorization), and the eval plan cache every refit's
    deformer shares (its keys hold the patch geometry's digest, so a new
    pose of the same rest rig finds its mesh's plan).  A refit gathers
    its pose's right-hand side and solves it against what is kept, so it
    equals a cold PUNodeDeformer.fit of the pose bit for bit; past the
    budget each refit refactors the kept patches."""

    rest_ctrl: np.ndarray
    cfg: object
    params: object
    confidence: object
    device: object
    plans: dict = dataclasses.field(default_factory=dict, init=False, compare=False,
                                    repr=False)
    factors: Optional[PUFactorization] = dataclasses.field(default=None, init=False,
                                                           compare=False, repr=False)

    def refit(self, deformed_ctrl) -> PUNodeDeformer:
        """The node route's fit of a pose, its eval plans kept here: the
        facade's patch defaults, eps "auto" (a per-patch shape parameter)
        and the QNN lam = 0 rule (node_fit_kwargs).  The first builds the
        patches (pu.patches) and factors; every later one counts in
        pu.fit_hits where the factors were kept.  A span, pu.fit."""
        from facedeform_tpu_torch.utils import errors

        delta = host_f32(deformed_ctrl) - self.rest_ctrl
        fac = self.factors
        patches = build_patches(self.rest_ctrl) if fac is None else fac.patches
        with profiling.span("pu.fit"):
            if fac is None:
                fac = self.factors = factor_pu(
                    self.rest_ctrl, patches, **node_fit_kwargs(self.cfg, self.params),
                    eps="auto", chunk=None, device=self.device,
                    confidence=self.confidence, keep=True)
            elif fac.systems is not None:
                profiling.count("pu.fit_hits")
            model, report, _ = solve_pu(fac, delta)
        pud = PUDeformer(model, patches, fac.kernel, fac.term, auto_eps=True)
        pud.report = report
        errors.check_solve(report)
        pud.plans = self.plans
        return PUNodeDeformer(pud=pud, cfg=self.cfg, params=self.params)
