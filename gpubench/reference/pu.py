"""The partition-of-unity (PU) fit and eval, worked out again (the float64
oracle's formulas, tests/oracle.py pu_fit_patch / pu_deform, after
Wendland 2002, "Fast evaluation of radial basis functions: methods based
on partition of unity"):

* patches, by the published rule, on the host: the controls are split into
  kd cells of at most patch_size by splitting each cell at the median of
  its widest axis; cell k's center c_k is its mean and its support radius
  R_k = overlap x the largest |x - c_k| over the cell; patch k holds every
  control within R_k of c_k; eps_k ("auto") = 2 x the median distance from
  a control of the cell to the nearest other control of the cell;
* each patch: the saddle system [[phi + lam I, P], [P^T, -1e-8 I]] [w; t] =
  [delta; 0] on coordinates centered on c_k, P = [1, x - c_k];
* the blend: s(x) = sum_k W_k s_k(x) / sum_k W_k over the patches with
  |x - c_k| <= 0.9999 R_k, W_k Wendland's C2 (1 - r)^4 (4 r + 1) of r =
  |x - c_k| / R_k; a point that no patch covers takes, alone, the local
  interpolant of the patch nearest relative to R_k among the 4 nearest
  centers.

The fit runs batched over padded patches (a padded row is an identity row
with a zero right-hand side, so its weight is 0), the eval patch by patch
over the points each patch blends, both on the card in prec's precision.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpubench.reference.prec import Prec, mm
from gpubench.reference.rbf import Kernel

#: the coverage margin: a point past 0.9999 R_k is not blended by patch k
MARGIN = 0.9999
_PAIRS = 1 << 23          # (point, control) pairs a block of the eval holds
_SYSTEMS = 64             # patch systems a batch of the fit solves


# ------------------------------------------------------------------ geometry
@dataclasses.dataclass(frozen=True)
class Patches:
    """The patch geometry of a rest rig, numpy float64."""

    centers: np.ndarray   # (K, 3)
    radii: np.ndarray     # (K,)
    members: tuple        # K arrays: each patch's control indices, ascending
    eps: np.ndarray       # (K,) the basis' radius of each patch


def _kd_cells(x: np.ndarray, size: int) -> list:
    """Index sets of <= size controls: a cell is split at the median of its
    widest axis, the lower half (by coordinate) first."""
    out = []

    def split(idx):
        if len(idx) <= size:
            out.append(np.sort(idx))
            return
        p = x[idx]
        axis = int(np.argmax(p.max(0) - p.min(0)))
        order = idx[np.argsort(p[:, axis], kind="stable")]
        half = len(idx) // 2
        split(order[:half])
        split(order[half:])

    split(np.arange(len(x)))
    return out


def _median_nn(x: np.ndarray) -> float:
    """Median distance from a point to its nearest other point."""
    d2 = ((x[:, None, :] - x[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return float(np.median(np.sqrt(d2.min(1))))


def patches(ctrl, patch_size: int, overlap: float) -> Patches:
    """The patches of a rest rig (N, 3)."""
    x = np.asarray(ctrl, np.float64)
    cells = _kd_cells(x, patch_size)
    centers = np.stack([x[c].mean(0) for c in cells])
    radii = np.asarray([max(overlap * np.sqrt(((x[c] - m) ** 2).sum(-1).max()), 1e-6)
                        for c, m in zip(cells, centers)])
    members = tuple(np.nonzero(((x - m) ** 2).sum(-1) <= r * r)[0]
                    for m, r in zip(centers, radii))
    eps = np.asarray([2.0 * _median_nn(x[c]) for c in cells])
    return Patches(centers, radii, members, eps)


# ---------------------------------------------------------------------- fit
@dataclasses.dataclass(frozen=True)
class Model:
    """The fitted patches on the card: each patch's controls (padded to the
    widest), weights and centered linear tail."""

    centers: torch.Tensor   # (K, 3)
    eps: torch.Tensor       # (K,)
    counts: list            # live controls a patch
    ctrl: torch.Tensor      # (K, W, 3), padded rows 0
    w: torch.Tensor         # (K, W, 3), padded rows 0
    tail: torch.Tensor      # (K, 4, 3): [1, x - c_k] -> displacement
    kernel: Kernel


def fit(geo: Patches, rest: torch.Tensor, pose: torch.Tensor, kernel: Kernel, lam: float,
        prec: Prec) -> Model:
    """Every patch's saddle system solved in prec.real."""
    dev, dt = rest.device, prec.real
    counts = [len(m) for m in geo.members]
    k_, width = len(counts), max(counts)
    idx = torch.zeros((k_, width), dtype=torch.long)
    live = torch.zeros((k_, width), dtype=torch.bool)
    for k, m in enumerate(geo.members):
        idx[k, :len(m)] = torch.as_tensor(m)
        live[k, :len(m)] = True
    idx, live = idx.to(dev), live.to(dev)
    x, delta = rest.to(dt), pose.to(dt) - rest.to(dt)
    centers = torch.as_tensor(geo.centers, device=dev).to(dt)
    eps = torch.as_tensor(geo.eps, device=dev).to(dt)
    ctrl = x[idx] * live[..., None]
    eye_w = torch.eye(width, dtype=dt, device=dev)
    w_all, tails = [], []
    for lo in range(0, k_, _SYSTEMS):
        sl = slice(lo, lo + _SYSTEMS)
        n = ctrl[sl].shape[0]
        lv = live[sl].to(dt)
        local = (ctrl[sl] - centers[sl, None]) * lv[..., None]
        d2 = sum((local[:, :, None, a] - local[:, None, :, a]) ** 2 for a in range(3))
        both = (lv[:, :, None] * lv[:, None, :]) > 0
        phi = torch.where(both, kernel.phi(d2 / (eps[sl] ** 2)[:, None, None]) + lam * eye_w,
                          eye_w.expand(n, width, width))
        p = torch.cat([lv[..., None], local], -1)                      # (n, W, 4)
        a = torch.cat([torch.cat([phi, p], 2),
                       torch.cat([p.transpose(1, 2),
                                  -1e-8 * torch.eye(4, dtype=dt, device=dev).expand(n, 4, 4)],
                                 2)], 1)
        b = torch.cat([delta[idx[sl]] * lv[..., None],
                       torch.zeros((n, 4, 3), dtype=dt, device=dev)], 1)
        sol = torch.linalg.solve(a, b)
        w_all.append(sol[:, :width])
        tails.append(sol[:, width:])
    return Model(centers=centers, eps=eps, counts=counts, ctrl=ctrl, w=torch.cat(w_all),
                 tail=torch.cat(tails), kernel=kernel)


# --------------------------------------------------------------------- blend
def _cover(geo: Patches, points: torch.Tensor, dtype):
    """Per block of points: (first row, distances over radii (B, K), the
    rows that no patch covers and each one's fallback patch)."""
    dev = points.device
    centers = torch.as_tensor(geo.centers, device=dev).to(dtype)
    radii = torch.as_tensor(geo.radii, device=dev).to(dtype)
    k_ = len(radii)
    rows = max(1, (1 << 24) // k_)
    for lo in range(0, points.shape[0], rows):
        d = points[lo:lo + rows].to(dtype)[:, None, :] - centers[None]
        d2 = (d * d).sum(-1)
        rel = torch.sqrt(d2) / radii[None]
        un = torch.nonzero(~(rel <= MARGIN).any(1))[:, 0]
        near = torch.topk(d2[un], min(4, k_), dim=1, largest=False).indices
        pick = near.gather(1, rel[un].gather(1, near).argmin(1, keepdim=True))[:, 0]
        yield lo, rel, un, pick


def blend_pairs(geo: Patches, points: torch.Tensor, dtype) -> tuple:
    """(point, weight) of every term of the blend, sorted by patch, and the
    terms a patch: the covered points' Wendland weights and each uncovered
    point's fallback patch at weight 1."""
    vert, patch, wgt = [], [], []
    for lo, rel, un, pick in _cover(geo, points, dtype):
        v, k = torch.nonzero(rel <= MARGIN, as_tuple=True)
        r = rel[v, k]
        vert += [v + lo, un + lo]
        patch += [k, pick]
        wgt += [(1.0 - r) ** 4 * (4.0 * r + 1.0), torch.ones_like(un, dtype=dtype)]
    vert, patch, wgt = torch.cat(vert), torch.cat(patch), torch.cat(wgt)
    order = torch.argsort(patch, stable=True)
    return vert[order], wgt[order], torch.bincount(patch, minlength=len(geo.radii)).tolist()


def evaluate(model: Model, pairs: tuple, points: torch.Tensor, prec: Prec) -> torch.Tensor:
    """(V, 3) displacements: each patch's local interpolant at the points it
    blends, weighted, summed and divided by the summed weights."""
    vert, wgt, terms = pairs
    dt = prec.real
    pts = points.to(dt)
    num = torch.zeros((pts.shape[0], 3), dtype=dt, device=pts.device)
    den = torch.zeros(pts.shape[0], dtype=dt, device=pts.device)
    at = 0
    for k, hits in enumerate(terms):
        n = model.counts[k]
        ctrl, w, tail = model.ctrl[k, :n], model.w[k, :n], model.tail[k]
        inv = 1.0 / (model.eps[k] * model.eps[k])
        step = max(256, _PAIRS // max(1, n))
        for lo in range(at, at + hits, step):
            hi = min(lo + step, at + hits)
            rows, g = vert[lo:hi], wgt[lo:hi].to(dt)
            x = pts[rows]
            d = x[:, None, :] - ctrl[None]
            phi = model.kernel.phi((d * d).sum(-1) * inv)
            xt = torch.cat([torch.ones_like(x[:, :1]), x - model.centers[k]], 1)
            s = mm(phi, w, prec.tf32) + mm(xt, tail, prec.tf32)
            num.index_add_(0, rows, g[:, None] * s)
            den.index_add_(0, rows, g)
        at += hits
    return num / den[:, None]


def needed_pairs(geo: Patches, points: torch.Tensor) -> int:
    """The (point, control) pairs the eval needs: for each point the live
    controls of every patch whose support holds it (|x - c_k| <= R_k), and
    of its fallback patch where no patch covers it."""
    live = torch.as_tensor([float(len(m)) for m in geo.members], device=points.device,
                           dtype=torch.float64)
    total = 0.0
    for _, rel, _, pick in _cover(geo, points, torch.float64):
        total += float(((rel <= 1.0).double() @ live).sum() + live[pick].sum())
    return int(total)
