"""Blendshape basis extraction: PCA of a deformed shot (port of
facedeform_tpu/ops/blendshapes.py).

Bake F frames of deformed positions down to K morph targets plus per-frame
weight curves.  A rank-K bake is the L2-optimal K-target approximation of
the shot (Eckart-Young), costs O(K V) bytes, and `blendshape_meshes()`
turns it into the blendshape inputs the morph-space (DBSE) pass consumes
(src/dbse.cpp:9-35), which the reference consumes but never produces.

The displacement matrix D is (F, 3V): 3V runs to millions while F is a few
hundred at most, so the factorization takes the Gram route as in the JAX
package: G = D D^T (F, F) is one large matmul on the device (accumulated
in float64 here, see _gram_eigh), its symmetric eigendecomposition runs on
the host in float64, and the basis B = D^T U S^-1 is a second large f32
matmul.  Every f32 matmul runs inside utils.precision.highest_precision()
(no TF32).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from facedeform_tpu_torch.utils.precision import highest_precision


class BlendshapeModel(NamedTuple):
    """A baked morph-target basis for one rest mesh.

    Frame f reconstructs as ``rest + weights[f] @ targets``.  Targets are
    rest-relative deltas, scaled so every weight lies in [-1, 1]; when the
    bake was centered, target 0 is the mean displacement and its weight
    column is identically 1.
    """

    rest: torch.Tensor      # (V, 3) f32
    targets: torch.Tensor   # (K, V, 3) f32 rest-relative deltas
    weights: torch.Tensor   # (F, K) f32 per-frame weight curves

    @property
    def n_targets(self) -> int:
        return int(self.targets.shape[0])

    @property
    def n_frames(self) -> int:
        return int(self.weights.shape[0])

    def target_names(self) -> List[str]:
        names = [f"pc_{k:03d}" for k in range(self.n_targets)]
        if bool(self.weights.shape[0]) and self.n_targets:
            w0 = self.weights[:, 0].cpu().numpy()
            if np.allclose(w0, 1.0):
                names[0] = "mean"
        return names


class BlendshapeReport(NamedTuple):
    """Quality of a rank-K bake, measured against the input frames."""

    rmse: float            # RMS vertex-position error over all frames
    max_err: float         # max |reconstructed - input| over all frames
    energy: float          # fraction of displacement energy captured [0, 1]
    singular_values: np.ndarray  # full spectrum of the (centered) deltas

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.rmse))


# Columns of D per float64 Gram chunk: the (F, chunk) float64 copy stays
# small whatever the shot's length.
_GRAM_CHUNK = 1 << 20


def _gram_eigh(d_flat: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """Eigendecomposition of D D^T: (s, u) with s descending, the singular
    values and left singular vectors of D.  The (F, 3V) x (3V, F) product
    runs on D's device and accumulates in float64: an f32 Gram (the JAX
    package's, at HIGHEST precision) carries an absolute error of order
    u ||D||^2, a relative error of order u (s_max / s_i)^2 on the smaller
    singular values, which reached 2.8e-4 on a 90k-vertex 8-pose shot
    (measured on the CPU); the H100 has native fp64 for the F^2 V products.  The
    (F, F) eigh runs on the host in float64."""
    g64 = sum(c.double() @ c.double().T for c in torch.split(d_flat, _GRAM_CHUNK, dim=1))
    g64 = g64.cpu().numpy()
    g64 = 0.5 * (g64 + g64.T)
    eigval, eigvec = np.linalg.eigh(g64)
    order = np.argsort(eigval)[::-1]
    eigval = np.maximum(eigval[order], 0.0)
    return np.sqrt(eigval), eigvec[:, order]


def fit_blendshapes(
    rest,
    frame_points,
    rank: int,
    center: bool = True,
    mesh=None,
    device="cuda",
) -> tuple[BlendshapeModel, BlendshapeReport]:
    """Bake a shot to a rank-`rank` morph-target basis on `device`.

    rest:          (V, 3) rest positions the targets are relative to.
    frame_points:  (F, V, 3) deformed positions (a cooked shot).
    rank:          number of PCA targets to keep (clamped to [1, F]).
    center:        if True (default), the mean displacement is split off
                   as an always-on target 0 (weight column == 1) and the
                   PCA runs on the residual; the model then has rank + 1
                   targets (unless the mean is exactly zero).
    mesh:          multi-device sharding, not ported yet (slice H).

    Returns (BlendshapeModel, BlendshapeReport).
    """
    if mesh is not None:
        raise NotImplementedError(
            "fit_blendshapes(mesh=...) shards the (F, 3V) slab across "
            "devices: multi-GPU is slice H of the port "
            "(parallel/blendshapes_sharded.py), not ported yet")
    rest = torch.as_tensor(rest, dtype=torch.float32, device=device)
    frames = torch.as_tensor(frame_points, dtype=torch.float32, device=device)
    if frames.ndim != 3 or frames.shape[-1] != 3:
        raise ValueError(f"frame_points must be (F, V, 3), got {tuple(frames.shape)}")
    if rest.shape != frames.shape[1:]:
        raise ValueError(
            f"rest {tuple(rest.shape)} does not match frames {tuple(frames.shape[1:])}"
        )
    f_n, v = int(frames.shape[0]), int(frames.shape[1])
    if f_n < 1:
        raise ValueError("need at least one frame")
    rank = max(1, min(int(rank), f_n))

    d_flat = (frames - rest[None]).reshape(f_n, 3 * v)       # (F, 3V)
    mean_flat = None
    if center:
        # centering by an exactly-zero mean is a no-op, so always
        # subtract and decide on the mean target afterwards
        mean_flat = torch.mean(d_flat, dim=0)                 # (3V,)
        mean_max = torch.max(torch.abs(mean_flat))
        d_flat = d_flat - mean_flat[None]

    s, u = _gram_eigh(d_flat)                                 # (F,), (F, F) float64
    # an exactly-zero mean (a symmetric oscillation around rest) would add
    # an all-zero target: skip it then
    mean_target = mean_flat if center and float(mean_max) > 0.0 else None

    # dead-mode guard: trailing singular values at roundoff would blow up
    # the basis; keep the modes above f32-eps relative energy, at least one
    s_max = float(s[0]) if s.size else 0.0
    alive = int(np.sum(s > max(s_max, 1e-30) * 1e-7))
    k = max(1, min(rank, max(alive, 1)))

    u_k = torch.as_tensor(u[:, :k], dtype=torch.float32, device=device)   # (F, k)
    inv_s = torch.as_tensor(
        np.where(s[:k] > 0.0, 1.0 / np.maximum(s[:k], 1e-30), 0.0),
        dtype=torch.float32, device=device)
    with highest_precision():
        # basis column j = D^T u_j / s_j
        basis = d_flat.T @ (u_k * inv_s[None, :])
    w = u_k * torch.as_tensor(s[:k], dtype=torch.float32, device=device)[None, :]

    # scale each target so its weight curve spans [-1, 1]
    scale = torch.clamp(torch.amax(torch.abs(w), dim=0), min=1e-30)      # (k,)
    targets = (basis * scale[None, :]).T.reshape(k, v, 3)
    weights = w / scale[None, :]

    if mean_target is not None:
        targets = torch.cat([mean_target.reshape(1, v, 3), targets], dim=0)
        weights = torch.cat(
            [torch.ones((f_n, 1), dtype=torch.float32, device=device), weights], dim=1)

    model = BlendshapeModel(rest=rest, targets=targets.contiguous(), weights=weights)

    err = apply_blendshapes(model) - frames
    rmse = float(torch.sqrt(torch.mean(torch.sum(err * err, dim=-1))))
    max_err = float(torch.max(torch.abs(err)))
    total = float(np.sum(s * s))
    energy = 1.0 if total == 0.0 else float(np.sum(s[:k] * s[:k]) / total)
    report = BlendshapeReport(
        rmse=rmse, max_err=max_err, energy=min(energy, 1.0),
        singular_values=np.asarray(s, np.float64),
    )
    return model, report


def apply_blendshapes(
    model: BlendshapeModel, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Reconstruct positions (F, V, 3) from weight rows (F, K), by default
    the model's own fitted curves: one (F, K) x (K, 3V) matmul."""
    dev = model.rest.device
    w = model.weights if weights is None else torch.as_tensor(
        weights, dtype=torch.float32, device=dev)
    if w.ndim == 1:
        w = w[None]
    k, v = model.targets.shape[0], model.targets.shape[1]
    if w.shape[-1] != k:
        raise ValueError(f"weights have {w.shape[-1]} columns, model has {k}")
    with highest_precision():
        flat = (w @ model.targets.reshape(k, 3 * v)).reshape(-1, v, 3)
    return model.rest[None] + flat


def blendshape_meshes(model: BlendshapeModel, mesh) -> List:
    """Materialize the baked targets as blendshape meshes (rest + delta),
    one Mesh per target sharing `mesh`'s topology: the shape of the
    reference's blendshape inputs 3+ (src/SOP_FaceDeform.cpp:201-204,
    consumed by DirectBSEdit at src/dbse.cpp:18-30)."""
    if mesh.num_points != int(model.rest.shape[0]):
        raise ValueError(
            f"mesh has {mesh.num_points} points, model rest has "
            f"{int(model.rest.shape[0])}"
        )
    rest = model.rest.cpu().numpy()
    targets = model.targets.cpu().numpy()
    out = []
    for k in range(model.n_targets):
        m = mesh.copy()
        m.set_points(rest + targets[k])
        out.append(m)
    return out
