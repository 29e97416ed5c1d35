"""Closest-point distance queries on the device (port of
facedeform_tpu/ops/distances.py): capture's distance half.

The reference computes, per captured vertex, the squared distance to the
nearest rig primitive through HDK's GU_RayIntersect::minimumPoint
(capture.cpp:77-88).  As in the JAX package, that irregular per-vertex
query becomes dense math over all (vertex, primitive) pairs, chunked over
the vertices:

  * point rigs    -> min over pairwise squared distances, taken from exact
    per-coordinate differences (never the ||x||^2 + ||y||^2 - 2 x.y
    expansion, which cancels in f32 away from the origin);
  * triangle rigs -> the closed-form (Eberly) point-to-triangle distance
    over all pairs.

The JAX package's *_auto variants run small queries on the host and pad
the vertex count to 65536-row buckets, because XLA recompiles for every
new shape and capture's vertex count changes with every radius/maxedges
tweak.  Eager PyTorch compiles nothing per shape, so here the *_auto
names are the one device path, kept so capture.py reads like its
counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from facedeform_tpu_torch.ops.kernels import pairwise_sqdist
from facedeform_tpu_torch.utils import profiling

# Elements of one chunk's (vertices, primitives) temporaries: 64 MiB of
# f32 each, so a chunk's working set stays a few hundred MiB.
_CHUNK_ELEMS = 1 << 24


def _rows(n_prims: int, elems: int = _CHUNK_ELEMS) -> int:
    return max(1, elems // max(int(n_prims), 1))


def min_sqdist_to_points(points: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(V,) min squared distance from each point to any target point, on
    the points' device."""
    points = points.float()
    targets = targets.float().to(points.device)
    if points.shape[0] == 0:
        return points.new_zeros(0)
    step = _rows(targets.shape[0])
    return torch.cat([torch.amin(pairwise_sqdist(p, targets), dim=-1)
                      for p in torch.split(points, step)])


def _point_triangle_sqdist(p: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """Squared distances from points (C, 3) to triangles (T, 3, 3) -> (C, T).

    Branch-free Eberly closest-point-on-triangle: the interior barycentric
    point, overridden by the edge and then the vertex regions, in the JAX
    package's order."""
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]            # (T, 3)
    ab, ac = b - a, c - a
    p = p[:, None, :]                                        # (C, 1, 3)
    ap, bp, cp = p - a, p - b, p - c                         # (C, T, 3)
    d1 = torch.sum(ab * ap, -1)
    d2 = torch.sum(ac * ap, -1)
    d3 = torch.sum(ab * bp, -1)
    d4 = torch.sum(ac * bp, -1)
    d5 = torch.sum(ab * cp, -1)
    d6 = torch.sum(ac * cp, -1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = torch.clamp(va + vb + vc, min=1e-30)
    v = (vb / denom)[..., None]
    w = (vc / denom)[..., None]
    closest = a + v * ab + w * ac                            # interior case

    t_ab = torch.clamp(d1 / torch.clamp(d1 - d3, min=1e-30), 0.0, 1.0)[..., None]
    t_ac = torch.clamp(d2 / torch.clamp(d2 - d6, min=1e-30), 0.0, 1.0)[..., None]
    t_bc = torch.clamp(
        (d4 - d3) / torch.clamp((d4 - d3) + (d5 - d6), min=1e-30), 0.0, 1.0
    )[..., None]
    closest = torch.where(((va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0))[..., None],
                          b + t_bc * (c - b), closest)
    closest = torch.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None],
                          a + t_ac * ac, closest)
    closest = torch.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None],
                          a + t_ab * ab, closest)
    closest = torch.where(((d6 >= 0) & (d5 <= d6))[..., None], c, closest)
    closest = torch.where(((d3 >= 0) & (d4 <= d3))[..., None], b, closest)
    closest = torch.where(((d1 <= 0) & (d2 <= 0))[..., None], a, closest)
    diff = p - closest
    return torch.sum(diff * diff, -1)


def min_sqdist_to_triangles(points: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """(V,) min squared distance from each point to any triangle of tris
    (T, 3, 3), on the points' device; chunked over V so that a chunk's
    (chunk, T, 3) temporaries stay small."""
    points = points.float()
    tris = tris.float().to(points.device)
    if points.shape[0] == 0:
        return points.new_zeros(0)
    # the (C, T, 3) temporaries hold 3 elements a pair
    step = _rows(3 * tris.shape[0])
    return torch.cat([torch.amin(_point_triangle_sqdist(p, tris), dim=-1)
                      for p in torch.split(points, step)])


def min_sqdist_to_points_auto(points, targets, device="cuda") -> np.ndarray:
    """min_sqdist_to_points on `device` for host arrays; returns numpy
    (V,) f32, as capture (host-side) consumes it."""
    p = profiling.to_device(np.asarray(points, np.float32), device)
    t = profiling.to_device(np.asarray(targets, np.float32), device)
    return profiling.to_host(min_sqdist_to_points(p, t)).numpy()


def min_sqdist_to_triangles_auto(points, tris, device="cuda") -> np.ndarray:
    """min_sqdist_to_triangles on `device` for host arrays; returns numpy
    (V,) f32, clamped at 0 as the JAX package's host path is."""
    p = profiling.to_device(np.asarray(points, np.float32), device)
    t = profiling.to_device(np.asarray(tris, np.float32), device)
    return profiling.to_host(torch.clamp(min_sqdist_to_triangles(p, t), min=0.0)).numpy()
