"""Procedural test geometry: spheres, grids and Fibonacci rigs (numpy).

Same points and faces as facedeform_tpu/geometry/primitives.py; the face
tables are built with array ops instead of Python loops, so the
1M-vertex benchmark sphere takes well under a second.
"""

from __future__ import annotations

import numpy as np

from facedeform_tpu_torch.geometry.mesh import Mesh


def uv_sphere(n_u: int = 100, n_v: int = 100, radius: float = 1.0) -> Mesh:
    """Quad-faced UV sphere with n_u * n_v interior vertices + 2 poles."""
    theta = np.linspace(0.0, np.pi, n_v + 2)[1:-1]          # exclude poles
    phi = np.linspace(0.0, 2.0 * np.pi, n_u, endpoint=False)
    t, p = np.meshgrid(theta, phi, indexing="ij")            # (n_v, n_u)
    pts = np.stack(
        [np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)], axis=-1
    ).reshape(-1, 3) * radius
    north = np.array([[0.0, radius, 0.0]])
    south = np.array([[0.0, -radius, 0.0]])
    points = np.concatenate([pts, north, south], axis=0).astype(np.float32)
    ni, si = len(pts), len(pts) + 1

    i, j = np.meshgrid(np.arange(n_v - 1), np.arange(n_u), indexing="ij")
    jn = (j + 1) % n_u
    quads = np.stack(
        [i * n_u + j, i * n_u + jn, (i + 1) * n_u + jn, (i + 1) * n_u + j],
        axis=-1,
    ).reshape(-1, 4)
    j = np.arange(n_u)
    jn = (j + 1) % n_u
    last = (n_v - 1) * n_u
    north_tri = np.stack([np.full(n_u, ni), jn, j, j], axis=-1)
    south_tri = np.stack([np.full(n_u, si), last + j, last + jn, last + jn], axis=-1)
    # triangles interleave north/south per column, degenerate 4th index
    tris = np.stack([north_tri, south_tri], axis=1).reshape(-1, 4)
    faces = np.concatenate([quads, tris]).astype(np.int32)
    return Mesh(points=points, faces=faces)


def grid(nx: int = 100, ny: int = 100, size: float = 2.0) -> Mesh:
    """Planar quad grid in the XZ plane centered at origin."""
    xs = np.linspace(-size / 2, size / 2, nx)
    zs = np.linspace(-size / 2, size / 2, ny)
    x, z = np.meshgrid(xs, zs, indexing="ij")
    pts = np.stack([x, np.zeros_like(x), z], axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
    a = (i * ny + j).reshape(-1)
    quads = np.stack([a, a + 1, a + ny + 1, a + ny], axis=-1)
    return Mesh(points=pts.astype(np.float32), faces=quads.astype(np.int32))


def fibonacci_points(n: int, radius: float = 1.0, seed: int = 0) -> np.ndarray:
    """N near-uniform points on a sphere (control-rig stand-in); (N, 3) f32."""
    i = np.arange(n, dtype=np.float64) + 0.5
    ga = np.pi * (3.0 - np.sqrt(5.0))
    y = 1.0 - 2.0 * i / n
    r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    th = ga * i
    pts = np.stack([r * np.cos(th), y, r * np.sin(th)], axis=-1) * radius
    return pts.astype(np.float32)
