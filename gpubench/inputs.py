"""Inputs of a run, all made from --seed: the mesh, the rig, the blendshapes
and the poses.  Both the program and the reference receive these and
nothing the other side made.

Each input draws from its own stream, numpy's SeedSequence of (seed,
stream), so adding draws to one stream never moves another; any whole
number is a valid seed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# One stream per input (SeedSequence spawn keys).
STREAM_SHAPES, STREAM_POSE, STREAM_DRAGS, STREAM_SLIDER = 1, 2, 3, 4
STREAM_SHOTS, STREAM_SAMPLE, STREAM_WARMUP = 5, 6, 7


def rng(seed: int, stream: int, *more: int) -> np.random.Generator:
    """The generator of one stream; negative keys wrap to 64 bits."""
    return np.random.default_rng([int(k) & (2**64 - 1) for k in (seed, stream, *more)])


def uv_sphere(n_u: int, n_v: int) -> tuple[np.ndarray, np.ndarray]:
    """(points (V, 3) f32, quad faces (F, 4) int32) of a unit UV sphere with
    n_u * n_v interior vertices and two poles; triangles at the poles
    repeat their last index.  A copy of
    facedeform_tpu_torch/geometry/primitives.uv_sphere."""
    theta = np.linspace(0.0, np.pi, n_v + 2)[1:-1]
    phi = np.linspace(0.0, 2.0 * np.pi, n_u, endpoint=False)
    t, p = np.meshgrid(theta, phi, indexing="ij")
    pts = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)],
                   axis=-1).reshape(-1, 3)
    points = np.concatenate([pts, [[0.0, 1.0, 0.0]], [[0.0, -1.0, 0.0]]]).astype(np.float32)
    ni, si = len(pts), len(pts) + 1
    i, j = np.meshgrid(np.arange(n_v - 1), np.arange(n_u), indexing="ij")
    jn = (j + 1) % n_u
    quads = np.stack([i * n_u + j, i * n_u + jn, (i + 1) * n_u + jn, (i + 1) * n_u + j],
                     axis=-1).reshape(-1, 4)
    j = np.arange(n_u)
    jn = (j + 1) % n_u
    last = (n_v - 1) * n_u
    north = np.stack([np.full(n_u, ni), jn, j, j], axis=-1)
    south = np.stack([np.full(n_u, si), last + j, last + jn, last + jn], axis=-1)
    tris = np.stack([north, south], axis=1).reshape(-1, 4)
    return points, np.concatenate([quads, tris]).astype(np.int32)


def fibonacci_points(n: int) -> np.ndarray:
    """n near-uniform points on the unit sphere, (n, 3) f32.  A copy of
    facedeform_tpu_torch/geometry/primitives.fibonacci_points."""
    i = np.arange(n, dtype=np.float64) + 0.5
    ga = np.pi * (3.0 - np.sqrt(5.0))
    y = 1.0 - 2.0 * i / n
    r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    th = ga * i
    return np.stack([r * np.cos(th), y, r * np.sin(th)], axis=-1).astype(np.float32)


def octants(x: np.ndarray) -> np.ndarray:
    """Marker class = octant, 8 classes.  A copy of chip_smoke._octants."""
    return ((x[:, 0] > 0).astype(np.int32) + 2 * (x[:, 1] > 0).astype(np.int32)
            + 4 * (x[:, 2] > 0).astype(np.int32))


def bump_shapes(points: torch.Tensor, n: int, radius: float, amplitude: float,
                seed: int) -> torch.Tensor:
    """(n, V, 3) f32 blendshapes on points' device: smooth normal bumps at
    seeded sites among 4n Fibonacci points.  After chip_smoke._bump_shapes,
    drawn from the seed and computed on the card in one pass a shape."""
    g = rng(seed, STREAM_SHAPES)
    sites = fibonacci_points(4 * n)[g.choice(4 * n, n, replace=False)]
    sites = torch.as_tensor(sites, device=points.device)
    normal = points / torch.linalg.norm(points, dim=1, keepdim=True)
    out = torch.empty((n,) + tuple(points.shape), dtype=torch.float32, device=points.device)
    for k in range(n):
        bump = torch.exp(-((points - sites[k]) ** 2).sum(-1) / (radius * radius))
        out[k] = points + amplitude * bump[:, None] * normal
    return out


@dataclasses.dataclass(frozen=True)
class Waves:
    """A smooth seeded rig motion: travelling waves over the rig,
    d(x, t) = amplitude * sum_k a_k cos(k_k . x - 2 pi nu_k t + phi_k)."""

    k: np.ndarray       # (K, 3) wave vectors
    a: np.ndarray       # (K, 3) directions, E|sum|^2 ~ 1/2
    nu: np.ndarray      # (K,) Hz
    phi: np.ndarray     # (K,)
    amplitude: float

    @classmethod
    def draw(cls, g: np.random.Generator, amplitude: float, harmonics: int,
             wavenumber: float) -> "Waves":
        return cls(k=g.normal(0.0, wavenumber, (harmonics, 3)),
                   a=g.normal(0.0, 1.0 / np.sqrt(3.0 * harmonics), (harmonics, 3)),
                   nu=g.uniform(0.5, 2.0, harmonics), phi=g.uniform(0.0, 2 * np.pi, harmonics),
                   amplitude=float(amplitude))

    def at(self, rest: np.ndarray, t, device="cpu") -> torch.Tensor:
        """(T, N, 3) f32 poses at times t (s), worked in float64 on `device`
        (on the card a shot's 48 poses take well under a millisecond)."""
        def f64(x):
            return torch.as_tensor(np.asarray(x, np.float64), device=device)

        r = f64(rest)
        arg = (r @ f64(self.k).T)[None] - 2 * np.pi * f64(t)[:, None, None] * f64(self.nu) \
            + f64(self.phi)
        d = torch.cos(arg) @ f64(self.a)                          # (T, N, 3)
        return (r[None] + self.amplitude * d).float()


def start_pose(rest: np.ndarray, pose: dict, seed: int) -> np.ndarray:
    """The pose a drag or slider cell starts from: the rig under a seeded
    smooth motion at t = 0."""
    w = Waves.draw(rng(seed, STREAM_POSE), pose["amplitude"], pose["harmonics"],
                   pose["wavenumber"])
    return w.at(rest, np.zeros(1))[0].numpy()


def shot_poses(rest: np.ndarray, pose: dict, frames: int, fps: float, seed: int,
               shot: int, device="cpu") -> torch.Tensor:
    """(frames, N, 3) poses of shot number `shot` on `device`: its own
    smooth seeded trajectory, sampled at fps."""
    w = Waves.draw(rng(seed, STREAM_SHOTS, shot), pose["amplitude"], pose["harmonics"],
                   pose["wavenumber"])
    return w.at(rest, np.arange(frames) / fps, device)


def drags(start: np.ndarray, moved: int, sigma: float, g: np.random.Generator):
    """Marker drags: each moves `moved` markers of the last pose by
    N(0, sigma) per axis.  After chip_smoke.main_path_node's generator."""
    pose = start
    while True:
        pose = pose.copy()
        idx = g.choice(len(pose), moved, replace=False)
        pose[idx] += (sigma * g.standard_normal((moved, 3))).astype(np.float32)
        yield pose


@dataclasses.dataclass
class Scene:
    """The inputs every cell of one configuration shares, as a scene file
    (scenes/<scene>.py, named by the configuration) makes them."""

    points: np.ndarray            # (V, 3) f32 rest mesh
    faces: np.ndarray             # (F, 4) int32
    normals: np.ndarray           # (V, 3) f32 rest normals
    rest: np.ndarray              # (N, 3) f32 rest rig
    classes: np.ndarray           # (N,) int32 marker classes
    shapes: Optional[np.ndarray]  # (S, V, 3) f32 blendshapes, or None
