"""ProximityCapture: bind mesh regions to rig markers (component E).

Port of facedeform_tpu/capture/capture.py: the KD-tree, the adjacency, the
flood and the geodesic distances stay on the host (native fastgeo, else
scipy); the euclidean distances run on `device` (ops/distances.py).

Pipeline mirroring capture.cpp:

  init (capture.cpp:10-44)      -> build KD-tree over mesh points, adjacency
                                   over mesh edges (GEO_PointTree + GQ_Detail
                                   equivalents; here scipy cKDTree + CSR).
  findIslands (capture.cpp:107-141)
                                -> nearest mesh vertex per marker, flood fill
                                   max_edges rings, grouped by rig `class`.
  capture (capture.cpp:46-105)  -> per captured vertex: squared distance to
                                   the nearest rig primitive (device-side
                                   dense query instead of GU_RayIntersect),
                                   plus the falloff color visualization.

Split of labor: irregular graph/tree work on host (numpy/scipy), the dense
euclidean distance math on the device (ops.distances).

Distance semantics (and the reference's quirks, SURVEY.md section 2):
  * dofalloff off  -> captured vertices get dist2 = 0 (full deformation,
    capture.cpp:71-75).
  * dofalloff on   -> dist2 = squared distance to nearest rig prim.  The
    reference leaves -1 where the radius-bounded search failed
    (capture.cpp:76-88) which *amplifies* deformation downstream (quirk 2).
    Default mode stores the true unbounded distance instead (vertices
    beyond radius freeze via the d2 > r^2 skip test, the sane reading);
    strict_parity=True reproduces the -1 sentinel.
  * uncaptured vertices keep dist2 = 0 and so deform fully (quirk 1) —
    that's the reference contract; CaptureResult.captured lets callers
    opt into strict masking.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
from scipy.spatial import cKDTree

from facedeform_tpu_torch.geometry.mesh import Mesh
from facedeform_tpu_torch.geometry.topology import mesh_adjacency
from facedeform_tpu_torch.capture.flood import find_islands
from facedeform_tpu_torch.ops.distances import (
    min_sqdist_to_points_auto,
    min_sqdist_to_triangles_auto,
)
from facedeform_tpu_torch.utils.errors import CaptureError


def _hsv_to_rgb(h: np.ndarray, s: float = 1.0, v: float = 1.0) -> np.ndarray:
    """Minimal HSV->RGB (h in degrees) for the falloff color viz
    (UT_Color::setHSV parity, capture.cpp:96-98)."""
    h = (np.asarray(h, np.float32) % 360.0) / 60.0
    i = np.floor(h).astype(np.int32)
    f = h - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    ones = np.full_like(f, v)
    lut = np.stack(
        [
            np.stack([ones, t, np.full_like(f, p)], -1),
            np.stack([q, ones, np.full_like(f, p)], -1),
            np.stack([np.full_like(f, p), ones, t], -1),
            np.stack([np.full_like(f, p), q, ones], -1),
            np.stack([t, np.full_like(f, p), ones], -1),
            np.stack([ones, np.full_like(f, p), q], -1),
        ],
        axis=0,
    )
    return lut[i % 6, np.arange(len(f))]


@dataclasses.dataclass
class CaptureResult:
    """Outputs of a capture pass.

    dist2 is the per-vertex attribute the eval loop consumes
    (getDistanceAttribute, capture.hpp:26); color is the viz attribute
    (capture.hpp:27).
    """

    captured: np.ndarray                 # (V,) bool union over classes
    dist2: np.ndarray                    # (V,) f32
    islands: Dict[int, np.ndarray]       # class id -> (V,) bool
    color: np.ndarray                    # (V, 3) f32 falloff viz
    seed_vertices: np.ndarray            # (M,) mesh vertex per marker


class ProximityCapture:
    """Stateful capture object mirroring the reference class API
    (capture.hpp:12-43): init / isInitialized / capture / isCaptured /
    result accessors.  Euclidean distances run on `device`."""

    def __init__(self, device="cuda") -> None:
        self.device = device
        self._init = False
        self._captured = False
        self._mesh: Optional[Mesh] = None
        self._rig: Optional[Mesh] = None
        self._tree: Optional[cKDTree] = None
        self._adj = None
        self._result: Optional[CaptureResult] = None

    # ------------------------------------------------------------- lifecycle
    def init(self, mesh: Mesh, rig: Mesh) -> bool:
        """Build mesh KD-tree + edge adjacency (capture.cpp:10-44)."""
        self._mesh = mesh
        self._rig = rig
        self._tree = cKDTree(mesh.points)
        self._adj = mesh_adjacency(mesh)
        self._init = True
        self._captured = False
        self._result = None
        return self._init

    def is_initialized(self) -> bool:
        return self._init

    def is_captured(self) -> bool:
        return self._captured

    # --------------------------------------------------------------- capture
    def capture(
        self,
        max_edges: int,
        radius: float,
        dofalloff: bool,
        falloffrate: float,
        strict_parity: bool = False,
        metric: str = "euclidean",
    ) -> CaptureResult:
        """Flood-fill islands and compute capture distances.

        metric="euclidean" measures straight-line distance to the nearest
        rig primitive (the reference semantics, capture.cpp:81-86);
        "geodesic" measures along the mesh edge graph from the marker
        seeds instead, so falloff cannot bleed across surface gaps (upper
        lip to lower lip) — see capture/geodesic.py.

        Raises CaptureError if not initialized or no island found (the
        reference returns false -> node error "Can't capture geometry with
        a rig!", src/SOP_FaceDeform.cpp:318-321).
        """
        if not self._init:
            raise CaptureError("capture() before init()")
        mesh, rig = self._mesh, self._rig
        if rig.num_points == 0:
            raise CaptureError("empty rig: no islands to capture")
        max_edges = max(int(max_edges), 1)
        radius = max(float(radius), 0.01)

        # findIslands: nearest mesh vertex per marker, per-class flood fill
        # (native KD-tree when available, scipy cKDTree otherwise).
        from facedeform_tpu_torch import native

        seed_vertices = native.nearest(mesh.points, rig.points)
        if seed_vertices is None:
            _, seed_vertices = self._tree.query(rig.points)
        seed_vertices = np.atleast_1d(seed_vertices).astype(np.int64)
        class_attr = rig.attr("class")
        classes = (
            np.asarray(class_attr).reshape(-1).astype(np.int64)
            if class_attr is not None
            else np.zeros(rig.num_points, np.int64)
        )
        indptr, indices = self._adj
        islands = find_islands(indptr, indices, seed_vertices, classes, max_edges)
        captured = np.zeros(mesh.num_points, dtype=bool)
        for m in islands.values():
            captured |= m
        if not captured.any():
            raise CaptureError("flood fill produced no captured vertices")

        dist2 = np.zeros(mesh.num_points, np.float32)
        color = np.ones((mesh.num_points, 3), np.float32)  # white default
        if dofalloff:
            cap_idx = np.nonzero(captured)[0]
            cap_pts = mesh.points[cap_idx]
            if metric == "geodesic":
                if len(indices) == 0:
                    raise CaptureError(
                        "geodesic falloff needs mesh edges (the input has "
                        "no faces) — use falloff_metric='euclidean'"
                    )
                from facedeform_tpu_torch.capture.geodesic import geodesic_distance

                offsets = np.linalg.norm(
                    rig.points - mesh.points[seed_vertices], axis=1
                ).astype(np.float32)
                geo = geodesic_distance(
                    indptr, indices, mesh.points, seed_vertices, offsets
                )
                d2 = (geo[cap_idx] ** 2).astype(np.float32)
            elif metric != "euclidean":
                raise CaptureError(f"unknown falloff metric {metric!r}")
            else:
                tris = rig.triangles()
                if tris is not None:
                    d2 = min_sqdist_to_triangles_auto(
                        cap_pts, rig.points[tris], device=self.device
                    )
                else:
                    d2 = min_sqdist_to_points_auto(
                        cap_pts, rig.points, device=self.device
                    )
            r2 = radius * radius
            if strict_parity:
                # -1 sentinel where the radius-bounded search would fail
                # (capture.cpp:76-88) — reproduces the amplification quirk.
                d2 = np.where(d2 <= r2, d2, -1.0).astype(np.float32)
            dist2[cap_idx] = d2.astype(np.float32)
            # falloff viz colors, only where 0 <= d2 <= r^2 (capture.cpp:89-98)
            vis = (d2 >= 0) & (d2 <= r2)
            falloff = (1.0 - np.minimum(d2 / r2, 1.0)) ** float(falloffrate)
            hue = 200.0 + falloff * 50.0  # SYSfit(falloff, 0, 1, 200, 250)
            rgb = _hsv_to_rgb(hue)
            color[cap_idx[vis]] = rgb[vis]

        self._result = CaptureResult(
            captured=captured,
            dist2=dist2,
            islands=islands,
            color=color,
            seed_vertices=seed_vertices,
        )
        self._captured = True
        return self._result

    # ------------------------------------------------------------ accessors
    @property
    def result(self) -> Optional[CaptureResult]:
        return self._result

    def distance_attribute(self) -> Optional[np.ndarray]:
        """getDistanceAttribute analogue (capture.hpp:26)."""
        return None if self._result is None else self._result.dist2

    def color_attribute(self) -> Optional[np.ndarray]:
        """getColorAttribute analogue (capture.hpp:27)."""
        return None if self._result is None else self._result.color
