"""Minimal point/face container for the procedural primitives.

Only the fields the primitives fill (points, faces, num_points); the full
attribute/group/data-ID mesh of facedeform_tpu/geometry/mesh.py is ported
with the node cook.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Mesh:
    """points: (V, 3) float32; faces: optional (F, k) int32 vertex indices."""

    points: np.ndarray
    faces: Optional[np.ndarray] = None

    @property
    def num_points(self) -> int:
        return self.points.shape[0]
