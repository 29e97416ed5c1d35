"""Geometry substrate: a thin numpy point-attribute mesh (replaces HDK L1).

A copy of facedeform_tpu/geometry/mesh.py (numpy only), with
reorder_spatial taking its Morton codes from the port's ops/morton.py.

The reference leans on Houdini's GU_Detail/GA attribute machinery for
geometry storage (every file; SURVEY.md section 1, layer L1).  The rebuild
needs only: point positions, optional polygonal topology, named point/detail
attributes, and the data-ID change tracking the SOP uses for cache
invalidation (SOP_FaceDeform.hpp:47-64 caches posID/topID per input;
cookMySop bumps P's data id at src/SOP_FaceDeform.cpp:485-486).

Host-side container (numpy) by design: device code takes plain arrays, the
Mesh is the I/O + caching boundary.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

_ID_COUNTER = [0]


def _next_id() -> int:
    _ID_COUNTER[0] += 1
    return _ID_COUNTER[0]


@dataclasses.dataclass
class Mesh:
    """Point-attribute geometry container.

    Attributes:
      points: (V, 3) float32 positions (the `P` attribute).
      faces: optional (F, k) int32 polygon vertex indices (triangles k=3 or
        quads k=4), or None for a point cloud (e.g. a control rig).
      point_attrs: named per-point arrays, first axis V (e.g. `N`,
        `tangentu`, `tangentv`, `class`, `rest`, `fd_falloff`, `Cd`).
      detail_attrs: named whole-mesh values (e.g. the DBSE `weights` array,
        src/SOP_FaceDeform.cpp:474-480).
      point_groups: named boolean point subsets — the HDK GA_PointGroup
        analogue backing the reference node's `group` string parameter
        (src/SOP_FaceDeform.cpp:119-120, applied :485).

    Faces may be -1-padded for mixed polygon arities; triangles() and the
    topology helpers drop padded entries.
    """

    points: np.ndarray
    faces: Optional[np.ndarray] = None
    point_attrs: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    detail_attrs: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    point_groups: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    #: Houdini-style attribute typeinfo qualifiers per point attr
    #: ("point" | "vector" | "normal" | "quaternion" | "color") — read
    #: from .geo files and written back by the bridge; node attribute
    #: transport honors these over name/width inference.
    attr_typeinfo: Dict[str, str] = dataclasses.field(default_factory=dict)
    _pos_id: int = dataclasses.field(default_factory=_next_id)
    _top_id: int = dataclasses.field(default_factory=_next_id)
    _attr_id: int = dataclasses.field(default_factory=_next_id)

    def __post_init__(self):
        self.points = np.ascontiguousarray(self.points, dtype=np.float32)
        if self.points.ndim != 2 or self.points.shape[1] != 3:
            raise ValueError(f"points must be (V, 3), got {self.points.shape}")
        if self.faces is not None:
            self.faces = np.ascontiguousarray(self.faces, dtype=np.int32)

    # ------------------------------------------------------------------ ids
    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def pos_id(self) -> int:
        """Monotone id bumped whenever positions change (HDK getDataId analogue)."""
        return self._pos_id

    @property
    def top_id(self) -> int:
        """Monotone id bumped whenever topology changes."""
        return self._top_id

    @property
    def attr_id(self) -> int:
        """Monotone id bumped whenever any point attribute changes —
        consumers whose behavior depends on attrs (e.g. the capture pass
        reading the rig's `class`) key their caches on it."""
        return self._attr_id

    def set_points(self, points: np.ndarray) -> None:
        """Replace positions and bump the position data id."""
        points = np.ascontiguousarray(points, dtype=np.float32)
        if points.shape != self.points.shape:
            raise ValueError("set_points cannot change point count; rebuild the Mesh")
        self.points = points
        self._pos_id = _next_id()

    def set_faces(self, faces: Optional[np.ndarray]) -> None:
        self.faces = None if faces is None else np.ascontiguousarray(faces, np.int32)
        self._top_id = _next_id()

    # ---------------------------------------------------------------- attrs
    def attr(self, name: str) -> Optional[np.ndarray]:
        return self.point_attrs.get(name)

    def set_attr(self, name: str, value: np.ndarray) -> None:
        value = np.asarray(value)
        if value.shape[0] != self.num_points:
            raise ValueError(
                f"attr {name!r} first axis {value.shape[0]} != V={self.num_points}"
            )
        self.point_attrs[name] = value
        self._attr_id = _next_id()

    # --------------------------------------------------------------- groups
    def set_group(self, name: str, mask: np.ndarray) -> None:
        """Store a named point group (GA_PointGroup analogue).

        `mask` is a (V,) boolean membership mask; point *indices* are also
        accepted as a 1-D integer array.  Disambiguation is by DTYPE, not
        length — an integer index list whose length happens to equal V must
        not be reinterpreted as a mask.
        """
        mask = np.asarray(mask)
        if np.issubdtype(mask.dtype, np.integer):
            idx = mask.astype(np.int64)
            if idx.size and (idx.min() < 0 or idx.max() >= self.num_points):
                raise ValueError(
                    f"group {name!r} indices out of range [0, {self.num_points})"
                )
            mask = np.zeros(self.num_points, bool)
            mask[idx] = True
        else:
            mask = mask.astype(bool)
            if mask.shape != (self.num_points,):
                raise ValueError(
                    f"group {name!r} mask shape {mask.shape} != (V={self.num_points},)"
                )
        self.point_groups[name] = mask
        self._attr_id = _next_id()

    def group_mask(self, name: str) -> np.ndarray:
        """Resolve a named group to its boolean mask; KeyError with the
        known names if absent (the SOP's group menu equivalent)."""
        try:
            return self.point_groups[name]
        except KeyError:
            raise KeyError(
                f"no point group {name!r}; known groups: "
                f"{sorted(self.point_groups)}"
            ) from None

    def select_points(self, pattern: str) -> np.ndarray:
        """Resolve a Houdini group-pattern string to a boolean mask:
        names, globs, point numbers, ranges (`3-40`, `3-40:2`,
        `3-40:2,5`), `!` complements and `^` subtraction — the
        `cookInputGroups` grammar (src/SOP_FaceDeform.cpp:156-173).  A
        plain group name behaves exactly like group_mask(name)."""
        from facedeform_tpu_torch.geometry.grouppattern import parse_group_pattern

        return parse_group_pattern(pattern, self)

    def has_tangent_frame(self) -> bool:
        """True if the tangentu/tangentv/N attributes the reference requires
        for tangent projection are present (src/SOP_FaceDeform.cpp:289-297)."""
        return all(k in self.point_attrs for k in ("tangentu", "tangentv", "N"))

    # ----------------------------------------------------------------- misc
    def copy(self) -> "Mesh":
        """Deep copy with fresh data ids (duplicatePointSource analogue,
        src/SOP_FaceDeform.cpp:226)."""
        return Mesh(
            points=self.points.copy(),
            faces=None if self.faces is None else self.faces.copy(),
            point_attrs={k: v.copy() for k, v in self.point_attrs.items()},
            detail_attrs={k: np.copy(v) for k, v in self.detail_attrs.items()},
            point_groups={k: v.copy() for k, v in self.point_groups.items()},
            attr_typeinfo=dict(self.attr_typeinfo),
        )

    def reorder_spatial(self) -> "Mesh":
        """One-time spatial (Morton/Z-order) reordering of the vertices.

        Returns a new Mesh whose points, per-point attributes and groups
        are permuted into Z-order and whose faces are remapped, so vertex
        tiles become spatially coherent.  This is the recommended import-
        time preprocessing for the culled eval kernel: a persistent mesh
        sorted once pays no per-frame gather (Deformer.apply's
        spatial_perm= gathers every call).
        """
        import torch

        from facedeform_tpu_torch.ops import morton

        codes = morton.morton_codes(torch.from_numpy(self.points)).numpy()
        perm = np.argsort(codes, kind="stable")
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        faces = None
        if self.faces is not None:
            faces = np.where(self.faces >= 0, inv[np.maximum(self.faces, 0)], -1)
            faces = faces.astype(np.int32)
        return Mesh(
            points=self.points[perm],
            faces=faces,
            point_attrs={k: v[perm] for k, v in self.point_attrs.items()},
            detail_attrs={k: np.copy(v) for k, v in self.detail_attrs.items()},
            point_groups={k: v[perm] for k, v in self.point_groups.items()},
            attr_typeinfo=dict(self.attr_typeinfo),
        )

    def subset(self, idx) -> "Mesh":
        """Point subset as a new point-cloud Mesh (faces dropped).

        Per-point attrs and groups are sliced with the same rows, so a
        reduced rig keeps its confidence/class attrs aligned — the
        rig-side helper behind ops/decimate.reduce_rig and the CLI
        --reduce-rig flag."""
        idx = np.asarray(idx)
        return Mesh(
            points=self.points[idx],
            faces=None,
            point_attrs={k: v[idx] for k, v in self.point_attrs.items()},
            detail_attrs={k: np.copy(v) for k, v in self.detail_attrs.items()},
            point_groups={k: v[idx] for k, v in self.point_groups.items()},
            attr_typeinfo=dict(self.attr_typeinfo),
        )

    def triangles(self) -> Optional[np.ndarray]:
        """Topology as triangles; quads are fanned, -1-padded entries dropped.
        None for point clouds."""
        if self.faces is None or len(self.faces) == 0:
            return None
        f = self.faces
        if f.shape[1] == 3:
            tris = f
        else:
            fans = []
            for i in range(1, f.shape[1] - 1):
                fans.append(np.stack([f[:, 0], f[:, i], f[:, i + 1]], axis=1))
            tris = np.concatenate(fans, axis=0).astype(np.int32)
        valid = np.all(tris >= 0, axis=1)
        tris = tris if valid.all() else tris[valid]
        return tris if len(tris) else None
