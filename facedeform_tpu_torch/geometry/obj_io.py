"""Wavefront OBJ load/save for the Mesh container (L1 substrate I/O).

A copy of facedeform_tpu/geometry/obj_io.py (numpy only):
importing it from there would import the JAX package.

The reference reads geometry through Houdini's node inputs; standalone use
needs a disk format.  OBJ covers positions + polygonal faces; named point
attributes ride sidecar .npz files (OBJ has no attribute concept beyond
normals/uvs, which are mapped to `N`/`uv` when per-vertex).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from facedeform_tpu_torch.geometry.mesh import Mesh


def _load_obj_python(path: str):
    """Pure-Python fallback parser (native/fastgeo.cpp is ~100x faster).

    Understands `g <name>` statements: the vertices of faces following a
    group statement join that named point group (the closest OBJ analogue
    of the Houdini point groups the reference's `group` parameter selects,
    src/SOP_FaceDeform.cpp:119-120).
    """
    verts = []
    normals = []
    faces = []
    group_faces: dict = {}
    current_groups: list = []
    with open(path) as f:
        for line in f:
            # tab-delimited records are valid OBJ and the native scanner
            # accepts them (fastgeo.cpp tests ' '||'\t'); startswith("v ")
            # alone would drop a tab file's whole geometry on the
            # Python path
            key = line.split(maxsplit=1)[0] if line.strip() else ""
            if key == "v":
                verts.append([float(x) for x in line.split()[1:4]])
            elif key == "vn":
                normals.append([float(x) for x in line.split()[1:4]])
            elif key == "f":
                # resolve relative (negative) indices NOW, against the
                # vertices seen SO FAR — the OBJ spec's rule and the
                # native parser's (fastgeo.cpp vi + idx); deferring to
                # the final total would mis-resolve interleaved v/f blocks
                seen = len(verts)
                idx = [
                    (v - 1 if v > 0 else seen + v)
                    for v in (int(tok.split("/")[0])
                              for tok in line.split()[1:])
                ]
                for gname in current_groups:
                    group_faces.setdefault(gname, []).append(len(faces))
                faces.append(idx)
            elif key == "g":
                names = line.split()[1:]
                # `g` with no name (or "default") resets to no group
                current_groups = [n for n in names if n != "default"]
    points = np.asarray(verts, np.float32).reshape(-1, 3)
    norm_arr = np.asarray(normals, np.float32) if normals else None
    if not faces:
        return points, norm_arr, None, {}
    arity = max(len(fc) for fc in faces)
    n_verts = len(verts)
    face_arr = np.full((len(faces), arity), -1, np.int32)
    for i, fc in enumerate(faces):
        face_arr[i, : len(fc)] = fc
    groups = {}
    for gname, fidx in group_faces.items():
        ids = face_arr[np.asarray(fidx, np.int64)].ravel()
        mask = np.zeros(n_verts, bool)
        mask[ids[ids >= 0]] = True
        groups[gname] = mask
    return points, norm_arr, face_arr, groups


def _file_has_groups(path: str) -> bool:
    """Cheap byte scan for `g ` statements (gates the slow python parser;
    OBJ files without groups keep the fast native scan).  Scans the WHOLE
    file — a truncated scan would silently drop groups declared late in
    large files, and a full pass reads at memory-bandwidth speed."""
    with open(path, "rb") as f:
        # prev_tail seeds a leading newline, so the very first line is
        # covered by the same \ng- substring tests as every other line
        prev_tail = b"\n"
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return False
            block = prev_tail + chunk
            if b"\ng " in block or b"\ng\t" in block:
                return True
            prev_tail = chunk[-2:]


def load_obj(path: str, load_attrs: bool = True) -> Mesh:
    """Load an OBJ file; v/vn/f records (faces triangulated as stored when
    uniform arity, else fanned to triangles).  A sidecar `<path>.attrs.npz`
    restores point/detail attributes saved by save_obj.  Uses the native
    fastgeo scanner when available (large production meshes)."""
    from facedeform_tpu_torch import native

    groups: dict = {}
    if _file_has_groups(path):
        # `g` statements need the python parser (the native scanner skips
        # them); group-free files — the common case — stay on the fast path.
        points, normals, raw_faces, groups = _load_obj_python(path)
    else:
        parsed = native.parse_obj(path)
        if parsed is None:
            points, normals, raw_faces, groups = _load_obj_python(path)
        else:
            points, normals, raw_faces = parsed

    face_arr: Optional[np.ndarray] = None
    if raw_faces is not None and len(raw_faces):
        pad_mask = raw_faces < 0
        if not pad_mask.any():
            face_arr = raw_faces
        else:
            # mixed arity: fan-triangulate each face's valid prefix
            tris = []
            counts = (~pad_mask).sum(axis=1)
            for fc, k in zip(raw_faces, counts):
                for i in range(1, int(k) - 1):
                    tris.append([fc[0], fc[i], fc[i + 1]])
            face_arr = np.asarray(tris, np.int32)
    mesh = Mesh(points=points, faces=face_arr)
    for gname, mask in groups.items():
        mesh.set_group(gname, mask)
    if normals is not None and len(normals) == len(points):
        mesh.set_attr("N", np.asarray(normals, np.float32))
    sidecar = path + ".attrs.npz"
    if load_attrs and os.path.exists(sidecar):
        data = np.load(sidecar)
        for key in data.files:
            kind, name = key.split(":", 1)
            if kind == "point":
                mesh.set_attr(name, data[key])
            elif kind == "group":
                # named point groups (the reference node's `group` string
                # selects one of these, src/SOP_FaceDeform.cpp:119-120)
                mesh.set_group(name, data[key])
            else:
                mesh.detail_attrs[name] = data[key]
    return mesh


def save_obj(path: str, mesh: Mesh, save_attrs: bool = True) -> None:
    """Write positions/faces (+ `N` as vn); other attributes go to the
    `<path>.attrs.npz` sidecar.  Uses the native fastgeo writer when
    available."""
    from facedeform_tpu_torch import native

    n = mesh.attr("N")
    if not native.write_obj(path, mesh.points, n, mesh.faces):
        with open(path, "w") as f:
            f.write("# facedeform-tpu\n")
            for p in mesh.points:
                f.write(f"v {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
            if n is not None:
                for v in n:
                    f.write(f"vn {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
            if mesh.faces is not None:
                for face in mesh.faces:
                    # skip -1 padding (mixed-arity faces) like the native
                    # writer — emitting it as index 0 corrupts the file
                    f.write("f " + " ".join(
                        str(int(i) + 1) for i in face if int(i) >= 0
                    ) + "\n")
    if save_attrs:
        payload = {}
        for name, arr in mesh.point_attrs.items():
            if name == "N":
                continue
            payload[f"point:{name}"] = arr
        for name, arr in mesh.detail_attrs.items():
            payload[f"detail:{name}"] = np.asarray(arr)
        for name, arr in mesh.point_groups.items():
            payload[f"group:{name}"] = arr
        if payload:
            np.savez(path + ".attrs.npz", **payload)
        elif os.path.exists(path + ".attrs.npz"):
            # a stale sidecar from a previous save of a DIFFERENT mesh
            # would resurrect its attrs/groups onto this geometry on load
            os.remove(path + ".attrs.npz")
