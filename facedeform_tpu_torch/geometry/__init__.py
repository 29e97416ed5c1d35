"""Geometry substrate: Mesh container, procedural primitives and
interchange IO.

`load_mesh`/`save_mesh` dispatch by extension: Houdini JSON `.geo`/
`.hgeo` (geo_io.py), else Wavefront OBJ with the `.attrs.npz` sidecar
(obj_io.py).  glTF binary `.glb` is not ported yet: its reader imports
the skinning op, which comes with the skinning, glTF and checkpoint slice
of ROADMAP queue 1.
"""

from facedeform_tpu_torch.geometry.mesh import Mesh  # noqa: F401

_GEO_EXTS = (".geo", ".hgeo")


def _no_glb(path: str) -> None:
    if path.lower().endswith(".glb"):
        raise NotImplementedError(
            f"{path}: glTF (.glb) I/O is not ported yet; it comes with the "
            "skinning op (ROADMAP queue 1: the skinning, glTF and checkpoint "
            "slice) - use .geo/.hgeo or .obj"
        )


def load_mesh(path: str) -> "Mesh":
    """Load geometry by extension (.geo/.hgeo Houdini JSON, else OBJ)."""
    _no_glb(path)
    if path.lower().endswith(_GEO_EXTS):
        from facedeform_tpu_torch.geometry.geo_io import load_geo

        return load_geo(path)
    from facedeform_tpu_torch.geometry.obj_io import load_obj

    return load_obj(path)


def save_mesh(path: str, mesh: "Mesh") -> None:
    """Save geometry by extension (.geo/.hgeo Houdini JSON, else OBJ)."""
    _no_glb(path)
    if path.lower().endswith(_GEO_EXTS):
        from facedeform_tpu_torch.geometry.geo_io import save_geo

        save_geo(path, mesh)
        return
    from facedeform_tpu_torch.geometry.obj_io import save_obj

    save_obj(path, mesh)
