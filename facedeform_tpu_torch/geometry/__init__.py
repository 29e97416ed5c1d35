"""Geometry substrate: Mesh container, procedural primitives and
interchange IO.

`load_mesh`/`save_mesh` dispatch by extension: Houdini JSON `.geo`/
`.hgeo` (geo_io.py), glTF binary `.glb` (engine assets, gltf_io.py), else
Wavefront OBJ with the `.attrs.npz` sidecar (obj_io.py).
"""

from facedeform_tpu_torch.geometry.mesh import Mesh  # noqa: F401

_GEO_EXTS = (".geo", ".hgeo")


def load_mesh(path: str) -> "Mesh":
    """Load geometry by extension (.geo/.hgeo Houdini JSON, .glb glTF
    binary, else OBJ)."""
    if path.lower().endswith(_GEO_EXTS):
        from facedeform_tpu_torch.geometry.geo_io import load_geo

        return load_geo(path)
    if path.lower().endswith(".glb"):
        from facedeform_tpu_torch.geometry.gltf_io import load_glb_mesh

        return load_glb_mesh(path)
    from facedeform_tpu_torch.geometry.obj_io import load_obj

    return load_obj(path)


def save_mesh(path: str, mesh: "Mesh") -> None:
    """Save geometry by extension (.geo/.hgeo Houdini JSON, .glb glTF
    binary: positions/normals/triangles only, sidecar attrs dropped; else
    OBJ)."""
    if path.lower().endswith(_GEO_EXTS):
        from facedeform_tpu_torch.geometry.geo_io import save_geo

        save_geo(path, mesh)
        return
    if path.lower().endswith(".glb"):
        from facedeform_tpu_torch.geometry.gltf_io import save_glb

        save_glb(path, mesh)
        return
    from facedeform_tpu_torch.geometry.obj_io import save_obj

    save_obj(path, mesh)
