"""Houdini JSON .geo loader/writer (the reference's native geometry world).

A copy of facedeform_tpu/geometry/geo_io.py (numpy only):
importing it from there would import the JAX package.

The reference is a Houdini SOP: its users' meshes, rigs, and blendshapes
live as Houdini geometry with `P`, `N`, `tangentu`/`tangentv`, `Cd`, the
rig's `class` int attribute, and named point groups (consumed at
src/SOP_FaceDeform.cpp:289-297, :119-120; capture.cpp:113).  This module
reads and writes the modern JSON `.geo` schema (fileversion 12.0+,
Houdini's `File > Save As .geo` ASCII output) for exactly that point/
polygon subset, so a reference user can export from Houdini and drive
this framework without an OBJ conversion step.

Supported on load:
  * point count / topology (`pointref` vertex indices)
  * point attributes: numeric, storage tuples / arrays / rawpagedata
    (interleaved packing, constant pages), fpreal16/32/64 and int
    storages — `P` becomes Mesh.points, the rest Mesh.point_attrs
  * global (detail) attributes -> Mesh.detail_attrs
  * primitives: `Polygon_run` (run-length uniform or `nvertices_rle`) and
    plain per-primitive `Polygon` entries; mixed arities are -1-padded
    (Mesh contract, triangulated downstream)
  * point groups: `i8` bitmask and `boolRLE` selections

Unsupported constructs (string attributes, packed prims, volumes, ...)
are skipped on load — this is a geometry bridge, not a Houdini
re-implementation — but never silently: each skip is recorded on
`mesh.load_warnings` (and printed by the CLI) so a Houdini round trip
that drops data says so.  The writer emits the plain `tuples` storage
with a `Polygon_run`, which Houdini (12.0+) reads back losslessly.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

from facedeform_tpu_torch.geometry.mesh import Mesh

_FLOAT_STORAGES = {"fpreal16", "fpreal32", "fpreal64"}
_INT_STORAGES = {"int8", "uint8", "int16", "int32", "int64"}


def _pairs(seq: List[Any]) -> Dict[str, Any]:
    """Houdini JSON uses flat [key, value, key, value, ...] arrays."""
    if isinstance(seq, dict):  # hjson-style alternative encoding
        return seq
    return {seq[i]: seq[i + 1] for i in range(0, len(seq) - 1, 2)}


def _decode_values(values: Dict[str, Any], n_expected: int) -> Optional[np.ndarray]:
    """Decode a numeric attribute's `values` block to an (N, size) array."""
    size = int(values.get("size", 1))
    storage = values.get("storage", "fpreal32")
    if storage in _FLOAT_STORAGES:
        dtype = np.float32 if storage != "fpreal64" else np.float64
    elif storage in _INT_STORAGES:
        dtype = np.int64 if storage == "int64" else np.int32
    else:
        return None

    if "tuples" in values:
        arr = np.asarray(values["tuples"], dtype=dtype)
        return arr.reshape(len(values["tuples"]), -1)
    if "arrays" in values:
        # size-1 (or per-component) parallel arrays
        comps = [np.asarray(a, dtype=dtype) for a in values["arrays"]]
        return np.stack(comps, axis=-1).reshape(len(comps[0]), -1)
    if "rawpagedata" in values:
        flat = np.asarray(values["rawpagedata"], dtype=dtype)
        packing = values.get("packing", [size])
        pagesize = int(values.get("pagesize", n_expected or len(flat)))
        cpf = values.get("constantpageflags")
        if cpf and any(any(flags) for flags in cpf):
            return _decode_paged_constant(
                flat, size, packing, pagesize, cpf, n_expected, dtype
            )
        if list(packing) == [size] or size == 1:
            return flat.reshape(-1, size)
        # component-split packing, e.g. [1,1,1]: per page, each packing
        # subvector's components are stored contiguously
        return _decode_packed(flat, size, packing, pagesize, n_expected, dtype)
    return None


def _decode_packed(flat, size, packing, pagesize, n, dtype) -> np.ndarray:
    out = np.empty((n, size), dtype=dtype)
    pos = 0
    row = 0
    while row < n:
        rows = min(pagesize, n - row)
        col = 0
        for sub in packing:
            blk = flat[pos: pos + rows * sub]
            out[row: row + rows, col: col + sub] = blk.reshape(rows, sub)
            pos += rows * sub
            col += sub
        row += rows
    return out


def _decode_paged_constant(flat, size, packing, pagesize, cpf, n, dtype):
    """rawpagedata with constant pages: a constant page stores one tuple."""
    out = np.empty((n, size), dtype=dtype)
    pos = 0
    row = 0
    page = 0
    n_pages = (n + pagesize - 1) // pagesize
    while row < n:
        rows = min(pagesize, n - row)
        col = 0
        for si, sub in enumerate(packing):
            flags = cpf[si] if si < len(cpf) else [False] * n_pages
            const = page < len(flags) and bool(flags[page])
            if const:
                out[row: row + rows, col: col + sub] = flat[pos: pos + sub]
                pos += sub
            else:
                blk = flat[pos: pos + rows * sub]
                out[row: row + rows, col: col + sub] = blk.reshape(rows, sub)
                pos += rows * sub
            col += sub
        row += rows
        page += 1
    return out


def _skip_reason(entry: List[Any], kind: str) -> str:
    """Human-readable reason an attribute/group entry was not decoded
    (best effort — malformed entries get a generic note)."""
    try:
        defn = _pairs(entry[0])
        name = defn.get("name", "?")
        typ = defn.get("type", "?")
        if kind == "point group":
            return f"skipped {kind} {name!r} (unsupported selection encoding)"
        if typ != "numeric":
            return f"skipped {kind} {name!r} (unsupported type {typ!r})"
        data = _pairs(entry[1])
        values = data.get("values")
        if values is not None:
            values = _pairs(values) if isinstance(values, list) else values
            storage = values.get("storage", "?")
            return f"skipped {kind} {name!r} (unsupported storage {storage!r})"
        return f"skipped {kind} {name!r} (no decodable payload)"
    except Exception:
        return f"skipped malformed {kind} entry"


def _decode_attribute(entry: List[Any], n_expected: int):
    """One attribute entry: [definition-pairs, data-pairs] ->
    (name, array, typeinfo) — typeinfo is Houdini's options.type qualifier
    ("point"/"vector"/"normal"/"quaternion"/"color"/...) or None."""
    if not isinstance(entry, list) or len(entry) != 2:
        return None
    defn = _pairs(entry[0])
    data = _pairs(entry[1])
    if defn.get("type") != "numeric":
        return None  # string/indexpair/... — out of scope
    name = defn.get("name")
    values = data.get("values")
    if name is None or values is None:
        return None
    typeinfo = None
    options = defn.get("options")
    if isinstance(options, dict):
        t = options.get("type")
        if isinstance(t, dict):
            typeinfo = t.get("value")
        elif isinstance(t, str):
            typeinfo = t
    arr = _decode_values(_pairs(values) if isinstance(values, list) else values,
                         n_expected)
    if arr is None:
        return None
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    return name, arr, typeinfo


def _decode_group(entry: List[Any], n_points: int):
    if not isinstance(entry, list) or len(entry) != 2:
        return None
    defn = _pairs(entry[0])
    data = _pairs(entry[1])
    name = defn.get("name")
    sel = data.get("selection")
    if name is None or sel is None:
        return None
    sel = _pairs(sel)
    un = sel.get("unordered")
    if un is None:
        return None
    un = _pairs(un)
    if "i8" in un:
        mask = np.asarray(un["i8"], dtype=np.int8)[:n_points] != 0
    elif "boolRLE" in un:
        rle = un["boolRLE"]
        parts = [
            np.full(int(rle[i]), bool(rle[i + 1]))
            for i in range(0, len(rle) - 1, 2)
        ]
        mask = (np.concatenate(parts) if parts else np.zeros(0, bool))[:n_points]
    else:
        return None
    if mask.shape[0] < n_points:
        mask = np.pad(mask, (0, n_points - mask.shape[0]))
    return name, mask


def _decode_primitives(prims: List[Any], pointref: np.ndarray,
                       load_warnings: Optional[List[str]] = None):
    """Polygon faces as a -1-padded (F, k) int32 array (Mesh contract)."""
    faces: List[np.ndarray] = []
    skipped: Dict[str, int] = {}
    for entry in prims:
        if not isinstance(entry, list) or not entry:
            continue
        head = _pairs(entry[0])
        ptype = head.get("type")
        if ptype not in ("Polygon_run", "run", "Polygon") or (
            ptype == "run" and head.get("runtype") != "Polygon"
        ):
            # packed prims, volumes, curves, ... — count per type
            key = str(head.get("runtype")) if ptype == "run" else str(ptype)
            skipped[key] = skipped.get(key, 0) + 1
            continue
        body = _pairs(entry[1]) if len(entry) > 1 else {}
        if ptype in ("Polygon_run", "run") and (
            ptype == "Polygon_run" or head.get("runtype") == "Polygon"
        ):
            start = int(body.get("startvertex", 0))
            nprim = int(body.get("nprimitives", 0))
            if "nvertices_rle" in body:
                rle = body["nvertices_rle"]
                counts: List[int] = []
                for i in range(0, len(rle) - 1, 2):
                    counts.extend([int(rle[i])] * int(rle[i + 1]))
            elif "nvertices" in body:
                counts = [int(c) for c in body["nvertices"]]
            else:
                counts = []
            pos = start
            for c in counts[:nprim] if nprim else counts:
                faces.append(pointref[pos: pos + c])
                pos += c
        elif ptype == "Polygon":
            vtx = body.get("vertex")
            if vtx is not None:
                faces.append(pointref[np.asarray(vtx, np.int64)])
    if load_warnings is not None:
        for ptype, count in sorted(skipped.items()):
            load_warnings.append(
                f"skipped {count} {ptype!r} primitive(s) (only polygons "
                "are bridged)"
            )
    if not faces:
        return None
    k = max(len(f) for f in faces)
    out = np.full((len(faces), k), -1, np.int32)
    for i, f in enumerate(faces):
        out[i, : len(f)] = f
    return out


def load_geo(path: str) -> Mesh:
    """Load a Houdini JSON .geo file into a Mesh (see module docstring).

    Unsupported constructs (string attrs, packed prims, ...) are skipped
    and listed on the returned mesh's `load_warnings`; the CLI prints
    them.  Raises ValueError with a one-line diagnosis for non-JSON
    inputs (the pre-H12 classic ASCII format, binary .bgeo renamed to
    .geo, truncated files) instead of leaking a JSONDecodeError
    traceback."""
    try:
        with open(path, "r") as fh:
            head = fh.read(32)
            fh.seek(0)
            if head.startswith("PGEOMETRY"):
                raise ValueError(
                    f"{path}: classic (pre-Houdini-12) ASCII .geo is not "
                    "supported — resave as JSON .geo (File > Save, or "
                    "`geoconvert file.geo file.geo` in a modern Houdini)"
                )
            doc = json.load(fh)
    except UnicodeDecodeError as e:
        raise ValueError(
            f"{path}: not a JSON .geo file (binary content — a .bgeo "
            "renamed to .geo? resave as ASCII .geo)"
        ) from e
    except json.JSONDecodeError as e:
        raise ValueError(
            f"{path}: malformed JSON .geo ({e.msg} at line {e.lineno})"
        ) from e
    top = _pairs(doc)
    n_points = int(top.get("pointcount", 0))
    # every construct the bridge cannot represent is recorded here and
    # attached as mesh.load_warnings — Houdini round trips must not drop
    # data silently (the attr surface: src/SOP_FaceDeform.cpp:289-297)
    load_warnings: List[str] = []

    # topology: vertex -> point map
    pointref = np.zeros(0, np.int64)
    topo = top.get("topology")
    if topo is not None:
        pr = _pairs(topo).get("pointref")
        if pr is not None:
            idx = _pairs(pr).get("indices")
            if idx is not None:
                pointref = np.asarray(idx, np.int64)

    points = np.zeros((n_points, 3), np.float32)
    point_attrs: Dict[str, np.ndarray] = {}
    detail_attrs: Dict[str, np.ndarray] = {}
    attr_typeinfo: Dict[str, str] = {}
    attrs = top.get("attributes")
    if attrs is not None:
        attrs = _pairs(attrs)
        for entry in attrs.get("pointattributes", []) or []:
            decoded = _decode_attribute(entry, n_points)
            if decoded is None:
                load_warnings.append(_skip_reason(entry, "point attribute"))
                continue
            name, arr, typeinfo = decoded
            if name == "P":
                points = np.asarray(arr, np.float32)[:, :3]
            else:
                point_attrs[name] = arr
                if typeinfo:
                    attr_typeinfo[name] = typeinfo
        for entry in attrs.get("globalattributes", []) or []:
            decoded = _decode_attribute(entry, 1)
            if decoded is None:
                load_warnings.append(_skip_reason(entry, "detail attribute"))
                continue
            name, arr, _ = decoded
            detail_attrs[name] = np.asarray(arr).reshape(-1)
        # vertex attributes (Houdini's default class for uv, common for
        # N): promote to a point attribute when every vertex of a point
        # carries the same value — the usual case for point-uniform data
        # exported vertex-class; genuinely per-corner data (UV seams)
        # can't live on a point Mesh and is recorded as dropped.  Round 5:
        # these were silently ignored, violating the module's
        # every-skip-is-recorded contract.
        for entry in attrs.get("vertexattributes", []) or []:
            n_vtx = int(pointref.size)
            decoded = _decode_attribute(entry, n_vtx) if n_vtx else None
            if decoded is None:
                load_warnings.append(_skip_reason(entry, "vertex attribute"))
                continue
            name, arr, typeinfo = decoded
            arr = np.asarray(arr)
            first = np.full(n_points, -1, np.int64)
            order = np.arange(n_vtx - 1, -1, -1)
            first[pointref[order]] = order      # first occurrence wins
            used = first >= 0
            rep = arr[first[pointref]]
            if not np.array_equal(arr, rep):
                load_warnings.append(
                    f"vertex attribute {name!r} varies per corner "
                    "(seam data); dropped — only point-uniform vertex "
                    "attributes promote to point attributes"
                )
                continue
            if name == "P" or name in point_attrs:
                load_warnings.append(
                    f"vertex attribute {name!r} shadowed by the point "
                    "attribute of the same name; dropped"
                )
                continue
            out = np.zeros((n_points,) + arr.shape[1:], arr.dtype)
            out[used] = arr[first[used]]
            point_attrs[name] = out
            if typeinfo:
                attr_typeinfo[name] = typeinfo
        for entry in attrs.get("primitiveattributes", []) or []:
            name = "?"
            try:
                name = _pairs(entry[0]).get("name", "?")
            except Exception:
                pass
            load_warnings.append(
                f"primitive attribute {name!r} dropped (Mesh stores "
                "point/detail attributes only)"
            )

    faces = None
    prims = top.get("primitives")
    if prims is not None and pointref.size:
        faces = _decode_primitives(prims, pointref, load_warnings)

    mesh = Mesh(points=points, faces=faces)
    for name, arr in point_attrs.items():
        mesh.set_attr(name, arr)
    mesh.attr_typeinfo.update(attr_typeinfo)
    mesh.detail_attrs.update(detail_attrs)
    for entry in top.get("pointgroups", []) or []:
        decoded = _decode_group(entry, n_points)
        if decoded is None:
            load_warnings.append(_skip_reason(entry, "point group"))
        else:
            mesh.set_group(decoded[0], decoded[1])
    for entry in top.get("primitivegroups", []) or []:
        name = "?"
        try:
            name = _pairs(entry[0]).get("name", "?")
        except Exception:
            pass
        load_warnings.append(
            f"primitive group {name!r} dropped (Mesh stores point "
            "groups only)"
        )
    mesh.load_warnings = load_warnings
    return mesh


# --------------------------------------------------------------------- save
#: default Houdini typeinfo qualifiers by conventional attribute name —
#: used when the Mesh carries no explicit attr_typeinfo entry, so N / v /
#: orient land in Houdini with transform semantics instead of plain floats
_DEFAULT_TYPEINFO = {
    "P": "point", "rest": "point",
    "N": "normal",
    "v": "vector", "up": "vector", "tangentu": "vector", "tangentv": "vector",
    "orient": "quaternion", "rot": "quaternion",
    "Cd": "color",
}


def _encode_attribute(
    name: str, arr: np.ndarray, typeinfo: str | None = None,
    name_defaults: bool = True,
) -> List[Any]:
    arr = np.asarray(arr)
    if arr.ndim == 1:
        arr = arr[:, None]
    if np.issubdtype(arr.dtype, np.integer):
        storage = "int32"
        arr = arr.astype(np.int32)
        defaults_storage = "int64"
    else:
        storage = "fpreal32"
        arr = arr.astype(np.float32)
        defaults_storage = "fpreal64"
    size = arr.shape[1]
    if typeinfo is None and name_defaults:
        # point-attr naming conventions only — a DETAIL attr that happens
        # to be called "v"/"rest" must not become transform-aware
        typeinfo = _DEFAULT_TYPEINFO.get(name)
    options = (
        {"type": {"type": "string", "value": typeinfo}} if typeinfo else {}
    )
    return [
        [
            "scope", "public",
            "type", "numeric",
            "name", name,
            "options", options,
        ],
        [
            "size", size,
            "storage", storage,
            "defaults", ["size", size, "storage", defaults_storage,
                         "values", [0] * size],
            "values", [
                "size", size,
                "storage", storage,
                "tuples", arr.tolist(),
            ],
        ],
    ]


def save_geo(path: str, mesh: Mesh) -> None:
    """Write a Mesh as Houdini JSON .geo (points/polygons/attrs/groups)."""
    n = mesh.num_points
    faces = mesh.faces
    vertex_lists: List[List[int]] = []
    if faces is not None:
        for f in np.asarray(faces):
            valid = [int(v) for v in f if v >= 0]
            if len(valid) >= 3:
                vertex_lists.append(valid)
    pointref = [v for f in vertex_lists for v in f]
    counts = [len(f) for f in vertex_lists]

    point_attrs = [_encode_attribute("P", mesh.points)]
    for name, arr in mesh.point_attrs.items():
        point_attrs.append(_encode_attribute(
            name, arr, mesh.attr_typeinfo.get(name)
        ))
    global_attrs = [
        _encode_attribute(name, np.asarray(arr).reshape(1, -1),
                          name_defaults=False)
        for name, arr in mesh.detail_attrs.items()
    ]

    doc: List[Any] = [
        "fileversion", "19.5.303",
        "hasindex", False,
        "pointcount", n,
        "vertexcount", len(pointref),
        "primitivecount", len(vertex_lists),
        "info", {"software": "facedeform_tpu_torch"},
        "topology", ["pointref", ["indices", pointref]],
        "attributes", (
            ["pointattributes", point_attrs]
            + (["globalattributes", global_attrs] if global_attrs else [])
        ),
    ]
    if vertex_lists:
        # run-length encode the arity sequence
        rle: List[int] = []
        for c in counts:
            if rle and rle[-2] == c:
                rle[-1] += 1
            else:
                rle.extend([c, 1])
        doc += ["primitives", [[
            ["type", "Polygon_run"],
            ["startvertex", 0,
             "nprimitives", len(vertex_lists),
             "nvertices_rle", rle],
        ]]]
    if mesh.point_groups:
        doc += ["pointgroups", [
            [["name", gname],
             ["selection", ["unordered",
                            ["i8", np.asarray(gmask, np.int8).tolist()]]]]
            for gname, gmask in mesh.point_groups.items()
        ]]
    with open(path, "w") as fh:
        json.dump(doc, fh)
