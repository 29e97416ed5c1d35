"""In-Houdini adapter: run facedeform-tpu as a Python SOP (port of
facedeform_tpu/houdini.py, the node's cook on the PyTorch port; it runs
on the card unless cook_sop is asked for the CPU).

The reference is a compiled Houdini SOP plugin (`newSopOperator` registers
the `facedeform` operator, src/SOP_FaceDeform.cpp:35-46).  The rebuild's
compute path cannot live inside a compiled HDK plugin, but Houdini's
Python SOPs can host it directly, so a reference user can swap the C++
node for this adapter without leaving their scene.  The `.geo`/`.hgeo`
file bridge (geometry/geo_io.py) remains the out-of-session alternative.

Install (once per site):

  1. Make `facedeform_tpu_torch` importable from Houdini's Python (e.g. add the
     repo/site-packages path to `$HOUDINI_PATH/python3.Xlibs` or
     `sys.path` in `pythonrc.py`).
  2. Create a new operator type: File > New Asset > Python SOP, with
     minimum 3 inputs and maximum 1000 (the reference's input contract,
     src/SOP_FaceDeform.cpp:38-46).
  3. Paste :data:`PYTHON_SOP_CODE` as the asset's Code section.
  4. In the asset's Parameters tab, run
     ``facedeform_tpu_torch.houdini.apply_parm_templates(node.type().definition())``
     from the Python shell (or add the parameters by hand from
     :data:`PARM_SPECS`) to get the reference's 16-parameter UI
     (src/SOP_FaceDeform.cpp:99-137) plus the rebuild extensions.

The adapter keeps one :class:`~facedeform_tpu_torch.node.FaceDeformNode` per
Houdini node path, and caches the hou.Geometry -> Mesh conversion keyed on
the upstream SOP's cook count — so unchanged inputs reuse the capture /
solve / DBSE caches exactly like the reference's data-ID tracker
(SOP_FaceDeform.hpp:47-64), and a parameter slide never re-converts
geometry.

hou API surface used (kept deliberately small and version-stable; this
list is the adapter's declared API contract — tests/mock_hou.py and any
compatibility audit maintain against it, so EVERY member the code touches
must appear here):
  Geometry: points, prims, pointAttribs, findPointAttrib,
    findGlobalAttrib, point{Float,Int}AttribValues,
    setPointFloatAttribValues, addAttrib, addArrayAttrib,
    setGlobalAttribValue, pointGroups, merge
  Attrib: name, size, dataType, qualifier (guarded getattr)
  Prim: vertices;  Vertex: point;  Point: number
  Node: path, parm, parmTuple, evalParm, inputs, geometry, cookCount
  Parm/ParmTuple: eval
  hou.attribType.{Point,Global}, hou.attribData.{Float,Int,String},
  hou.NodeError / hou.NodeWarning
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from facedeform_tpu_torch.config import DeformConfig, DeformParams
from facedeform_tpu_torch.geometry.mesh import Mesh
from facedeform_tpu_torch.node import CookResult, FaceDeformNode

#: Code section for the Python SOP operator type (step 3 above).
PYTHON_SOP_CODE = """\
import hou
from facedeform_tpu_torch import houdini as fdtpu_houdini
fdtpu_houdini.cook_sop(hou.pwd())
"""

#: Declarative parameter interface, mirroring the reference PRM templates
#: (src/SOP_FaceDeform.cpp:99-137: name, label, default, range, menu) plus
#: the rebuild's documented extensions.  Each entry:
#:   (name, label, kind, default, extra)
#: kind in {"string", "menu", "float", "int", "toggle", "float2"};
#: extra is the menu item list for menus or the (lo, hi) UI range.
PARM_SPECS: List[Tuple[str, str, str, object, object]] = [
    ("group", "Group", "string", "", None),
    ("model", "Model", "menu", 0, ["QNN", "Multilayer", "Kernel zoo"]),
    ("term", "Term", "menu", 0, ["Linear", "Constant", "Zero"]),
    ("qcoef", "Q (smoothness)", "float", 1.0, (0.1, 10.0)),
    ("zcoef", "Z (deviation)", "float", 5.0, (0.1, 10.0)),
    ("radius", "Radius", "float", 1.0, (0.0, 10.0)),
    ("maxedges", "Max edges", "int", 4, (1, 20)),
    ("layers", "Layers", "int", 4, (1, 10)),
    ("lambda", "Lambda", "float", 0.1, (0.01, 10.0)),
    ("tangent", "Tangent space", "toggle", 0, None),
    ("morphspace", "Morph space", "toggle", 0, None),
    ("doclampweight", "Clamp weights", "toggle", 0, None),
    ("weightrange", "Weight range", "float2", (0.0, 1.0), (0.0, 1.0)),
    ("dofalloff", "Compute falloff", "toggle", 0, None),
    ("falloffradius", "Falloff radius", "float", 1.0, (0.0, 10.0)),
    ("falloffrate", "Falloff rate", "float", 1.0, (0.0, 2.0)),
    # --- rebuild extensions (documented in config.py) ---------------------
    ("kernel", "Kernel (zoo mode)", "menu", 0,
     ["Gaussian", "Thin plate", "Multiquadric", "Inv. multiquadric",
      "Linear", "Cubic", "Wendland C2"]),
    ("solver", "Solver", "menu", 0, ["Auto", "Direct", "Krylov",
                                     "Partition of unity"]),
    ("strict_parity", "Strict reference parity", "toggle", 0, None),
    ("dbse_robust", "Robust morph weights", "toggle", 0, None),
    ("falloff_metric", "Falloff metric", "menu", 0,
     ["Euclidean", "Geodesic"]),
    ("update_normals", "Update normals", "toggle", 0, None),
    ("transform_attrs", "Transform attributes", "string", "", None),
    ("output_stretch", "Output stretch", "toggle", 0, None),
    ("recompute_normals", "Recompute normals", "toggle", 0, None),
    ("symmetrize", "Symmetrize rig", "menu", 0, ["Off", "X", "Y", "Z"]),
    ("symmetry_tol", "Symmetry pair tolerance", "float", 0.0, (0.0, 1.0)),
    # pose-space sculpt corrections: a checkpoint fitted offline (CLI
    # --save-psd or serve fit_psd + save) applied on top of the cook —
    # the file carries kernel/normalize/align, ops/psd.py
    ("psd_file", "PSD checkpoint", "string", "", None),
    # rig decimation (ops/decimate.py): 0 = off.  Subset drops markers
    # (pivoted-Cholesky selection, cached on the rest rig); Regress keeps
    # all N markers as observations of K centers (fit_reduced, cached on
    # the posed-rig data ids so marker drags refit but UI toggles don't)
    ("reducerig", "Reduce rig to K", "int", 0, (0, 100000)),
    ("reducemode", "Reduce mode", "menu", 0, ["Subset", "Regress"]),
]

_SYMMETRIZE_NAMES = (None, "x", "y", "z")

_SOLVER_NAMES = ("auto", "direct", "krylov", "pu")

# Per-Houdini-node adapter state: the stateful FaceDeformNode (its capture /
# solve / DBSE caches) and the geometry-conversion cache per input slot.
_NODE_STATE: Dict[str, dict] = {}


def _psd_from_path(state: dict, path: str, device="cuda"):
    """Load (and cache) the PSD checkpoint named by the `psd_file` parm,
    its model on `device`.

    Cached on (path, mtime) and returned IDENTITY-STABLE across cooks so
    FaceDeformNode's external-psd host-corrections cache keys on the same
    object — re-editing the parm or replacing the file reloads.  A bad
    path/file is a hou.NodeError: the artist set it explicitly.
    """
    import hou

    import os

    try:
        key = (path, os.path.getmtime(path if os.path.exists(path)
                                      else path + ".npz"))
    except OSError as e:
        raise hou.NodeError(f"PSD checkpoint: {e}") from e
    cached = state.get("psd_cache")
    if cached is not None and cached[0] == key:
        return cached[1]
    from facedeform_tpu_torch.utils import checkpoint

    try:
        model = checkpoint.load_psd(path, device=device)
    except (OSError, ValueError) as e:
        raise hou.NodeError(f"PSD checkpoint: {e}") from e
    state["psd_cache"] = (key, model)
    return model


def clear_state(path: Optional[str] = None) -> None:
    """Drop cached adapter state for one node path (or all)."""
    if path is None:
        _NODE_STATE.clear()
    else:
        _NODE_STATE.pop(path, None)


# --------------------------------------------------------------- conversion
def mesh_from_geometry(geo, warnings: Optional[List[str]] = None) -> Mesh:
    """Convert a hou.Geometry to a :class:`Mesh`.

    Positions and numeric point attributes ride the vectorized
    ``point*AttribValues`` fast path; polygon topology becomes a -1-padded
    (F, k) index array; point groups transfer by membership.  String
    attributes are skipped with a collected warning (same contract as the
    .geo bridge, geometry/geo_io.py).
    """
    import hou

    v = len(geo.points())
    pts = np.asarray(geo.pointFloatAttribValues("P"), np.float32).reshape(v, 3)

    point_attrs: Dict[str, np.ndarray] = {}
    attr_typeinfo: Dict[str, str] = {}
    for attrib in geo.pointAttribs():
        name = attrib.name()
        if name == "P":
            continue
        # hou.Attrib.qualifier(): "Vector"/"Normal"/"Quaternion"/... —
        # carried as Mesh.attr_typeinfo so transform_attrs kind inference
        # matches Houdini's own transform semantics (guarded getattr: the
        # test mock and very old hou builds may not expose it)
        qual = str(getattr(attrib, "qualifier", lambda: "")() or "").lower()
        if qual in ("point", "vector", "normal", "quaternion", "color"):
            attr_typeinfo[name] = qual
        size = attrib.size()
        dt = attrib.dataType()
        if dt == hou.attribData.Float:
            vals = np.asarray(geo.pointFloatAttribValues(name), np.float32)
        elif dt == hou.attribData.Int:
            vals = np.asarray(geo.pointIntAttribValues(name), np.int32)
        else:
            if warnings is not None:
                warnings.append(
                    f"skipped point attribute {name!r} "
                    f"(unsupported data type {dt})"
                )
            continue
        point_attrs[name] = vals.reshape(v, size) if size > 1 else vals

    faces = None
    prims = geo.prims()
    if prims:
        # O(prims) Python loop, re-run whenever the upstream cook count
        # changes — including pure P animation where the topology is
        # identical.  Deliberately NOT cached across cooks: the declared
        # hou surface above has no version-stable topology data-id, and
        # a counts-based key can collide on an edit that rewires
        # connectivity without changing counts (silently wrong faces
        # beats seconds of Python).  Shots that need the fast path
        # should convert once and drive FaceDeformNode directly.
        polys = [[vtx.point().number() for vtx in p.vertices()] for p in prims]
        width = max(len(p) for p in polys)
        faces = np.full((len(polys), width), -1, np.int32)
        for i, p in enumerate(polys):
            faces[i, : len(p)] = p

    mesh = Mesh(points=pts, faces=faces, point_attrs=point_attrs,
                attr_typeinfo=attr_typeinfo)
    for g in geo.pointGroups():
        idx = np.asarray([p.number() for p in g.points()], np.int64)
        mesh.set_group(g.name(), idx)
    return mesh


def write_mesh_to_geometry(geo, mesh: Mesh, extra_attrs=()) -> None:
    """Write a cooked Mesh back onto a (writable) hou.Geometry in place:
    deformed P plus the produced attributes (`fd_falloff`, `Cd`, `rest`,
    DBSE `weights` detail array — src/SOP_FaceDeform.cpp:401,425,438,474-480)
    plus `extra_attrs` (CookResult.transported: the attrs update_normals /
    transform_attrs / output_stretch rewrote this cook — only what changed
    rides back, unchanged input attrs are not re-uploaded).
    """
    import hou

    # setPointFloatAttribValues accepts any buffer/sequence of floats, so
    # hand it the contiguous numpy data directly — .tolist() would box V*3
    # Python floats per cook (tens of MB of churn at film-res meshes).
    geo.setPointFloatAttribValues(
        "P", np.ascontiguousarray(mesh.points, np.float32).ravel()
    )
    for name in ("fd_falloff", "Cd", "rest") + tuple(extra_attrs):
        val = mesh.point_attrs.get(name)
        if val is None:
            continue
        val = np.ascontiguousarray(val, np.float32)
        if geo.findPointAttrib(name) is None:
            default = 0.0 if val.ndim == 1 else (0.0,) * val.shape[1]
            geo.addAttrib(hou.attribType.Point, name, default)
        geo.setPointFloatAttribValues(name, val.ravel())
    weights = mesh.detail_attrs.get("weights")
    if weights is not None:
        if geo.findGlobalAttrib("weights") is None:
            geo.addArrayAttrib(hou.attribType.Global, "weights",
                               hou.attribData.Float)
        geo.setGlobalAttribValue(
            "weights", [float(w) for w in np.asarray(weights).ravel()]
        )


# --------------------------------------------------------------- parameters
def _checked_index(idx: int, n: int, parm: str) -> int:
    """Menu-index bounds check: hand-built parm panes may carry a plain
    int channel whose value exceeds the menu — the cook contract is
    hou.NodeError, never a raw IndexError."""
    import hou

    if not 0 <= idx < n:
        raise hou.NodeError(
            f"{parm} parm value {idx} out of range (0..{n - 1})"
        )
    return idx


def _eval_parm(node, name: str, default):
    """Evaluate a parameter if it exists on the node, else the reference
    default — so a hand-built parameter interface may omit the extension
    parms and still cook."""
    p = node.parm(name)
    return p.eval() if p is not None else default


def _eval_parm_tuple(node, name: str, default):
    p = node.parmTuple(name)
    return tuple(p.eval()) if p is not None else default


def config_from_node(node) -> Tuple[DeformConfig, DeformParams, str]:
    """Read the node's parameters into (DeformConfig, DeformParams, group),
    applying the same read-time semantics as cookMySop
    (src/SOP_FaceDeform.cpp:244-263; clamps live in DeformParams.clamped
    and config __post_init__)."""
    wr = _eval_parm_tuple(node, "weightrange", (0.0, 1.0))
    solver_idx = _checked_index(
        int(_eval_parm(node, "solver", 0)), len(_SOLVER_NAMES), "solver"
    )
    cfg = DeformConfig(
        model=int(_eval_parm(node, "model", 0)),
        kernel=int(_eval_parm(node, "kernel", 0)),
        term=int(_eval_parm(node, "term", 0)),
        layers=int(_eval_parm(node, "layers", 4)),
        tangent=bool(_eval_parm(node, "tangent", 0)),
        morphspace=bool(_eval_parm(node, "morphspace", 0)),
        doclampweight=bool(_eval_parm(node, "doclampweight", 0)),
        dofalloff=bool(_eval_parm(node, "dofalloff", 0)),
        falloff_metric=(
            "geodesic" if int(_eval_parm(node, "falloff_metric", 0))
            else "euclidean"
        ),
        strict_parity=bool(_eval_parm(node, "strict_parity", 0)),
        dbse_robust=bool(_eval_parm(node, "dbse_robust", 0)),
        solver=_SOLVER_NAMES[solver_idx],
    )
    params = DeformParams(
        qcoef=float(_eval_parm(node, "qcoef", 1.0)),
        zcoef=float(_eval_parm(node, "zcoef", 5.0)),
        radius=float(_eval_parm(node, "radius", 1.0)),
        lam=float(_eval_parm(node, "lambda", 0.1)),
        falloffrate=float(_eval_parm(node, "falloffrate", 1.0)),
        falloffradius=float(_eval_parm(node, "falloffradius", 1.0)),
        weight_lo=float(wr[0]),
        weight_hi=float(wr[1]),
        maxedges=int(_eval_parm(node, "maxedges", 4)),
    )
    group = str(_eval_parm(node, "group", "")).strip()
    return cfg, params, group


def build_parm_templates():
    """PARM_SPECS as a list of hou.ParmTemplate (requires a live hou)."""
    import hou

    out = []
    for name, label, kind, default, extra in PARM_SPECS:
        if kind == "string":
            out.append(hou.StringParmTemplate(name, label, 1,
                                              default_value=(default,)))
        elif kind == "menu":
            items = tuple(str(i) for i in range(len(extra)))
            out.append(hou.MenuParmTemplate(name, label, items,
                                            menu_labels=tuple(extra),
                                            default_value=int(default)))
        elif kind == "float":
            lo, hi = extra
            out.append(hou.FloatParmTemplate(name, label, 1,
                                             default_value=(default,),
                                             min=lo, max=hi))
        elif kind == "int":
            lo, hi = extra
            out.append(hou.IntParmTemplate(name, label, 1,
                                           default_value=(default,),
                                           min=lo, max=hi))
        elif kind == "toggle":
            out.append(hou.ToggleParmTemplate(name, label,
                                              default_value=bool(default)))
        elif kind == "float2":
            lo, hi = extra
            out.append(hou.FloatParmTemplate(name, label, 2,
                                             default_value=tuple(default),
                                             min=lo, max=hi))
    return out


def apply_parm_templates(definition) -> None:
    """Install the parameter interface onto an HDA definition (install
    step 4): appends any PARM_SPECS parameters not already present."""
    ptg = definition.parmTemplateGroup()
    have = {t.name() for t in ptg.entries()}
    for t in build_parm_templates():
        if t.name() not in have:
            ptg.append(t)
    definition.setParmTemplateGroup(ptg)


# --------------------------------------------------------------------- cook
def _input_mesh(state: dict, slot: int, input_node, warnings: List[str]) -> Mesh:
    """Convert input `slot`'s geometry, cached on the upstream SOP's
    (path, cookCount, point count) so an unchanged input returns the SAME
    Mesh object — preserving its data ids, which is what keeps the
    FaceDeformNode capture/solve/DBSE caches warm across cooks (the
    reference's InputGeoID tracker, src/SOP_FaceDeform.hpp:47-64)."""
    geo = input_node.geometry()
    key = (input_node.path(), input_node.cookCount(), len(geo.points()))
    cached = state["geo_cache"].get(slot)
    if cached is not None and cached[0] == key:
        warnings += cached[2]
        return cached[1]
    conv_warnings: List[str] = []
    mesh = mesh_from_geometry(geo, conv_warnings)
    # Warnings ride the cache so a warm cook re-reports skipped attributes
    # instead of going silent once the conversion is cached.
    state["geo_cache"][slot] = (key, mesh, conv_warnings)
    warnings += conv_warnings
    return mesh


def _reduce_rig_for_cook(state, meshes, cfg, params, k, mode, warnings, device="cuda"):
    """Apply the `reducerig`/`reducemode` parms before the node cook.

    Returns (meshes, external_deformer).  Subset mode replaces the rig
    inputs with their K-marker decimation (the subset Mesh objects are
    cached so their data ids stay stable across cooks and the node's
    capture/solve caches keep holding); regress mode fits the
    reduced-basis regression (ops/decimate.fit_reduced) and hands the
    node a solved external deformer, cached on the posed-rig data ids —
    a marker drag refits, an eval-toggle flip does not.  Selection and
    the regression run on `device`.
    """
    import hou

    from facedeform_tpu_torch.deformer import Deformer
    from facedeform_tpu_torch.ops import decimate

    rest_rig, def_rig = meshes[1], meshes[2]
    n = rest_rig.num_points
    if k >= n:
        warnings.append(
            f"reduce rig: K={k} >= rig size {n}; keeping all markers"
        )
        return meshes, None
    if def_rig.num_points != n:
        # let the node's own validation raise the reference error text
        return meshes, None
    if mode == 1:
        # regress: all N markers constrain K centers
        if cfg.solver == "pu":
            raise hou.NodeError(
                "Reduce mode 'Regress' conflicts with the "
                "partition-of-unity solver (the K-center regression "
                "model is already any-N)"
            )
        # key on the FIT-relevant params only, as plain floats (an
        # eval-only slider drag must not refit), unclamped: the key
        # applies the cook-time floors itself, as the node's call sites
        # do.  fit_reduced consumes qcoef/zcoef/radius/lam + the
        # confidence attr (keyed via attr_id already).
        from facedeform_tpu_torch.deformer import fit_params_key

        key = (rest_rig.pos_id, rest_rig.attr_id, def_rig.pos_id,
               cfg.solve_view(), fit_params_key(cfg, params), k)
        cached = state.get("reduce_fit")
        if cached is not None and cached[0] == key:
            return meshes, cached[1]
        from facedeform_tpu_torch.utils import errors as err_mod

        try:
            model, report, info = decimate.fit_reduced(
                rest_rig.points, def_rig.points, k, cfg, params,
                confidence=rest_rig.attr("confidence"), device=device,
            )
            # a blown-up normal solve is a cook error, not NaN geometry
            err_mod.check_solve(report)
        except (ValueError, err_mod.SolveFailedError) as e:
            raise hou.NodeError(str(e)) from e
        d = Deformer(model=model, cfg=cfg, params=params, report=report,
                     reduced=True)
        state["reduce_fit"] = (key, d)
        warnings.append(
            f"reduce rig (regress): {n} markers -> {k} centers; fit "
            f"residual rms {info.fit_rms:.3e} over all markers "
            f"(motion scale {info.motion_scale:.3e})"
        )
        return meshes, d
    # subset: selection reads only the rest rig; the subset meshes are
    # cached by data id so repeated cooks hand the node IDENTICAL
    # objects (stable pos/attr ids -> capture/solve caches hold)
    key = (rest_rig.pos_id, rest_rig.attr_id, def_rig.pos_id,
           def_rig.attr_id, k)
    cached = state.get("reduce_subset")
    if cached is not None and cached[0] == key:
        sub_rest, sub_def = cached[1]
    else:
        sel = state.get("reduce_idx")
        if sel is None or sel[0] != (rest_rig.pos_id, k):
            idx, _rep = decimate.select_markers(rest_rig.points, k, device=device)
            state["reduce_idx"] = ((rest_rig.pos_id, k), idx)
        idx = state["reduce_idx"][1]
        sub_rest, sub_def = rest_rig.subset(idx), def_rig.subset(idx)
        state["reduce_subset"] = (key, (sub_rest, sub_def))
    meshes = list(meshes)
    meshes[1], meshes[2] = sub_rest, sub_def
    return meshes, None


def cook_sop(node, device="cuda") -> Optional[CookResult]:
    """Python SOP cook callback (the cookMySop analogue).

    Reads inputs 0/1/2(+blendshapes), runs FaceDeformNode.cook on `device`
    (the node of a Houdini path keeps the device of its first cook), writes the
    deformed geometry and produced attributes back.  Node errors surface as
    hou.NodeError (cook fails, message on the node, matching the reference's
    addError texts); non-fatal conditions as one hou.NodeWarning raised
    AFTER the geometry is written.
    """
    import hou

    from facedeform_tpu_torch.utils import errors

    state = _NODE_STATE.setdefault(
        node.path(), {"node": FaceDeformNode(device=device), "geo_cache": {}}
    )
    # hou.Node.inputs() reports unconnected intermediate slots as None;
    # compacting them would shift the mesh/rest/deform roles, so the first
    # three slots must be positionally connected.  Later None slots (gaps
    # between blendshape inputs) are simply skipped.
    raw_inputs = list(node.inputs())
    if len(raw_inputs) < 3 or any(i is None for i in raw_inputs[:3]):
        raise hou.NodeError(
            "inputs 1-3 must be connected: mesh, rest rig, deform rig"
        )
    inputs = raw_inputs[:3] + [i for i in raw_inputs[3:] if i is not None]

    warnings: List[str] = []
    meshes = [
        _input_mesh(state, slot, inp, warnings)
        for slot, inp in enumerate(inputs)
    ]
    cfg, params, group = config_from_node(node)

    tr_attrs = str(_eval_parm(node, "transform_attrs", "")).strip()
    sym_tol = float(_eval_parm(node, "symmetry_tol", 0.0))
    psd_path = str(_eval_parm(node, "psd_file", "")).strip()
    psd_model = _psd_from_path(state, psd_path, device) if psd_path else None
    red_k = int(_eval_parm(node, "reducerig", 0))
    ext_deformer = None
    if red_k > 0:
        meshes, ext_deformer = _reduce_rig_for_cook(
            state, meshes, cfg, params, red_k,
            int(_eval_parm(node, "reducemode", 0)), warnings, device,
        )
    try:
        result = state["node"].cook(
            meshes, cfg, params, group=group or None,
            deformer=ext_deformer,
            update_normals=bool(_eval_parm(node, "update_normals", 0)),
            transform_attrs=tuple(
                s for s in (p.strip() for p in tr_attrs.split(",")) if s
            ) or None,
            output_stretch=bool(_eval_parm(node, "output_stretch", 0)),
            recompute_normals=bool(
                _eval_parm(node, "recompute_normals", 0)
            ),
            symmetrize=_SYMMETRIZE_NAMES[_checked_index(
                int(_eval_parm(node, "symmetrize", 0)),
                len(_SYMMETRIZE_NAMES), "symmetrize",
            )],
            # 0 = auto (5% of median marker spacing, ops/symmetry.py)
            symmetry_tol=sym_tol if sym_tol > 0 else None,
            psd=psd_model,
        )
    except errors.FaceDeformError as e:
        raise hou.NodeError(str(e)) from e

    geo = node.geometry()
    if len(geo.points()) == 0:
        # Python SOP output starts empty: bring in the input mesh first.
        geo.merge(inputs[0].geometry())
    if len(geo.points()) != result.mesh.num_points:
        raise hou.NodeError(
            f"output geometry has {len(geo.points())} points, cook produced "
            f"{result.mesh.num_points}"
        )
    write_mesh_to_geometry(geo, result.mesh, extra_attrs=result.transported)

    warnings += result.warnings
    if warnings:
        raise hou.NodeWarning("; ".join(warnings))
    return result
