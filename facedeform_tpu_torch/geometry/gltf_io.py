"""glTF 2.0 binary (.glb) export: static meshes, baked LBS skins, and
morph-target shots (port of facedeform_tpu/geometry/gltf_io.py).

A copy of the JAX package's numpy module, so both packages write the same
bytes for the same arrays (the asset's generator string included), with
three changes: quaternions come from the port's
ops/jacobian.quaternion_from_rotation on the CPU, `load_glb_skin` returns
the port's SkinningModel with tensors on `device=`, and a LINEAR rotation
channel's adjacent keys are brought into one hemisphere before they blend
(keys of opposite sign, valid glTF, otherwise interpolate through a
near-zero quaternion: a wrong joint rotation).

The skinning decomposition (ops/skinning.py, CLI `bake-skin`) exists to
hand deformations to engines — and engines ingest glTF, not .npz.  This
module writes a self-contained .glb:

  * `save_glb(path, mesh)` — static triangle mesh (POSITION [+ NORMAL]);
  * `save_glb_skinned(path, mesh, model)` — skinned mesh: JOINTS_0 /
    WEIGHTS_0 vertex attributes, one joint node per virtual bone
    (identity inverse bind matrices — the decomposition's bind pose IS
    the rest mesh), plus an animation cycling through the training
    poses so the bake is previewable in any glTF viewer.
  * `save_glb_morph(path, mesh, frame_points)` — a deformed shot as one
    POSITION morph target per frame plus a weights animation (CLI
    `deform-seq --gltf`): the lossless route when LBS can't capture the
    deformation.  Playback at keyframe f shows frame f EXACTLY (one-hot
    weights); LINEAR interpolation between keyframes is a per-vertex
    lerp of adjacent frames.  Targets whose deltas touch few vertices
    (capture-gated / localized rigs) are written as glTF sparse
    accessors, so file size tracks the moved region, not V.

The LBS conventions line up exactly: glTF computes
`sum_j w_j * globalJoint_j * IBM_j * position` and the decomposition is
`sum_b w_vb (R_b x_v + t_b)`, so with every joint parented to an
identity armature and IBM = I, the joint local TRS (R_fb, t_fb) poses
frame f verbatim (ops/skinning.py lbs_apply).  glTF quaternions are
(x, y, z, w) order and column-major matrices — both handled here.

Writers are host-side numpy (export is an offline step); a minimal
reader (`load_glb` / `read_accessor`) backs round-trip tests and QC.

No reference-code counterpart: symek/facedeform writes deformed Houdini
geometry only (src/SOP_FaceDeform.cpp); this is a rebuild extension in
the export chain bake-skin -> engine.
"""

from __future__ import annotations

import json
import struct
from typing import Optional

import numpy as np

from facedeform_tpu_torch.utils.profiling import host_f32

_MAGIC = b"glTF"
_JSON_CHUNK = 0x4E4F534A
_BIN_CHUNK = 0x004E4942

# component types
_F32 = 5126
_U32 = 5125
_U16 = 5123
_U8 = 5121

_ARRAY_BUFFER = 34962
_ELEMENT_ARRAY_BUFFER = 34963


class _BufferBuilder:
    """Accumulates 4-byte-aligned binary blobs + matching accessors."""

    def __init__(self):
        self.blob = bytearray()
        self.views = []
        self.accessors = []

    def _align(self, n=4):
        while len(self.blob) % n:
            self.blob.append(0)

    def add_view(self, arr: np.ndarray,
                 target: Optional[int] = None) -> int:
        """Append `arr`'s bytes as a bare bufferView -> view index.

        Used by sparse accessors, whose indices/values reference
        bufferViews directly without accessors of their own."""
        self._align()
        data = np.ascontiguousarray(arr)
        offset = len(self.blob)
        self.blob.extend(data.tobytes())
        view = {"buffer": 0, "byteOffset": offset,
                "byteLength": data.nbytes}
        if target is not None:
            view["target"] = target
        self.views.append(view)
        return len(self.views) - 1

    def add(self, arr: np.ndarray, component_type: int, type_str: str,
            target: Optional[int] = None, minmax: bool = False) -> int:
        """Append `arr` (already the right dtype/layout) -> accessor index."""
        data = np.ascontiguousarray(arr)
        self.add_view(data, target=target)
        count = data.shape[0] if data.ndim > 1 else data.size
        acc = {
            "bufferView": len(self.views) - 1,
            "componentType": component_type,
            "count": int(count),
            "type": type_str,
        }
        if minmax:
            # required for POSITION; element-wise over the count axis
            flat = data.reshape(count, -1)
            acc["min"] = [float(v) for v in flat.min(0)]
            acc["max"] = [float(v) for v in flat.max(0)]
        self.accessors.append(acc)
        return len(self.accessors) - 1

    def add_sparse_vec3(self, dense: np.ndarray, idx: np.ndarray) -> int:
        """Sparse VEC3 accessor: `dense` (count, 3) f32 whose nonzero rows
        are exactly `idx` (sorted ascending, per spec) -> accessor index.

        The accessor omits `bufferView`, so unlisted rows default to
        zeros; only idx/values bytes land in the blob.  min/max still
        describe the FULL dense array (the spec requires them to cover
        the implied zeros)."""
        dense = np.ascontiguousarray(dense, np.float32)
        idx = np.ascontiguousarray(idx, np.uint32)
        acc = {
            "componentType": _F32,
            "count": int(dense.shape[0]),
            "type": "VEC3",
            "min": [float(v) for v in dense.min(0)],
            "max": [float(v) for v in dense.max(0)],
            "sparse": {
                "count": int(idx.size),
                "indices": {"bufferView": self.add_view(idx),
                            "componentType": _U32},
                "values": {"bufferView": self.add_view(dense[idx])},
            },
        }
        self.accessors.append(acc)
        return len(self.accessors) - 1


def _write_glb(path: str, gltf: dict, blob: bytes) -> None:
    js = json.dumps(gltf, separators=(",", ":")).encode()
    js += b" " * (-len(js) % 4)
    blob = bytes(blob) + b"\x00" * (-len(blob) % 4)
    total = 12 + 8 + len(js) + 8 + len(blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sII", _MAGIC, 2, total))
        f.write(struct.pack("<II", len(js), _JSON_CHUNK))
        f.write(js)
        f.write(struct.pack("<II", len(blob), _BIN_CHUNK))
        f.write(blob)


def _rot_to_quat(r: np.ndarray) -> np.ndarray:
    """(..., 3, 3) rotation matrices -> (..., 4) glTF (x, y, z, w) quats.

    Delegates to the tested branch-free Shepperd conversion
    (ops/jacobian.quaternion_from_rotation — same layout; Houdini
    `orient` and glTF agree on xyzw) so quaternion edge-case fixes live
    in exactly one place.  Quaternion sign is unconstrained (q and -q
    are the same rotation; the animation uses STEP interpolation, so
    sign flips between keyframes cannot produce slerp artifacts)."""
    import torch

    from facedeform_tpu_torch.ops.jacobian import quaternion_from_rotation

    q = quaternion_from_rotation(torch.as_tensor(np.asarray(r, np.float32), device="cpu"))
    return q.numpy().astype(np.float32)


def _mesh_primitive(bb: _BufferBuilder, mesh, extra_attrs=None) -> dict:
    """POSITION [+ NORMAL/TEXCOORD_0/COLOR_0] [+ skin attrs] primitive.

    `uv` (V, 2) or Houdini-style (V, 3) maps to TEXCOORD_0 with the V
    axis flipped (glTF's texture origin is top-left; Houdini/OBJ use
    bottom-left) — load_glb_mesh flips back, so round trips match to f32
    roundoff (the fl(1 - v) double flip costs up to ~6e-8 for v < 0.5)
    and engines sample textures correctly.  `Cd` (V, 3) maps to COLOR_0.
    """
    attrs = {
        "POSITION": bb.add(
            np.asarray(mesh.points, np.float32), _F32, "VEC3",
            target=_ARRAY_BUFFER, minmax=True,
        )
    }
    n = mesh.point_attrs.get("N")
    if n is not None and n.shape == mesh.points.shape:
        norm = np.asarray(n, np.float32)
        lens = np.linalg.norm(norm, axis=-1, keepdims=True)
        norm = norm / np.where(lens < 1e-12, 1.0, lens)  # spec: unit length
        attrs["NORMAL"] = bb.add(norm, _F32, "VEC3", target=_ARRAY_BUFFER)
    uv = mesh.point_attrs.get("uv")
    if (uv is not None and uv.ndim == 2 and uv.shape[0] == mesh.num_points
            and uv.shape[1] in (2, 3)):
        st = np.asarray(uv[:, :2], np.float32).copy()
        st[:, 1] = 1.0 - st[:, 1]
        attrs["TEXCOORD_0"] = bb.add(st, _F32, "VEC2", target=_ARRAY_BUFFER)
    cd = mesh.point_attrs.get("Cd")
    if cd is not None and cd.shape == mesh.points.shape:
        attrs["COLOR_0"] = bb.add(
            np.asarray(cd, np.float32), _F32, "VEC3", target=_ARRAY_BUFFER
        )
    if extra_attrs:
        attrs.update(extra_attrs)
    prim = {"attributes": attrs}
    tris = mesh.triangles()
    if tris is None:
        prim["mode"] = 0  # POINTS (a control rig / point cloud)
    else:
        idx = tris.reshape(-1)
        # spec: index accessors must not contain the component type's max
        # value (the primitive-restart sentinel), so 65535 forces uint32
        if idx.max(initial=0) < 65535:
            prim["indices"] = bb.add(
                idx.astype(np.uint16), _U16, "SCALAR",
                target=_ELEMENT_ARRAY_BUFFER,
            )
        else:
            prim["indices"] = bb.add(
                idx.astype(np.uint32), _U32, "SCALAR",
                target=_ELEMENT_ARRAY_BUFFER,
            )
        prim["mode"] = 4  # TRIANGLES
    return prim


def _base_gltf(bb: _BufferBuilder) -> dict:
    return {
        "asset": {"version": "2.0", "generator": "facedeform_tpu"},
        "buffers": [{"byteLength": 0}],  # patched at write time
        "bufferViews": bb.views,
        "accessors": bb.accessors,
    }


def save_glb(path: str, mesh) -> None:
    """Write a static mesh (or point cloud) as a .glb."""
    bb = _BufferBuilder()
    prim = _mesh_primitive(bb, mesh)
    gltf = _base_gltf(bb)
    gltf.update({
        "meshes": [{"primitives": [prim]}],
        "nodes": [{"mesh": 0, "name": "facedeform"}],
        "scenes": [{"nodes": [0]}],
        "scene": 0,
    })
    gltf["buffers"][0]["byteLength"] = len(bb.blob) + (-len(bb.blob) % 4)
    _write_glb(path, gltf, bb.blob)


def _bone_centroids(w: np.ndarray, rest: np.ndarray) -> np.ndarray:
    """(B, 3) weight-averaged rest positions; zero-weight bones fall back
    to the mesh centroid (they bind SOMEWHERE sensible)."""
    sw = w.sum(0)                                          # (B,)
    cent = (w.T @ rest) / np.maximum(sw, 1e-12)[:, None]
    return np.where(sw[:, None] > 1e-12, cent, rest.mean(0)[None])


def _bone_mst_parents(cent: np.ndarray, root: int) -> np.ndarray:
    """Prim MST over bone centroids (Euclidean), rooted at `root`.

    Returns (B,) parent indices with parent[root] = -1 — the proximity
    heuristic retarget/ragdoll tooling expects when no authored skeleton
    exists (nearest bones are articulation neighbors on a face/body).
    """
    b = cent.shape[0]
    parent = np.full(b, -1, np.int64)
    in_tree = np.zeros(b, bool)
    in_tree[root] = True
    d2 = ((cent - cent[root]) ** 2).sum(-1)
    best = np.full(b, root, np.int64)
    for _ in range(b - 1):
        cand = np.where(in_tree, np.inf, d2)
        j = int(np.argmin(cand))
        in_tree[j] = True
        parent[j] = best[j]
        nd = ((cent - cent[j]) ** 2).sum(-1)
        closer = ~in_tree & (nd < d2)
        d2[closer] = nd[closer]
        best[closer] = j
    return parent


def save_glb_skinned(path: str, mesh, model, fps: float = 24.0,
                     animate: bool = True, hierarchy: bool = True,
                     root: int | None = None) -> None:
    """Write a baked SkinningModel as a skinned, animated .glb.

    mesh supplies topology (+ optional normals) and must match the
    model's rest vertex count; the model supplies weights and per-pose
    bone transforms.  With `animate`, poses become keyframes at `fps`
    (STEP interpolation: training poses are samples, not a smooth arc).

    With `hierarchy` (default), joints form a proximity-MST tree over
    bone centroids rooted at `root` (default: the bone nearest the
    centroid mean): each joint's bind pose sits AT its centroid (inverse
    bind matrices translate by -centroid) and node TRS/animation are
    parent-LOCAL — what retarget/ragdoll tooling expects.  The skinning
    matrices world(joint) @ IBM reproduce lbs_apply exactly either way
    (tests/test_gltf_io.py decodes and checks).  `hierarchy=False` keeps
    the flat layout: B parentless joints under one armature node,
    identity IBMs, world-space TRS.
    """
    w = host_f32(model.weights)                           # (V, B)
    rot = host_f32(model.rotations)                       # (F, B, 3, 3)
    tra = host_f32(model.translations)                    # (F, B, 3)
    v, b = w.shape
    f_n = rot.shape[0]
    if mesh.num_points != v:
        raise ValueError(
            f"mesh has {mesh.num_points} points but the skinning model "
            f"was fitted on {v}"
        )

    # glTF budget: exactly 4 influences; take top-4 and renormalize
    k = min(4, b)
    top = np.argsort(-w, axis=1)[:, :k]                   # (V, k)
    tw = np.take_along_axis(w, top, axis=1)
    joints4 = np.zeros((v, 4), np.uint16)
    weights4 = np.zeros((v, 4), np.float32)
    joints4[:, :k] = top
    weights4[:, :k] = tw
    wsum = weights4.sum(-1, keepdims=True)
    weights4 /= np.where(wsum < 1e-12, 1.0, wsum)
    # spec: joints with zero weight SHOULD be 0
    joints4[weights4 == 0.0] = 0

    bb = _BufferBuilder()
    jtype = _U8 if b <= 256 else _U16
    jarr = joints4.astype(np.uint8) if b <= 256 else joints4
    prim = _mesh_primitive(bb, mesh, extra_attrs={
        "JOINTS_0": bb.add(jarr, jtype, "VEC4", target=_ARRAY_BUFFER),
        "WEIGHTS_0": bb.add(weights4, _F32, "VEC4", target=_ARRAY_BUFFER),
    })

    if hierarchy:
        rest = host_f32(model.rest)
        cent = _bone_centroids(w, rest)
        if root is None:
            root = int(np.argmin(((cent - cent.mean(0)) ** 2).sum(-1)))
        if not 0 <= int(root) < b:
            raise ValueError(f"root={root} out of range [0, {b})")
        parent = _bone_mst_parents(cent, int(root))
        # world joint transforms: bind pose = T(centroid), so the skin
        # matrix world(joint) @ T(-centroid) equals the LBS [R | t]
        tw = np.einsum("fbij,bj->fbi", rot, cent) + tra    # (F, B, 3)
        psafe = np.where(parent < 0, 0, parent)
        rp = rot[:, psafe]                                 # (F, B, 3, 3)
        loc_rot = np.einsum("fbji,fbjk->fbik", rp, rot)    # Rp^T Rj
        loc_tra = np.einsum("fbji,fbj->fbi", rp, tw - tw[:, psafe])
        is_root = parent < 0
        loc_rot[:, is_root] = rot[:, is_root]
        loc_tra[:, is_root] = tw[:, is_root]
        ibm = np.tile(np.eye(4, dtype=np.float32)[None], (b, 1, 1))
        ibm[:, :3, 3] = -cent
        children: list = [[] for _ in range(b)]
        for j in range(b):
            if parent[j] >= 0:
                children[parent[j]].append(2 + j)
        armature_children = [2 + int(root)]
    else:
        parent = np.full(b, -1, np.int64)
        loc_rot, loc_tra = rot, tra
        ibm = np.tile(np.eye(4, dtype=np.float32)[None], (b, 1, 1))
        children = [[] for _ in range(b)]
        armature_children = list(range(2, 2 + b))
    # glTF MAT4 accessors are column-major
    ibm_acc = bb.add(ibm.transpose(0, 2, 1).reshape(b, 16), _F32, "MAT4")

    # nodes: 0 = skinned mesh, 1 = armature root, 2.. = joints (frame-0
    # pose as the static TRS so an animation-less viewer shows pose 0)
    quats = _rot_to_quat(loc_rot)                          # (F, B, 4)
    nodes = [
        {"mesh": 0, "skin": 0, "name": "facedeform_skin"},
        {"name": "armature", "children": armature_children},
    ]
    for j in range(b):
        node = {
            "name": f"bone_{j:03d}",
            "rotation": [float(x) for x in quats[0, j]],
            "translation": [float(x) for x in loc_tra[0, j]],
        }
        if children[j]:
            node["children"] = children[j]
        nodes.append(node)

    gltf = _base_gltf(bb)
    gltf.update({
        "meshes": [{"primitives": [prim]}],
        "skins": [{
            "inverseBindMatrices": ibm_acc,
            "joints": list(range(2, 2 + b)),
            "skeleton": 1,
        }],
        "nodes": nodes,
        "scenes": [{"nodes": [0, 1]}],
        "scene": 0,
    })

    if animate and f_n > 0:
        times = (np.arange(f_n, dtype=np.float32) / float(fps))
        t_acc = bb.add(times, _F32, "SCALAR")
        # glTF wants explicit min/max on animation input accessors
        bb.accessors[t_acc]["min"] = [float(times.min())]
        bb.accessors[t_acc]["max"] = [float(times.max())]
        samplers, channels = [], []
        for j in range(b):
            r_acc = bb.add(quats[:, j], _F32, "VEC4")
            samplers.append({"input": t_acc, "output": r_acc,
                             "interpolation": "STEP"})
            channels.append({
                "sampler": len(samplers) - 1,
                "target": {"node": 2 + j, "path": "rotation"},
            })
            tr_acc = bb.add(loc_tra[:, j], _F32, "VEC3")
            samplers.append({"input": t_acc, "output": tr_acc,
                             "interpolation": "STEP"})
            channels.append({
                "sampler": len(samplers) - 1,
                "target": {"node": 2 + j, "path": "translation"},
            })
        gltf["animations"] = [{
            "name": "bake_poses", "samplers": samplers, "channels": channels,
        }]

    gltf["buffers"][0]["byteLength"] = len(bb.blob) + (-len(bb.blob) % 4)
    _write_glb(path, gltf, bb.blob)


def save_glb_targets(path: str, mesh, targets: np.ndarray,
                     weights: np.ndarray, fps: float = 24.0,
                     names=None, animate: bool = True) -> None:
    """Write a morph-target basis + weight curves as one .glb.

    `targets` is (K, V, 3) rest-relative POSITION deltas; `weights` is
    (F, K) per-frame weight rows animated at `fps` with LINEAR
    interpolation, so keyframe f shows ``rest + weights[f] @ targets``
    exactly.  The mesh's default (static-viewer) weights are row 0.
    Localized targets are written as glTF sparse accessors (16 bytes/row
    vs 12 dense → sparse wins below nnz < 0.75 V).

    This is the general form behind `save_glb_morph` (one-hot weights)
    and the compressed `bake-shapes`/`--gltf-rank` route
    (ops/blendshapes.py PCA bakes).  No reference-code counterpart
    (symek/facedeform writes deformed Houdini geometry only,
    src/SOP_FaceDeform.cpp:404-439).
    """
    targets = host_f32(targets)
    weights = host_f32(weights)
    if targets.ndim != 3 or targets.shape[-1] != 3:
        raise ValueError(f"targets must be (K, V, 3), got {targets.shape}")
    k_n, v = targets.shape[:2]
    if mesh.num_points != v:
        raise ValueError(
            f"mesh has {mesh.num_points} points but targets have {v}"
        )
    if weights.ndim != 2 or weights.shape[1] != k_n:
        raise ValueError(
            f"weights must be (F, {k_n}), got {weights.shape}"
        )
    f_n = weights.shape[0]
    if names is None:
        names = [f"target_{k:03d}" for k in range(k_n)]
    elif len(names) != k_n:
        raise ValueError(f"{len(names)} names for {k_n} targets")

    bb = _BufferBuilder()
    prim = _mesh_primitive(bb, mesh)
    target_accs = []
    for k in range(k_n):
        delta = targets[k]
        idx = np.flatnonzero(np.any(delta != 0.0, axis=1))
        if idx.size * 16 < v * 12:
            if idx.size == 0:
                idx = np.array([0], np.int64)  # spec: sparse count >= 1
            acc = bb.add_sparse_vec3(delta, idx)
        else:
            acc = bb.add(delta, _F32, "VEC3", target=_ARRAY_BUFFER,
                         minmax=True)
        target_accs.append({"POSITION": acc})
    prim["targets"] = target_accs

    default_w = weights[0] if f_n else np.zeros(k_n, np.float32)
    gltf = _base_gltf(bb)
    gltf.update({
        "meshes": [{
            "primitives": [prim],
            "weights": [float(w) for w in default_w],
            "extras": {"targetNames": [str(n) for n in names]},
        }],
        "nodes": [{"mesh": 0, "name": "facedeform_shot"}],
        "scenes": [{"nodes": [0]}],
        "scene": 0,
    })

    if animate and f_n > 0:
        times = np.arange(f_n, dtype=np.float32) / float(fps)
        t_acc = bb.add(times, _F32, "SCALAR")
        bb.accessors[t_acc]["min"] = [float(times.min())]
        bb.accessors[t_acc]["max"] = [float(times.max())]
        w_acc = bb.add(weights.reshape(-1), _F32, "SCALAR")
        gltf["animations"] = [{
            "name": "shot",
            "samplers": [{"input": t_acc, "output": w_acc,
                          "interpolation": "LINEAR"}],
            "channels": [{"sampler": 0,
                          "target": {"node": 0, "path": "weights"}}],
        }]

    gltf["buffers"][0]["byteLength"] = len(bb.blob) + (-len(bb.blob) % 4)
    _write_glb(path, gltf, bb.blob)


def save_glb_morph(path: str, mesh, frame_points: np.ndarray,
                   fps: float = 24.0, animate: bool = True) -> None:
    """Write a deformed shot as morph targets on the rest mesh.

    `mesh` is the rest-pose mesh (topology + optional normals);
    `frame_points` is (F, V, 3) deformed positions — one POSITION morph
    target per frame holding `frame_f - rest` deltas.  The weights
    animation is one-hot per keyframe at `fps` with LINEAR
    interpolation, so keyframe f reproduces frame f exactly and
    between-keyframe playback is a per-vertex lerp of adjacent frames.
    Static viewers (no animation playback) show frame 0 via the mesh's
    default weights.

    Targets whose deltas touch few vertices are written as glTF sparse
    accessors: a sparse row costs 16 bytes (u32 index + vec3 value) vs
    12 dense, so sparse wins below nnz < 0.75 V — exactly the
    capture-gated case where most of the face never moves.

    Complements `save_glb_skinned`: the skin is compact and
    engine-riggable but lossy (LBS residual); this is exact at every
    keyframe at O(moved vertices x frames) bytes.  No reference-code
    counterpart (symek/facedeform writes deformed Houdini geometry
    only, src/SOP_FaceDeform.cpp); rebuild extension in the
    deform-seq -> engine export chain.
    """
    frame_points = host_f32(frame_points)
    if frame_points.ndim != 3 or frame_points.shape[-1] != 3:
        raise ValueError(
            f"frame_points must be (F, V, 3), got {frame_points.shape}"
        )
    f_n, v = frame_points.shape[:2]
    if mesh.num_points != v:
        raise ValueError(
            f"mesh has {mesh.num_points} points but frame_points has {v}"
        )
    rest = np.asarray(mesh.points, np.float32)
    save_glb_targets(
        path, mesh, frame_points - rest[None], np.eye(f_n, dtype=np.float32),
        fps=fps, names=[f"frame_{f:04d}" for f in range(f_n)],
        animate=animate,
    )


# ------------------------------------------------------------------ reading
_CT_DTYPE = {_F32: np.float32, _U32: np.uint32, _U16: np.uint16,
             _U8: np.uint8, 5120: np.int8, 5122: np.int16}
_TYPE_WIDTH = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
               "MAT2": 4, "MAT3": 9, "MAT4": 16}


def load_glb(path: str):
    """Parse a .glb -> (gltf dict, binary chunk bytes)."""
    with open(path, "rb") as f:
        magic, version, _total = struct.unpack("<4sII", f.read(12))
        if magic != _MAGIC:
            raise ValueError(f"{path} is not a glTF binary (bad magic)")
        if version != 2:
            raise ValueError(f"unsupported glTF version {version}")
        gltf, blob = None, b""
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            length, ctype = struct.unpack("<II", header)
            data = f.read(length)
            if ctype == _JSON_CHUNK:
                gltf = json.loads(data)
            elif ctype == _BIN_CHUNK:
                blob = data
    if gltf is None:
        raise ValueError(f"{path} has no JSON chunk")
    return gltf, blob


def _read_view(gltf: dict, blob: bytes, view_index: int, dtype,
               extra_offset: int = 0, count: Optional[int] = None,
               width: int = 1) -> np.ndarray:
    view = gltf["bufferViews"][view_index]
    start = view.get("byteOffset", 0) + extra_offset
    if count is None:
        count = view["byteLength"] // (np.dtype(dtype).itemsize * width)
    return np.frombuffer(
        blob, dtype=dtype, count=count * width, offset=start
    ).reshape(count, width)


def read_accessor(gltf: dict, blob: bytes, index: int) -> np.ndarray:
    """Decode accessor `index` -> (count, width) array (width-1 squeezed).

    Tightly-packed accessors only — which is all this writer emits.
    Sparse accessors (morph-target deltas) decode to their dense form:
    the base is the referenced bufferView, or zeros when the accessor
    omits one (the save_glb_morph case)."""
    acc = gltf["accessors"][index]
    dtype = _CT_DTYPE[acc["componentType"]]
    width = _TYPE_WIDTH[acc["type"]]
    count = acc["count"]
    if "bufferView" in acc:
        arr = _read_view(
            gltf, blob, acc["bufferView"], dtype,
            extra_offset=acc.get("byteOffset", 0), count=count, width=width,
        )
    else:
        arr = np.zeros((count, width), dtype)
    sp = acc.get("sparse")
    if sp is not None:
        n = sp["count"]
        idx = _read_view(
            gltf, blob, sp["indices"]["bufferView"],
            _CT_DTYPE[sp["indices"]["componentType"]],
            extra_offset=sp["indices"].get("byteOffset", 0), count=n,
        )[:, 0]
        vals = _read_view(
            gltf, blob, sp["values"]["bufferView"], dtype,
            extra_offset=sp["values"].get("byteOffset", 0),
            count=n, width=width,
        )
        arr = arr.copy()
        arr[idx.astype(np.int64)] = vals
    return arr[:, 0] if width == 1 else arr


def load_glb_mesh(path: str, mesh_index: int = 0):
    """Read mesh `mesh_index` of a .glb back into a Mesh.

    Engine assets come as glTF; this makes `.glb` a first-class input
    everywhere a `.obj`/`.geo` is accepted (geometry.load_mesh dispatch,
    so CLI mesh/rig/blendshape arguments too).  Decodes POSITION
    [+ NORMAL -> `N`, TEXCOORD_0 -> `uv` (V flipped back to bottom-left
    origin), COLOR_0 -> `Cd` (normalized integer colors rescaled)] and
    triangle indices across all primitives of the mesh (vertex offsets
    composed); POINTS primitives contribute positions only.  Morph
    targets and skins load through the sibling readers
    (`load_glb_blendshapes` -> blendshape Meshes for the morphspace
    pass, `load_glb_skin` -> a SkinningModel); non-joint animation data
    is ignored — the rest geometry here is what a deform cook consumes.
    """
    from facedeform_tpu_torch.geometry.mesh import Mesh

    gltf, blob = load_glb(path)
    meshes = gltf.get("meshes") or []
    if mesh_index >= len(meshes):
        raise ValueError(
            f"{path} has {len(meshes)} meshes, asked for #{mesh_index}"
        )
    pts, norms, tris = [], [], []
    uvs, colors = [], []
    offset = 0
    for prim in meshes[mesh_index]["primitives"]:
        attrs = prim["attributes"]
        if "POSITION" not in attrs:
            continue
        p = read_accessor(gltf, blob, attrs["POSITION"]).astype(np.float32)
        mode = prim.get("mode", 4)
        if mode == 4:  # TRIANGLES
            if "indices" in prim:
                idx = read_accessor(
                    gltf, blob, prim["indices"]
                ).astype(np.int32)
            else:
                idx = np.arange(len(p), dtype=np.int32)
            tris.append(idx.reshape(-1, 3) + offset)
        elif mode != 0:  # strips/fans/lines: out of scope for a writer
            raise ValueError(
                f"{path}: unsupported primitive mode {mode} "
                "(triangles and points only)"
            )
        pts.append(p)
        if "NORMAL" in attrs:
            norms.append(read_accessor(
                gltf, blob, attrs["NORMAL"]
            ).astype(np.float32))
        if "TEXCOORD_0" in attrs:
            acc = gltf["accessors"][attrs["TEXCOORD_0"]]
            st = read_accessor(
                gltf, blob, attrs["TEXCOORD_0"]
            ).astype(np.float32)[:, :2].copy()
            if acc.get("normalized"):
                # quantized engine assets store normalized ubyte/ushort UVs
                st /= float(np.iinfo(_CT_DTYPE[acc["componentType"]]).max)
            st[:, 1] = 1.0 - st[:, 1]  # back to bottom-left origin
            uvs.append(st)
        if "COLOR_0" in attrs:
            acc = gltf["accessors"][attrs["COLOR_0"]]
            c = read_accessor(
                gltf, blob, attrs["COLOR_0"]
            ).astype(np.float32)
            if acc.get("normalized"):
                # external assets may store normalized ubyte/ushort colors
                c = c / float(np.iinfo(_CT_DTYPE[acc["componentType"]]).max)
            colors.append(c[:, :3])  # VEC4 loses alpha (Cd is RGB)
        offset += len(p)
    if not pts:
        raise ValueError(f"{path}: mesh #{mesh_index} has no POSITION data")
    mesh = Mesh(
        points=np.concatenate(pts),
        faces=np.concatenate(tris) if tris else None,
    )
    if norms and sum(len(n) for n in norms) == mesh.num_points:
        mesh.set_attr("N", np.concatenate(norms))
    # attach only when every primitive carried the attribute (a partial
    # concat would misalign rows with vertices)
    if uvs and sum(len(u) for u in uvs) == mesh.num_points:
        mesh.set_attr("uv", np.concatenate(uvs))
    if colors and sum(len(c) for c in colors) == mesh.num_points:
        mesh.set_attr("Cd", np.concatenate(colors))
    return mesh


def load_glb_blendshapes(path: str, mesh_index: int = 0):
    """Read a morph-target .glb back into morphspace-pass inputs.

    Closes the engine round trip the export side opened: an engine asset
    carrying blendshapes feeds the DBSE/morphspace pass (the reference's
    blendshape input role, src/dbse.cpp:9-35) without pre-splitting.

    Returns ``(rest_mesh, shapes, names, anim_weights)``:

      * rest_mesh — the base Mesh (as `load_glb_mesh`);
      * shapes — one Mesh per morph target at ``rest + delta`` (POSITION
        deltas; sparse accessors decode densely), topology shared with
        the rest mesh.  Exactly what node.cook takes as inputs 3+ /
        the CLI takes as repeated --blend arguments;
      * names — target names (mesh extras.targetNames, or target_###);
      * anim_weights — (F, K) per-keyframe weight rows when the file
        carries a weights animation for this mesh (save_glb_targets
        writes one), else None.
    """
    gltf, blob = load_glb(path)
    meshes = gltf.get("meshes") or []
    if mesh_index >= len(meshes):
        raise ValueError(
            f"{path} has {len(meshes)} meshes, asked for #{mesh_index}"
        )
    rest_mesh = load_glb_mesh(path, mesh_index)
    prims = meshes[mesh_index]["primitives"]
    n_targets = {len(p.get("targets", ())) for p in prims
                 if "POSITION" in p["attributes"]}
    if not n_targets or n_targets == {0}:
        return rest_mesh, [], [], None
    if len(n_targets) != 1:
        raise ValueError(
            f"{path}: primitives disagree on morph-target count "
            f"{sorted(n_targets)} (spec requires all primitives of a "
            "mesh to declare the same targets)"
        )
    k_n = n_targets.pop()
    deltas = []
    for k in range(k_n):
        parts = []
        for prim in prims:
            if "POSITION" not in prim["attributes"]:
                continue
            tgt = prim["targets"][k]
            if "POSITION" not in tgt:
                n_prim = gltf["accessors"][
                    prim["attributes"]["POSITION"]]["count"]
                parts.append(np.zeros((n_prim, 3), np.float32))
            else:
                parts.append(read_accessor(
                    gltf, blob, tgt["POSITION"]
                ).astype(np.float32))
        deltas.append(np.concatenate(parts))
    names = list(
        (meshes[mesh_index].get("extras") or {}).get("targetNames")
        or [f"target_{k:03d}" for k in range(k_n)]
    )
    if len(names) != k_n:
        names = [f"target_{k:03d}" for k in range(k_n)]

    from facedeform_tpu_torch.geometry.mesh import Mesh

    rest = np.asarray(rest_mesh.points, np.float32)
    shapes = [
        Mesh(points=rest + d, faces=rest_mesh.faces) for d in deltas
    ]

    # weights animation: the channel targeting a node holding this mesh
    # with path "weights" (save_glb_targets writes exactly one)
    anim_weights = None
    mesh_nodes = {
        i for i, nd in enumerate(gltf.get("nodes") or [])
        if nd.get("mesh") == mesh_index
    }
    for anim in gltf.get("animations") or ():
        for ch in anim.get("channels", ()):
            tgt = ch.get("target", {})
            if tgt.get("path") == "weights" and tgt.get("node") in mesh_nodes:
                sampler = anim["samplers"][ch["sampler"]]
                flat = np.asarray(
                    read_accessor(gltf, blob, sampler["output"]), np.float32
                ).reshape(-1, k_n)
                if sampler.get("interpolation") == "CUBICSPLINE":
                    # output triples (in-tangent, value, out-tangent)
                    # per keyframe: keep the value rows only, same as
                    # _sample_channel does for the skin TRS channels
                    flat = flat.reshape(-1, 3, k_n)[:, 1, :]
                anim_weights = flat
                break
        if anim_weights is not None:
            break
    return rest_mesh, shapes, names, anim_weights


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    """(..., 4) glTF (x, y, z, w) unit quaternions -> (..., 3, 3)."""
    q = np.asarray(q, np.float64)
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-30)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = np.empty(q.shape[:-1] + (3, 3), np.float64)
    r[..., 0, 0] = 1 - 2 * (y * y + z * z)
    r[..., 0, 1] = 2 * (x * y - z * w)
    r[..., 0, 2] = 2 * (x * z + y * w)
    r[..., 1, 0] = 2 * (x * y + z * w)
    r[..., 1, 1] = 1 - 2 * (x * x + z * z)
    r[..., 1, 2] = 2 * (y * z - x * w)
    r[..., 2, 0] = 2 * (x * z - y * w)
    r[..., 2, 1] = 2 * (y * z + x * w)
    r[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return r


def _node_trs(nd: dict) -> np.ndarray:
    """A node's static local transform as a 4x4 (matrix or T*R*S)."""
    if "matrix" in nd:
        return np.asarray(nd["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "rotation" in nd:
        m[:3, :3] = _quat_to_rot(np.asarray(nd["rotation"]))
    if "scale" in nd:
        m[:3, :3] = m[:3, :3] * np.asarray(nd["scale"], np.float64)[None, :]
    if "translation" in nd:
        m[:3, 3] = np.asarray(nd["translation"], np.float64)
    return m


def _sample_channel(times, out, t, interpolation, rotation=False):
    """Sample one animation channel at time t (STEP or LINEAR; LINEAR
    on rotations is nlerp — adjacent keys, adequate for re-bake parity).
    CUBICSPLINE output triples are reduced to their in-tangent-free
    value rows (a rare authoring choice; exactness not promised).

    With `rotation`, a LINEAR blend first negates the later key when the
    two keys lie in opposite hemispheres (q and -q are one rotation) and
    renormalizes the result: the standard nlerp neighbourhood rule."""
    times = np.asarray(times, np.float64)
    if interpolation == "CUBICSPLINE":
        out = out[1::3]
    if t <= times[0]:
        return out[0]
    if t >= times[-1]:
        return out[-1]
    i = int(np.searchsorted(times, t, side="right") - 1)
    if interpolation == "STEP":
        return out[i]
    a = (t - times[i]) / max(times[i + 1] - times[i], 1e-12)
    nxt = out[i + 1]
    if rotation and float(np.dot(out[i], nxt)) < 0.0:
        nxt = -nxt
    q = (1.0 - a) * out[i] + a * nxt
    if rotation:
        q = q / max(float(np.linalg.norm(q)), 1e-30)
    return q


def load_glb_skin(path: str, skin_index: int = 0, device="cuda"):
    """Read a skinned .glb back into an ops.skinning.SkinningModel with
    float32 tensors on `device`.

    Decodes JOINTS_0/WEIGHTS_0 into dense (V, B) weights and composes,
    per animation keyframe, each joint's world transform through the
    node hierarchy times its inverse bind matrix — the glTF skin matrix
    ``world(joint) @ IBM``, which IS the LBS ``[R | t]`` this package's
    lbs_apply consumes (the conventions line up; see the module
    docstring).  Without an animation the single frame is the nodes'
    static TRS pose.  Returns ``(model, times)`` with times the keyframe
    seconds ((F,) f32; [0] when static).

    Covers what the exporter writes (flat or MST-hierarchy joints, STEP
    keys) plus plain external assets (matrix nodes, scales, LINEAR keys
    via nlerp).  The skinned mesh node's own transform is ignored, as
    glTF requires for skinned meshes.
    """
    import torch

    from facedeform_tpu_torch.ops.skinning import SkinningModel

    gltf, blob = load_glb(path)
    skins = gltf.get("skins") or []
    if skin_index >= len(skins):
        raise ValueError(
            f"{path} has {len(skins)} skins, asked for #{skin_index}"
        )
    skin = skins[skin_index]
    joints = list(skin["joints"])
    b = len(joints)
    nodes = gltf.get("nodes") or []

    # the skinned mesh: the node that references this skin
    mesh_idx = None
    for nd in nodes:
        if nd.get("skin") == skin_index and "mesh" in nd:
            mesh_idx = nd["mesh"]
            break
    if mesh_idx is None:
        raise ValueError(f"{path}: no node uses skin #{skin_index}")
    prims = gltf["meshes"][mesh_idx]["primitives"]

    rest_parts, j_parts, w_parts = [], [], []
    for prim in prims:
        attrs = prim["attributes"]
        if "POSITION" not in attrs:
            continue
        rest_parts.append(
            read_accessor(gltf, blob, attrs["POSITION"]).astype(np.float32)
        )
        if "JOINTS_0" not in attrs or "WEIGHTS_0" not in attrs:
            raise ValueError(
                f"{path}: skinned primitive lacks JOINTS_0/WEIGHTS_0"
            )
        j_parts.append(read_accessor(
            gltf, blob, attrs["JOINTS_0"]
        ).astype(np.int64))
        wacc = gltf["accessors"][attrs["WEIGHTS_0"]]
        wv = read_accessor(gltf, blob, attrs["WEIGHTS_0"]).astype(np.float32)
        if wacc.get("normalized"):
            wv /= float(np.iinfo(_CT_DTYPE[wacc["componentType"]]).max)
        w_parts.append(wv)
    rest = np.concatenate(rest_parts)
    j4 = np.concatenate(j_parts)
    w4 = np.concatenate(w_parts)
    v = rest.shape[0]
    weights = np.zeros((v, b), np.float32)
    np.add.at(weights, (np.arange(v)[:, None], j4), w4)

    if "inverseBindMatrices" in skin:
        ibm = read_accessor(
            gltf, blob, skin["inverseBindMatrices"]
        ).astype(np.float64).reshape(b, 4, 4).transpose(0, 2, 1)  # col-major
    else:
        ibm = np.tile(np.eye(4)[None], (b, 1, 1))

    parent = np.full(len(nodes), -1, np.int64)
    for i, nd in enumerate(nodes):
        for c in nd.get("children", ()):
            parent[c] = i

    # keyframe times: union of the joint channels' inputs (one shared
    # input accessor in files this package writes).  Animated NON-joint
    # ancestors count too: a DCC armature root (parent of every joint,
    # itself outside skin.joints) carrying object-level/root-motion
    # animation flows into every joint's world transform through the
    # parent chain (skipping it would freeze the root at its static TRS).
    anims = gltf.get("animations") or []
    true_joints = set(joints)
    track_set = set(joints)  # joints + their non-joint ancestors
    for j in joints:
        p = int(parent[j])
        while p >= 0 and p not in track_set:
            track_set.add(p)
            p = int(parent[p])
    # Clip selection: prefer the first clip animating at least one
    # ACTUAL joint — an ancestor-only clip (a turntable/root-motion
    # track) must not shadow a later clip carrying the real joint
    # channels and freeze the skeleton.  But when NO clip touches a true
    # joint, an ancestor-only clip is the animation (static pose + baked
    # object motion), so it is the fallback rather than dropped.
    # Accessor decode happens only for the selected clip (clips are
    # screened on channel targets alone).
    chosen = fallback = None
    for anim in anims:
        tracked = [
            ch for ch in anim.get("channels", ())
            if ch.get("target", {}).get("node") in track_set
            and ch.get("target", {}).get("path") in (
                "rotation", "translation", "scale"
            )
        ]
        if not tracked:
            continue
        if any(ch["target"]["node"] in true_joints for ch in tracked):
            chosen = (anim, tracked)
            break
        if fallback is None:
            fallback = (anim, tracked)
    sel = chosen or fallback
    channels = []  # (node, path, times, out, interpolation)
    if sel is not None:
        anim, tracked = sel
        for ch in tracked:
            s = anim["samplers"][ch["sampler"]]
            channels.append((
                ch["target"]["node"], ch["target"]["path"],
                np.asarray(read_accessor(gltf, blob, s["input"]),
                           np.float64).reshape(-1),
                np.asarray(read_accessor(gltf, blob, s["output"]),
                           np.float64),
                s.get("interpolation", "LINEAR"),
            ))
    if channels:
        times = np.unique(np.concatenate([c[2] for c in channels]))
    else:
        times = np.zeros(1)

    by_node: dict = {}
    for node, pth, tms, out, interp in channels:
        by_node.setdefault(node, {})[pth] = (tms, out, interp)

    def local_at(i: int, t: float) -> np.ndarray:
        nd = nodes[i]
        ch = by_node.get(i)
        if not ch:
            return _node_trs(nd)
        m = np.eye(4)
        if "rotation" in ch:
            q = _sample_channel(*ch["rotation"][:2], t, ch["rotation"][2],
                                rotation=True)
            rr = _quat_to_rot(q)
        elif "rotation" in nd:
            rr = _quat_to_rot(np.asarray(nd["rotation"]))
        else:
            rr = np.eye(3)
        if "scale" in ch:
            sc = _sample_channel(*ch["scale"][:2], t, ch["scale"][2])
        else:
            sc = np.asarray(nd.get("scale", (1.0, 1.0, 1.0)), np.float64)
        m[:3, :3] = rr * sc[None, :]
        if "translation" in ch:
            m[:3, 3] = _sample_channel(
                *ch["translation"][:2], t, ch["translation"][2]
            )
        else:
            m[:3, 3] = np.asarray(
                nd.get("translation", (0.0, 0.0, 0.0)), np.float64
            )
        return m

    def world_at(i: int, t: float, memo: dict) -> np.ndarray:
        if i in memo:
            return memo[i]
        m = local_at(i, t)
        p = parent[i]
        if p >= 0:
            m = world_at(int(p), t, memo) @ m
        memo[i] = m
        return m

    f_n = len(times)
    rot = np.empty((f_n, b, 3, 3), np.float32)
    tra = np.empty((f_n, b, 3), np.float32)
    for f, t in enumerate(times):
        memo: dict = {}
        for jj, node_i in enumerate(joints):
            m = world_at(int(node_i), float(t), memo) @ ibm[jj]
            rot[f, jj] = m[:3, :3]
            tra[f, jj] = m[:3, 3]
    model = SkinningModel(*(
        torch.as_tensor(a, device=device) for a in (weights, rot, tra, rest)
    ))
    return model, times.astype(np.float32)
