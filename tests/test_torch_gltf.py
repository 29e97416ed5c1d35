"""PyTorch port: glTF I/O (geometry/gltf_io.py) against the JAX package's
facedeform_tpu.geometry.gltf_io, CPU tensors.

The writers must produce byte-identical files from the same arrays (the
port's skinned writer takes the port's SkinningModel of tensors); each
package's loaders read the other's files to equal arrays.  Skinned files
differ only in the joint quaternions, by at most QUAT_ULP units in the
last place: both packages normalize by rsqrt, which XLA:CPU computes
from the processor's approximate reciprocal square root and a Newton
step and torch computes otherwise (on 1e5 random inputs they differ in
29%, and XLA's is not the correctly rounded one in 12%), so no port can
reproduce XLA's bits on every processor.  Every other byte is equal.
The one deliberate difference: a LINEAR rotation channel whose adjacent
keys lie in opposite hemispheres blends through a near-zero quaternion in
the JAX reader and to the right joint in the port's (the port negates the
later key first), shown on a hand-edited file.
"""

import numpy as np
import pytest
import torch

from facedeform_tpu.geometry import gltf_io as jg
from facedeform_tpu.geometry.mesh import Mesh as JMesh
from facedeform_tpu.geometry.primitives import uv_sphere
from facedeform_tpu.ops import skinning as jsk
from facedeform_tpu_torch.geometry import gltf_io as tg
from facedeform_tpu_torch.geometry.mesh import Mesh
from facedeform_tpu_torch.ops import skinning as tsk

ROT_TOL = 1e-5   # a decoded joint rotation against the one the keys encode
QUAT_ULP = 2     # skinned files' quaternion components, units in the last place


def _mesh(cls, n=12, attrs=True, seed=0):
    m = uv_sphere(n, n)
    mesh = cls(points=m.points, faces=m.faces)
    if attrs:
        rng = np.random.default_rng(seed)
        mesh.set_attr("N", m.points / np.linalg.norm(m.points, axis=1, keepdims=True))
        mesh.set_attr("uv", rng.random((m.num_points, 2)).astype(np.float32))
        mesh.set_attr("Cd", rng.random((m.num_points, 3)).astype(np.float32))
    return mesh


def _rz(deg):
    a = np.radians(deg)
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
                    np.float32)


def _skin_arrays(v, b=5, f=3, seed=1):
    """A JAX fit of a bent sphere: weights, transforms and rest."""
    pts = uv_sphere(12, 12).points
    rng = np.random.default_rng(seed)
    frames = np.stack([pts @ _rz(10.0 * (k + 1)).T * (pts[:, 1:2] > 0)
                       + pts * (pts[:, 1:2] <= 0)
                       + 0.01 * rng.standard_normal(pts.shape).astype(np.float32)
                       for k in range(f)]).astype(np.float32)
    model, _ = jsk.fit_skinning(pts, frames, n_bones=b, max_influences=4, seed=0)
    return {k: np.asarray(getattr(model, k)) for k in model._fields}


def _as_port(arrays):
    return tsk.SkinningModel(**{k: torch.tensor(v) for k, v in arrays.items()})


def _as_jax(arrays):
    return jsk.SkinningModel(**arrays)


def _same_bytes(tmp_path, name, write_jax, write_port):
    jp, tp = tmp_path / f"j_{name}.glb", tmp_path / f"t_{name}.glb"
    write_jax(str(jp))
    write_port(str(tp))
    assert tp.read_bytes() == jp.read_bytes()
    return str(jp), str(tp)


@pytest.mark.parametrize("attrs", [True, False], ids=["attrs", "plain"])
def test_save_glb_bytes_and_load(tmp_path, attrs):
    jm, tm = _mesh(JMesh, attrs=attrs), _mesh(Mesh, attrs=attrs)
    jp, tp = _same_bytes(tmp_path, "static", lambda p: jg.save_glb(p, jm),
                         lambda p: tg.save_glb(p, tm))
    for reader, path in ((tg.load_glb_mesh, jp), (jg.load_glb_mesh, tp)):
        got, want = reader(path), jg.load_glb_mesh(jp)
        np.testing.assert_array_equal(got.points, want.points)
        np.testing.assert_array_equal(got.faces, want.faces)
        assert sorted(got.point_attrs) == sorted(want.point_attrs)
        for k in want.point_attrs:
            np.testing.assert_array_equal(got.point_attrs[k], want.point_attrs[k])


def test_save_glb_point_cloud_bytes(tmp_path):
    pts = np.random.default_rng(3).random((40, 3)).astype(np.float32)
    _same_bytes(tmp_path, "points", lambda p: jg.save_glb(p, JMesh(points=pts)),
                lambda p: tg.save_glb(p, Mesh(points=pts)))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max(initial=0))


def _same_skinned(jp, tp):
    """Two skinned files equal byte for byte but for the joints'
    quaternions (node rotations, rotation keys), within QUAT_ULP."""
    (jj, jb), (tj, tb) = jg.load_glb(jp), tg.load_glb(tp)
    rot_views = {jj["accessors"][s["output"]]["bufferView"]
                 for a in jj.get("animations", ()) for s in a["samplers"]
                 if jj["accessors"][s["output"]]["type"] == "VEC4"}
    for nj, nt in zip(jj["nodes"], tj["nodes"]):
        if "rotation" in nj:
            assert _ulps(nt.pop("rotation"), nj.pop("rotation")) <= QUAT_ULP
    assert tj == jj
    assert len(tb) == len(jb)
    for i, view in enumerate(jj["bufferViews"]):
        lo, hi = view["byteOffset"], view["byteOffset"] + view["byteLength"]
        if i in rot_views:
            assert _ulps(np.frombuffer(tb[lo:hi], np.float32),
                         np.frombuffer(jb[lo:hi], np.float32)) <= QUAT_ULP
        else:
            assert tb[lo:hi] == jb[lo:hi]


@pytest.mark.parametrize("hierarchy", [True, False], ids=["mst", "flat"])
def test_save_glb_skinned_bytes_and_load_skin(tmp_path, hierarchy):
    arrays = _skin_arrays(None)
    jp, tp = str(tmp_path / "j.glb"), str(tmp_path / "t.glb")
    jg.save_glb_skinned(jp, _mesh(JMesh), _as_jax(arrays), fps=12.0, hierarchy=hierarchy)
    tg.save_glb_skinned(tp, _mesh(Mesh), _as_port(arrays), fps=12.0, hierarchy=hierarchy)
    _same_skinned(jp, tp)
    for path in (jp, tp):
        want, want_times = jg.load_glb_skin(path)
        got, times = tg.load_glb_skin(path, device="cpu")
        assert isinstance(got.weights, torch.Tensor) and got.weights.device.type == "cpu"
        np.testing.assert_array_equal(times, want_times)
        for k in got._fields:
            np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
    # the round trip reproduces the model: the top-4 weights, the rest and
    # the per-frame transforms within float32
    got, _ = tg.load_glb_skin(tp, device="cpu")
    np.testing.assert_array_equal(got.rest.numpy(), arrays["rest"])
    np.testing.assert_allclose(got.weights.numpy(), arrays["weights"], atol=1e-6)
    np.testing.assert_allclose(got.rotations.numpy(), arrays["rotations"], atol=1e-5)
    np.testing.assert_allclose(got.translations.numpy(), arrays["translations"], atol=1e-5)


def test_save_glb_skinned_no_animation_bytes(tmp_path):
    arrays = _skin_arrays(None)
    jp, tp = str(tmp_path / "j.glb"), str(tmp_path / "t.glb")
    jg.save_glb_skinned(jp, _mesh(JMesh), _as_jax(arrays), animate=False)
    tg.save_glb_skinned(tp, _mesh(Mesh), _as_port(arrays), animate=False)
    _same_skinned(jp, tp)


def _targets(v, k=4, seed=2):
    rng = np.random.default_rng(seed)
    t = 0.05 * rng.standard_normal((k, v, 3)).astype(np.float32)
    t[1, 20:] = 0.0            # a localized target: written sparse
    t[2] = 0.0                 # an empty one: a sparse count of one
    return t, rng.random((5, k)).astype(np.float32)


def test_save_glb_targets_bytes_and_blendshapes(tmp_path):
    jm, tm = _mesh(JMesh), _mesh(Mesh)
    targets, weights = _targets(jm.num_points)
    names = [f"shape_{i}" for i in range(len(targets))]
    jp, tp = _same_bytes(
        tmp_path, "targets",
        lambda p: jg.save_glb_targets(p, jm, targets, weights, fps=30.0, names=names),
        lambda p: tg.save_glb_targets(p, tm, torch.tensor(targets), torch.tensor(weights),
                                      fps=30.0, names=names))
    _, w_shapes, w_names, w_anim = jg.load_glb_blendshapes(jp)
    for reader, path in ((tg.load_glb_blendshapes, jp), (jg.load_glb_blendshapes, tp)):
        rest, shapes, got_names, anim = reader(path)
        assert got_names == w_names == names
        np.testing.assert_array_equal(anim, w_anim)
        assert len(shapes) == len(w_shapes)
        for s, w in zip(shapes, w_shapes):
            np.testing.assert_array_equal(s.points, w.points)


def test_save_glb_morph_bytes(tmp_path):
    jm, tm = _mesh(JMesh, attrs=False), _mesh(Mesh, attrs=False)
    rng = np.random.default_rng(4)
    frames = jm.points[None] + 0.02 * rng.standard_normal((3,) + jm.points.shape).astype(
        np.float32)
    frames[1, 30:] = jm.points[30:]    # a capture-gated frame: sparse
    _same_bytes(tmp_path, "morph", lambda p: jg.save_glb_morph(p, jm, frames),
                lambda p: tg.save_glb_morph(p, tm, torch.tensor(frames)))


def test_writer_errors_match_jax(tmp_path):
    jm, tm = _mesh(JMesh, n=6), _mesh(Mesh, n=6)
    cases = [
        (lambda m, p: (jg, tg)[m].save_glb_targets(p, (jm, tm)[m], np.zeros((2, 5, 3)),
                                                   np.zeros((1, 2)))),
        (lambda m, p: (jg, tg)[m].save_glb_targets(p, (jm, tm)[m], np.zeros((2, jm.num_points)),
                                                   np.zeros((1, 2)))),
        (lambda m, p: (jg, tg)[m].save_glb_morph(p, (jm, tm)[m], np.zeros((2, 5, 3)))),
    ]
    for case in cases:
        with pytest.raises(ValueError) as want:
            case(0, str(tmp_path / "j.glb"))
        with pytest.raises(ValueError) as got:
            case(1, str(tmp_path / "t.glb"))
        assert str(got.value) == str(want.value)


def _linear_rotation_glb(path, flip):
    """A one-joint skin whose rotation keys (30 and 40 degrees about z,
    at t = 0 and 1) are LINEAR, with a translation key at t = 0.5 so the
    loader samples the blend there; `flip` stores the second key as -q."""
    pts = np.eye(3, dtype=np.float32)
    rot = np.stack([_rz(30.0), _rz(40.0)])[:, None]
    model = tsk.SkinningModel(torch.ones(3, 1), torch.tensor(rot), torch.zeros(2, 1, 3),
                              torch.tensor(pts))
    tg.save_glb_skinned(path, Mesh(points=pts), model, fps=1.0, hierarchy=False)
    gltf, blob = tg.load_glb(path)
    blob = bytearray(blob)
    anim = gltf["animations"][0]
    by_path = {ch["target"]["path"]: anim["samplers"][ch["sampler"]] for ch in anim["channels"]}
    rs = by_path["rotation"]
    rs["interpolation"] = "LINEAR"
    if flip:
        acc = gltf["accessors"][rs["output"]]
        off = gltf["bufferViews"][acc["bufferView"]]["byteOffset"] + 16
        q1 = np.frombuffer(bytes(blob[off:off + 16]), np.float32)
        blob[off:off + 16] = (-q1).tobytes()
    bb = tg._BufferBuilder()
    bb.blob, bb.views, bb.accessors = blob, gltf["bufferViews"], gltf["accessors"]
    ts = bb.add(np.float32([0.0, 0.5, 1.0]), tg._F32, "SCALAR")
    tr = bb.add(np.zeros((3, 3), np.float32), tg._F32, "VEC3")
    by_path["translation"].update(input=ts, output=tr)
    gltf["buffers"][0]["byteLength"] = len(bb.blob) + (-len(bb.blob) % 4)
    tg._write_glb(path, gltf, bb.blob)


def test_linear_rotation_keys_in_opposite_hemispheres(tmp_path):
    """Deliberate difference from the JAX reader (its LINEAR nlerp has no
    hemisphere rule): keys q(30 deg) and -q(40 deg) blend at t = 0.5 to the
    35-degree joint in the port, to a near-zero quaternion in JAX."""
    for flip in (False, True):
        path = str(tmp_path / f"lin_{flip}.glb")
        _linear_rotation_glb(path, flip)
        got, times = tg.load_glb_skin(path, device="cpu")
        want, _ = jg.load_glb_skin(path)
        np.testing.assert_array_equal(times, [0.0, 0.5, 1.0])
        np.testing.assert_allclose(got.rotations[1, 0].numpy(), _rz(35.0), atol=ROT_TOL)
        np.testing.assert_allclose(got.rotations[0, 0].numpy(), _rz(30.0), atol=ROT_TOL)
        np.testing.assert_allclose(got.rotations[2, 0].numpy(), _rz(40.0), atol=ROT_TOL)
        jax_err = float(np.abs(np.asarray(want.rotations[1, 0]) - _rz(35.0)).max())
        if flip:
            assert jax_err > 0.1, jax_err
        else:
            assert jax_err <= ROT_TOL
            np.testing.assert_allclose(got.rotations.numpy(), np.asarray(want.rotations),
                                       atol=ROT_TOL)


def test_load_mesh_dispatches_glb(tmp_path):
    from facedeform_tpu_torch import load_mesh, save_mesh

    tm = _mesh(Mesh)
    save_mesh(str(tmp_path / "m.glb"), tm)
    back = load_mesh(str(tmp_path / "m.glb"))
    np.testing.assert_array_equal(back.points, tm.points)
    np.testing.assert_array_equal(back.triangles(), tm.triangles())
