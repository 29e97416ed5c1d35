"""PyTorch port: ops/symmetry.py (host numpy/scipy, copied from the JAX
package) against facedeform_tpu.ops.symmetry on the same seeded rigs and
meshes.  Both run the same numpy code, so every output must be equal bit
for bit, with the native KD-tree and with the scipy fallback.
"""

import numpy as np
import pytest

from facedeform_tpu.geometry.primitives import fibonacci_points, uv_sphere
from facedeform_tpu.ops import symmetry as jsym
from facedeform_tpu_torch import native
from facedeform_tpu_torch.ops import symmetry as tsym

PLANES = {
    "x": "x",
    "Y": "Y",
    "normal": (0.0, 0.0, 2.0),
    "normal_origin": ((1.0, 0.0, 0.0), (0.1, 0.0, 0.0)),
}


def _rig(seed, n=40, jitter=1e-3):
    """A mirror-symmetric rig (pairs, on-plane markers, unpaired extras)
    with tracker jitter, an asymmetric pose, classes and confidence."""
    rng = np.random.default_rng(seed)
    half = fibonacci_points(2 * n)
    half = half[half[:, 0] > 0.05][: n // 2]
    mirror = half * np.float32([-1, 1, 1])
    on_plane = np.stack([np.zeros(4), np.linspace(-0.8, 0.8, 4), np.full(4, 0.6)], 1)
    extra = np.float32([[0.7, 0.1, 0.7], [0.3, -0.9, 0.3]])
    rest = np.concatenate([half, mirror, on_plane, extra]).astype(np.float32)
    rest = rest + jitter * rng.standard_normal(rest.shape).astype(np.float32)
    pose = rest + 0.05 * rng.standard_normal(rest.shape).astype(np.float32)
    classes = rng.integers(0, 4, len(rest)).astype(np.int32)
    conf = rng.uniform(0.3, 1.0, len(rest)).astype(np.float32)
    return rest, pose.astype(np.float32), classes, conf


def _eq(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    if isinstance(a, tuple):
        assert type(a).__name__ == type(b).__name__ and a == b
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("plane", list(PLANES))
@pytest.mark.parametrize("attrs", [False, True])
def test_symmetrize_rig_equals_jax(plane, attrs):
    rest, pose, classes, conf = _rig(0)
    kw = dict(classes=classes, confidence=conf) if attrs else {}
    got = tsym.symmetrize_rig_full(rest, pose, PLANES[plane], **kw)
    want = jsym.symmetrize_rig_full(rest, pose, PLANES[plane], **kw)
    for g, w in zip(got, want):
        _eq(g, w)
    got4 = tsym.symmetrize_rig(rest, pose, PLANES[plane], tol=0.01, **kw)
    want4 = jsym.symmetrize_rig(rest, pose, PLANES[plane], tol=0.01, **kw)
    for g, w in zip(got4, want4):
        _eq(g, w)


def test_symmetrize_frames_equals_jax():
    rest, pose, classes, conf = _rig(1)
    rng = np.random.default_rng(1)
    frames = (rest[None] + 0.03 * rng.standard_normal((5,) + rest.shape)).astype(np.float32)
    got = tsym.symmetrize_frames(rest, frames, "x", classes=classes, confidence=conf)
    want = jsym.symmetrize_frames(rest, frames, "x", classes=classes, confidence=conf)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("native_lib", [True, False])
def test_pair_markers_and_mirror_map_equal_jax(native_lib, monkeypatch):
    """Mutual matches only (a dense cluster cannot swallow a lone marker or
    vertex), with the native KD-tree or the scipy fallback."""
    if not native_lib:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    rest, _, _, _ = _rig(2)
    # a one-sided cluster: three markers near one mirror image
    cluster = np.float32([[-0.5, 0.2, 0.8], [-0.505, 0.2, 0.8], [-0.5, 0.205, 0.8]])
    lone = np.float32([[0.5, 0.2, 0.8]])
    pts = np.concatenate([rest, cluster, lone])
    for tol in (None, 0.02):
        for g, w in zip(tsym.pair_markers(pts, "x", tol), jsym.pair_markers(pts, "x", tol)):
            _eq(g, w)
    mesh = uv_sphere(20, 24)
    mpts = mesh.points.copy()
    mpts[mpts[:, 0] > 0.3] += np.float32([0.002, 0.0, 0.0])   # slightly asymmetric
    for g, w in zip(tsym.mirror_map(mpts, "x"), jsym.mirror_map(mpts, "x")):
        _eq(g, w)
    idx, ok = tsym.mirror_map(mpts, "x")
    assert np.all(idx[idx[ok]] == np.nonzero(ok)[0])       # involutive where matched


def test_displacement_projection_and_error_equal_jax():
    mesh = uv_sphere(16, 20)
    rng = np.random.default_rng(3)
    disp = 0.05 * rng.standard_normal(mesh.points.shape).astype(np.float32)
    idx, ok = jsym.mirror_map(mesh.points, "x")
    for part in ("symmetric", "antisymmetric"):
        got = tsym.symmetrize_displacement(disp, idx, ok, "x", part)
        _eq(got, jsym.symmetrize_displacement(disp, idx, ok, "x", part))
        # an orthogonal projection: idempotent
        np.testing.assert_allclose(tsym.symmetrize_displacement(got, idx, ok, "x", part), got,
                                   atol=1e-7)
    assert tsym.symmetry_error(disp, idx, ok, "x") == jsym.symmetry_error(disp, idx, ok, "x")
    sym = tsym.symmetrize_displacement(disp, idx, ok, "x")
    assert tsym.symmetry_error(sym, idx, ok, "x") < 1e-6
    _eq(tsym.reflect_points(mesh.points, "z"), jsym.reflect_points(mesh.points, "z"))
    _eq(tsym.reflection_matrix((1.0, 1.0, 0.0)), jsym.reflection_matrix((1.0, 1.0, 0.0)))


@pytest.mark.parametrize("bad", ["w", (0.0, 0.0, 0.0), (1.0, 2.0)])
def test_bad_planes_raise_as_jax(bad):
    msgs = []
    for mod in (jsym, tsym):
        with pytest.raises(ValueError) as e:
            mod.reflection_matrix(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_rig_shape_mismatch_raises():
    from facedeform_tpu_torch.utils import errors

    with pytest.raises(errors.ShapeMismatchError):
        tsym.symmetrize_rig(np.zeros((4, 3)), np.zeros((5, 3)))
