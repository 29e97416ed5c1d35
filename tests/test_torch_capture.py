"""PyTorch port: proximity capture and the device distance queries against
the JAX package on the same meshes and rigs (CPU tensors)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedeform_tpu.capture.capture import ProximityCapture as JCapture
from facedeform_tpu.geometry.mesh import Mesh as JMesh
from facedeform_tpu.geometry.primitives import fibonacci_points, grid, uv_sphere
from facedeform_tpu.ops import distances as jdist
from facedeform_tpu.utils.errors import CaptureError as JCaptureError
from facedeform_tpu_torch import convert
from facedeform_tpu_torch.capture.capture import ProximityCapture as TCapture
from facedeform_tpu_torch.geometry.mesh import Mesh as TMesh
from facedeform_tpu_torch.ops import distances as tdist
from facedeform_tpu_torch.utils.errors import CaptureError

# the JAX capture tests' distance bound (tests/test_capture.py)
RTOL, ATOL = 1e-5, 1e-6
# colours against the JAX package's: a colour channel moves by about
# (50 / 60) rate / r^2 per unit of dist2, and the JAX host path's dist2
# (the expansion form) sits up to ~3e-7 from the exact one, so at r = 0.3
# and rate 1.5 the colours differ by up to ~4e-6; they are also held
# exactly to the JAX colour rule applied to the port's own dist2
COLOR_ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One torch intra-op thread, as the other JAX-parity tests run (see
    tests/test_torch_eval.py); never raised again."""
    torch.set_num_threads(1)


def _meshes(points, faces=None, rig=None, rig_faces=None, classes=None):
    out = []
    for cls in (JMesh, TMesh):
        m = cls(points=points, faces=faces)
        r = cls(points=rig, faces=rig_faces)
        if classes is not None:
            r.set_attr("class", classes)
        out.append((m, r))
    return out


def _both(mesh_pair, **kw):
    (jm, jr), (tm, tr) = mesh_pair
    j = JCapture()
    j.init(jm, jr)
    t = TCapture(device="cpu")
    t.init(tm, tr)
    return j.capture(**kw), t.capture(**kw)


def _colors_like_jax(res, radius, rate):
    """The JAX package's falloff colour rule (capture.cpp:89-98) applied
    to this result's own dist2."""
    from facedeform_tpu.capture.capture import _hsv_to_rgb

    color = np.ones_like(res.color)
    idx = np.nonzero(res.captured)[0]
    d2 = res.dist2[idx]
    r2 = radius * radius
    vis = (d2 >= 0) & (d2 <= r2)
    falloff = (1.0 - np.minimum(d2 / r2, 1.0)) ** float(rate)
    color[idx[vis]] = _hsv_to_rgb(200.0 + falloff * 50.0)[vis]
    return color


def _same_topology(jres, tres):
    np.testing.assert_array_equal(tres.captured, jres.captured)
    np.testing.assert_array_equal(tres.seed_vertices, jres.seed_vertices)
    assert sorted(tres.islands) == sorted(jres.islands)
    for k in jres.islands:
        np.testing.assert_array_equal(tres.islands[k], jres.islands[k])


def _sphere_rig(n_markers=40, classes=True, shift=0.0):
    m = uv_sphere(40, 40)
    rig = fibonacci_points(n_markers) * 1.02
    cls = (np.arange(n_markers) % 4).astype(np.int32) if classes else None
    return _meshes(m.points + np.float32(shift), m.faces, rig + np.float32(shift), classes=cls)


@pytest.mark.parametrize("dofalloff", [False, True])
@pytest.mark.parametrize("metric", ["euclidean", "geodesic"])
@pytest.mark.parametrize("strict", [False, True])
def test_capture_matches_jax_point_rig(dofalloff, metric, strict):
    """Islands by class, seeds, mask, dist2 and colours on a point rig."""
    pair = _sphere_rig()
    jres, tres = _both(pair, max_edges=4, radius=0.3, dofalloff=dofalloff,
                       falloffrate=1.5, strict_parity=strict, metric=metric)
    _same_topology(jres, tres)
    assert len(tres.islands) == 4
    np.testing.assert_allclose(tres.dist2, jres.dist2, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tres.color, jres.color, atol=COLOR_ATOL)
    if dofalloff:
        np.testing.assert_array_equal(tres.color, _colors_like_jax(tres, 0.3, 1.5))
    if not dofalloff:
        assert (tres.dist2 == 0).all() and (tres.color == 1).all()
    if strict and dofalloff:
        # the -1 sentinel where the radius-bounded search would fail
        assert (tres.dist2 == -1.0).any()
        np.testing.assert_array_equal(tres.dist2 == -1.0, jres.dist2 == -1.0)


def test_capture_matches_jax_triangle_rig():
    """A rig with faces measures to the nearest point on its triangles
    (GU_RayIntersect::minimumPoint, capture.cpp:81-86)."""
    from scipy.spatial import ConvexHull

    m = uv_sphere(40, 40)
    rig = fibonacci_points(60) * 1.05
    tris = ConvexHull(rig).simplices.astype(np.int32)
    pair = _meshes(m.points, m.faces, rig, rig_faces=tris)
    jres, tres = _both(pair, max_edges=5, radius=0.5, dofalloff=True, falloffrate=1.0)
    _same_topology(jres, tres)
    np.testing.assert_allclose(tres.dist2, jres.dist2, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tres.color, jres.color, atol=COLOR_ATOL)
    np.testing.assert_array_equal(tres.color, _colors_like_jax(tres, 0.5, 1.0))
    # against float64 brute force
    idx = np.nonzero(tres.captured)[0]
    want = jdist._point_triangle_sqdist_np(m.points[idx].astype(np.float64),
                                           rig[tris].astype(np.float64)).min(1)
    np.testing.assert_allclose(tres.dist2[idx], want, rtol=RTOL, atol=ATOL)


def test_capture_far_from_origin_uses_exact_differences():
    """A rig at |x| ~ 100: the port's distances (exact per-coordinate
    differences) stay within the bound of float64 and of the JAX package's
    device query.  (The JAX capture's host path, below 5M pairs, uses the
    ||x||^2 + ||y||^2 - 2 x.y expansion and sits ~8e-3 off here.)"""
    pair = _sphere_rig(classes=False, shift=[100.0, -80.0, 60.0])
    jres, tres = _both(pair, max_edges=4, radius=0.3, dofalloff=True, falloffrate=1.0)
    _same_topology(jres, tres)
    (_, _), (tm, tr) = pair
    idx = np.nonzero(tres.captured)[0]
    p64, r64 = tm.points[idx].astype(np.float64), tr.points.astype(np.float64)
    want = ((p64[:, None] - r64[None]) ** 2).sum(-1).min(1)
    np.testing.assert_allclose(tres.dist2[idx], want, rtol=RTOL, atol=ATOL)
    jdev = np.asarray(jdist.min_sqdist_to_points(jnp.asarray(tm.points[idx]),
                                                 jnp.asarray(tr.points)))
    np.testing.assert_allclose(tres.dist2[idx], jdev, rtol=RTOL, atol=ATOL)


def test_capture_grid_single_marker_and_line_islands():
    """The JAX capture tests' own meshes: a plane with one marker (dist2 is
    the squared distance to it) and a path graph with two classes."""
    g = grid(30, 30, size=2.0)
    pair = _meshes(g.points, g.faces, np.float32([[0, 0, 0]]))
    jres, tres = _both(pair, max_edges=8, radius=1.0, dofalloff=True, falloffrate=1.0)
    _same_topology(jres, tres)
    idx = np.nonzero(tres.captured)[0]
    np.testing.assert_allclose(tres.dist2[idx], np.sum(g.points[idx] ** 2, -1), atol=1e-5)
    assert (tres.dist2[~tres.captured] == 0).all()

    n = 30
    pts = np.stack([np.arange(n), np.zeros(n), np.zeros(n)], -1).astype(np.float32)
    faces = np.array([[i, i + 1, i + 1] for i in range(n - 1)], np.int32)
    pair = _meshes(pts, faces, np.float32([[0, 0, 0], [29, 0, 0]]), classes=np.int32([1, 2]))
    jres, tres = _both(pair, max_edges=2, radius=5.0, dofalloff=False, falloffrate=1.0)
    _same_topology(jres, tres)
    assert tres.islands[1][:3].all() and not tres.islands[1][3:].any()


def test_capture_errors_word_for_word():
    """CaptureError messages equal the JAX package's."""
    m = uv_sphere(10, 10)
    cases = []
    jc, tc = JCapture(), TCapture(device="cpu")
    cases.append((lambda: jc.capture(1, 1.0, False, 1.0), lambda: tc.capture(1, 1.0, False, 1.0)))
    (jm, jr), (tm, tr) = _meshes(m.points, m.faces, np.zeros((0, 3), np.float32))
    jc1, tc1 = JCapture(), TCapture(device="cpu")
    jc1.init(jm, jr)
    tc1.init(tm, tr)
    cases.append((lambda: jc1.capture(2, 1.0, True, 1.0), lambda: tc1.capture(2, 1.0, True, 1.0)))
    (jm, jr), (tm, tr) = _meshes(m.points, None, m.points[:3])
    jc2, tc2 = JCapture(), TCapture(device="cpu")
    jc2.init(jm, jr)
    tc2.init(tm, tr)
    cases.append((lambda: jc2.capture(2, 1.0, True, 1.0, metric="geodesic"),
                  lambda: tc2.capture(2, 1.0, True, 1.0, metric="geodesic")))
    (jm, jr), (tm, tr) = _meshes(m.points, m.faces, m.points[:3])
    jc3, tc3 = JCapture(), TCapture(device="cpu")
    jc3.init(jm, jr)
    tc3.init(tm, tr)
    cases.append((lambda: jc3.capture(2, 1.0, True, 1.0, metric="manhattan"),
                  lambda: tc3.capture(2, 1.0, True, 1.0, metric="manhattan")))
    for jfn, tfn in cases:
        with pytest.raises(JCaptureError) as jerr:
            jfn()
        with pytest.raises(CaptureError) as terr:
            tfn()
        assert str(terr.value) == str(jerr.value)


def test_capture_accessors_and_result_carry_over():
    pair = _sphere_rig()
    (jm, jr), (tm, tr) = pair
    j = JCapture()
    j.init(jm, jr)
    jres = j.capture(3, 0.3, True, 1.0)
    t = TCapture(device="cpu")
    assert not t.is_initialized() and t.distance_attribute() is None
    t.init(tm, tr)
    tres = t.capture(3, 0.3, True, 1.0)
    assert t.is_initialized() and t.is_captured()
    assert t.distance_attribute() is tres.dist2 and t.color_attribute() is tres.color
    carried = convert.capture_result_from_numpy(dataclasses.asdict(jres))
    for f in ("captured", "dist2", "color", "seed_vertices"):
        np.testing.assert_array_equal(getattr(carried, f), getattr(jres, f))
    np.testing.assert_allclose(tres.dist2, carried.dist2, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_distance_queries_match_jax_device_path(seed):
    """min_sqdist_to_points / _triangles against the JAX package's jitted
    device queries, with collapsed and sliver triangles, across chunks."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((3000, 3)).astype(np.float32) * 2.0
    targets = rng.standard_normal((57, 3)).astype(np.float32)
    tris = rng.standard_normal((23, 3, 3)).astype(np.float32)
    tris[0] = np.float32([1.0, 2.0, 3.0])              # collapsed to a point
    tris[1, 2] = tris[1, 0] + 1e-7                     # sliver
    want_p = np.asarray(jdist.min_sqdist_to_points(jnp.asarray(pts), jnp.asarray(targets)))
    want_t = np.asarray(jdist.min_sqdist_to_triangles(jnp.asarray(pts), jnp.asarray(tris)))
    got_p = tdist.min_sqdist_to_points(torch.as_tensor(pts), torch.as_tensor(targets))
    # a small chunk budget forces many chunks
    old = tdist._CHUNK_ELEMS
    tdist._CHUNK_ELEMS = 4096
    try:
        got_t = tdist.min_sqdist_to_triangles(torch.as_tensor(pts), torch.as_tensor(tris))
    finally:
        tdist._CHUNK_ELEMS = old
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tdist.min_sqdist_to_triangles_auto(pts, tris, device="cpu"),
        jdist.min_sqdist_to_triangles_auto(pts, tris), rtol=RTOL, atol=ATOL)
    assert tdist.min_sqdist_to_points(torch.zeros(0, 3), torch.as_tensor(targets)).shape == (0,)
