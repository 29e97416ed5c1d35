"""PyTorch port: the reference SOP's cook order end to end against the JAX
package on a 40 x 40 sphere (CPU tensors):

    capture -> Deformer.fit -> Deformer.apply(dist2, group_mask)
            -> DBSE weights -> morph_apply (gated by the group)

as facedeform_tpu/node.py cooks it (650-700, 960-1000).  The JAX eval runs
as the JAX package's own tests run it on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
from facedeform_tpu import Deformer as JDeformer
from facedeform_tpu.capture.capture import ProximityCapture as JCapture
from facedeform_tpu.geometry.mesh import Mesh as JMesh
from facedeform_tpu.geometry.primitives import fibonacci_points, uv_sphere
from facedeform_tpu.ops import dbse as jdbse
from facedeform_tpu_torch import Deformer, Mesh, ProximityCapture, convert
from facedeform_tpu_torch.ops import dbse

# positions of the whole chain, port against JAX (BASELINE.md's budget)
CHAIN_TOL = 5e-5


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One torch intra-op thread, as the other JAX-parity tests run (see
    tests/test_torch_eval.py); never raised again."""
    torch.set_num_threads(1)


def _bumps(points, n, seed, radius=0.3, amp=0.05):
    """n blendshapes: smooth normal bumps at random sites."""
    rng = np.random.default_rng(seed)
    sites = fibonacci_points(64)[rng.choice(64, n, replace=False)]
    normal = points / np.linalg.norm(points, axis=1, keepdims=True)
    out = []
    for s in sites:
        w = np.exp(-np.sum((points - s) ** 2, -1) / radius ** 2)
        out.append((points + amp * w[:, None] * normal).astype(np.float32))
    return out


@pytest.mark.parametrize("route", ["lstsq", "robust", "parity"])
@pytest.mark.parametrize("metric", ["euclidean", "geodesic"])
def test_capture_fit_apply_morph_chain_matches_jax(route, metric):
    sphere = uv_sphere(40, 40)
    pts = sphere.points
    rest_rig = fibonacci_points(30) * 1.02
    bump = 0.15 * np.exp(-2.0 * np.sum((rest_rig - [0, 1, 0]) ** 2, -1, keepdims=True))
    deformed_rig = (rest_rig + bump * np.float32([0.3, 1.0, 0.0])).astype(np.float32)
    classes = (np.arange(30) % 3).astype(np.int32)

    jmesh = JMesh(points=pts, faces=sphere.faces)
    jmesh.set_group("upper", pts[:, 1] > -0.3)
    tmesh = convert.mesh_from_fields(dataclasses.asdict(jmesh))
    jrig, trig = JMesh(points=rest_rig), Mesh(points=rest_rig)
    jrig.set_attr("class", classes)
    trig.set_attr("class", classes)

    fields = dict(dofalloff=True, morphspace=True, dbse_lstsq=route != "parity",
                  dbse_robust=route == "robust", falloff_metric=metric)
    jc = jcfg.DeformConfig(**fields)
    tc = convert.config_from_fields(dataclasses.asdict(jc))
    jp = jcfg.DeformParams(radius=0.6, falloffrate=1.5, falloffradius=0.5)
    tp = convert.params_from_fields(jp._asdict())

    # capture (node.py 650-665)
    jcap, tcap = JCapture(), ProximityCapture(device="cpu")
    jcap.init(jmesh, jrig)
    tcap.init(tmesh, trig)
    kw = dict(max_edges=6, radius=0.6, dofalloff=True, falloffrate=1.5, metric=metric)
    jres, tres = jcap.capture(**kw), tcap.capture(**kw)
    np.testing.assert_array_equal(tres.captured, jres.captured)
    np.testing.assert_allclose(tres.dist2, jres.dist2, rtol=1e-5, atol=1e-6)
    jmask = jmesh.select_points("upper")
    tmask = tmesh.select_points("upper")
    np.testing.assert_array_equal(tmask, jmask)

    # fit + gated apply
    jd = JDeformer.fit(rest_rig, deformed_rig, jc, jp)
    td = Deformer.fit(rest_rig, deformed_rig, tc, tp, device="cpu")
    j_pts, j_w = jd.apply(jnp.asarray(pts), dist2=jnp.asarray(jres.dist2),
                          group_mask=jnp.asarray(jmask))
    t_pts, t_w = td.apply(pts, dist2=tres.dist2, group_mask=tmask)
    j_pts, t_pts = np.asarray(j_pts), t_pts.numpy()
    np.testing.assert_allclose(t_pts, j_pts, atol=CHAIN_TOL)
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), atol=1e-5)
    assert (t_pts[~tmask] == pts[~tmask]).all()
    assert np.abs(t_pts - pts).max() > 1e-3

    # DBSE on the deformed positions, gated by the group (node.py 960-1000)
    shapes = _bumps(pts, 6, seed=5)
    jm = jdbse.build_model(pts, shapes, parity=route == "parity")
    tm = dbse.build_model(pts, shapes, parity=route == "parity", device="cpu")
    if route == "parity":
        jw = jdbse.weights_parity(jm, jnp.asarray(j_pts), jnp.asarray(pts))
        tw = dbse.weights_parity(tm, t_pts, pts)
    elif route == "robust":
        jw, _ = jdbse.weights_robust(jm, jnp.asarray(j_pts), jnp.asarray(pts))
        tw, _ = dbse.weights_robust(tm, t_pts, pts)
    else:
        jw, _ = jdbse.weights_lstsq(jm, jnp.asarray(j_pts), jnp.asarray(pts))
        tw, _ = dbse.weights_lstsq(tm, t_pts, pts)
    j_morph = np.asarray(jdbse.morph_apply(jm, jnp.asarray(j_pts), jnp.asarray(pts), jw, jc, jp))
    t_morph = dbse.morph_apply(tm, t_pts, pts, tw, tc, tp).numpy()
    j_out = np.where(jmask[:, None], j_morph, j_pts)
    t_out = np.where(tmask[:, None], t_morph, t_pts)
    np.testing.assert_allclose(t_out, j_out, atol=CHAIN_TOL)
    assert (t_out[~tmask] == pts[~tmask]).all()
    assert np.isfinite(t_out).all()
