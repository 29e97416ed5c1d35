"""PyTorch port: the Houdini Python SOP adapter (houdini.py) against the JAX
package's facedeform_tpu.houdini on tests/test_houdini.py's scenes, with
tests/mock_hou.py standing in for `hou` and the port cooking on the CPU.

Each scene is built twice from one seed (one mock node per package); the
port's cook_sop(node, device="cpu") must write positions within 5e-5 of
the motion scale (BASELINE.md's budget) of the JAX adapter's, fd_falloff
within 1e-6, the same attributes, warnings and errors.  Two deliberate
differences are shown: the regress-mode fit cache is keyed on the
unclamped params through deformer.fit_params_key (the JAX adapter
clamps first), and an out-of-range menu index raises hou.NodeError (the
JAX adapter's _checked_index names `hou` without importing it, so it
raises NameError).
"""

import sys

import numpy as np
import pytest
import torch

from tests import mock_hou

sys.modules.setdefault("hou", mock_hou)

from facedeform_tpu import houdini as jh  # noqa: E402
from facedeform_tpu.geometry.mesh import Mesh as JMesh  # noqa: E402
from facedeform_tpu.geometry.primitives import fibonacci_points, uv_sphere  # noqa: E402
from facedeform_tpu.ops import psd as jpsd  # noqa: E402
from facedeform_tpu.utils import checkpoint as jck  # noqa: E402
from facedeform_tpu_torch import houdini as th  # noqa: E402
from facedeform_tpu_torch.geometry.mesh import Mesh as TMesh  # noqa: E402
from facedeform_tpu_torch.deformer import fit_params_key  # noqa: E402

POS_RTOL = 5e-5      # of the motion scale (BASELINE.md)
FALLOFF_TOL = 1e-6
WEIGHTS_TOL = 1e-4   # DBSE weights (tests/test_dbse.py)


@pytest.fixture(autouse=True)
def _fresh_state():
    torch.set_num_threads(1)
    jh.clear_state()
    th.clear_state()
    yield
    jh.clear_state()
    th.clear_state()


_COUNTER = [0]


def _scene(M, seed=42, parms=None, n_ctrl=30, blends=0, tangent_frame=False):
    """(mock SOP node, meshes) of the sphere + rig scene of
    tests/test_houdini.py, built with Mesh class M from `seed`."""
    _COUNTER[0] += 1
    tag = f"{'j' if M is JMesh else 't'}{_COUNTER[0]}"
    rng = np.random.default_rng(seed)
    base = uv_sphere(24, 24)
    mesh = M(points=base.points, faces=base.faces)
    if tangent_frame:
        n = mesh.points / np.linalg.norm(mesh.points, axis=1, keepdims=True)
        u = np.cross(n, [0.0, 0.0, 1.0]).astype(np.float32)
        u /= np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-6)
        mesh.set_attr("N", n.astype(np.float32))
        mesh.set_attr("tangentu", u)
        mesh.set_attr("tangentv", np.cross(n, u).astype(np.float32))
    rig0 = M(points=fibonacci_points(n_ctrl))
    rig1 = M(points=rig0.points + 0.08 * rng.standard_normal((n_ctrl, 3)).astype(np.float32))
    meshes = [mesh, rig0, rig1]
    for _ in range(blends):
        pts = mesh.points + 0.05 * rng.standard_normal(mesh.points.shape).astype(np.float32)
        meshes.append(M(points=pts, faces=mesh.faces))
    inputs = tuple(mock_hou.SopNode(f"/obj/{tag}/in{i}", mock_hou.geometry_from_mesh(m))
                   for i, m in enumerate(meshes))
    node = mock_hou.SopNode(f"/obj/{tag}/facedeform", parms=dict(parms or {}), inputs=inputs)
    return node, meshes


def _out(node, name="P", width=3):
    v = np.asarray(node.geometry().pointFloatAttribValues(name), np.float32)
    return v.reshape(-1, width) if width > 1 else v


def _cook_both(**scene_kw):
    """Cook the same scene through both adapters; returns the two nodes
    and results (or the raised mock_hou.NodeWarning texts)."""
    out = []
    for M, adapter, kw in ((JMesh, jh, {}), (TMesh, th, {"device": "cpu"})):
        node, meshes = _scene(M, **scene_kw)
        try:
            res, warn = adapter.cook_sop(node, **kw), None
        except mock_hou.NodeWarning as w:
            res, warn = None, str(w)
        out.append((node, meshes, res, warn))
    return out


def _assert_same_output(j, t, rest):
    scale = float(np.abs(_out(j) - rest).max())
    assert float(np.abs(_out(t) - _out(j)).max()) <= POS_RTOL * max(scale, 1e-12)
    np.testing.assert_allclose(_out(t, "fd_falloff", 1), _out(j, "fd_falloff", 1),
                               atol=FALLOFF_TOL)
    jg, tg = j.geometry(), t.geometry()
    assert sorted(tg._point_attrs) == sorted(jg._point_attrs)
    assert sorted(tg._global_attrs) == sorted(jg._global_attrs)


SCENES = {
    "default": dict(),
    "parms": dict(parms={"model": 2, "kernel": 2, "term": 1, "radius": 1.7, "lambda": 0.3,
                         "tangent": 1, "falloffrate": 1.5, "weightrange": (0.1, 0.8),
                         "solver": 1}, tangent_frame=True),
    "group": dict(parms={"group": "0-199"}),
    "falloff": dict(parms={"dofalloff": 1, "radius": 0.6, "maxedges": 6}),
    "symmetrize": dict(parms={"symmetrize": 1}),
    "transport": dict(parms={"update_normals": 1, "transform_attrs": "tangentu",
                             "output_stretch": 1}, tangent_frame=True),
    "reduce_subset": dict(parms={"reducerig": 12}, n_ctrl=40),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_cook_sop_matches_jax(name):
    (jn, jm, _, jw), (tn, _, _, tw) = _cook_both(**SCENES[name])
    assert tw == jw
    _assert_same_output(jn, tn, jm[0].points)
    if name == "group":
        np.testing.assert_array_equal(_out(tn)[200:], jm[0].points[200:])
    if name == "transport":
        for attr in ("N", "tangentu"):
            np.testing.assert_allclose(_out(tn, attr), _out(jn, attr), atol=1e-4)


def test_cook_sop_morphspace_weights_detail():
    (jn, jm, _, _), (tn, _, _, _) = _cook_both(parms={"morphspace": 1}, blends=2)
    _assert_same_output(jn, tn, jm[0].points)
    w_t, dt = tn.geometry()._global_attrs["weights"]
    w_j, _ = jn.geometry()._global_attrs["weights"]
    assert dt is mock_hou.attribData.Float
    np.testing.assert_allclose(np.asarray(w_t), np.asarray(w_j), atol=WEIGHTS_TOL)
    np.testing.assert_array_equal(_out(tn, "rest"), jm[0].points)


def test_cook_sop_reduce_rig_regress_matches_jax():
    """Regress mode: the fit info surfaces as the adapter's one NodeWarning
    after the geometry is written, in both packages."""
    (jn, jm, _, jw), (tn, _, _, tw) = _cook_both(parms={"reducerig": 12, "reducemode": 1},
                                                 n_ctrl=40)
    assert jw is not None and "regress" in jw and tw is not None and "regress" in tw
    assert jw.split(";")[0].split(" residual")[0] == tw.split(";")[0].split(" residual")[0]
    _assert_same_output(jn, tn, jm[0].points)


def test_cook_sop_caches_across_cooks():
    node, _ = _scene(TMesh)
    th.cook_sop(node, device="cpu")
    state = th._NODE_STATE[node.path()]
    mesh0 = state["geo_cache"][0][1]
    deformer, fit_key = state["node"]._deformer, state["node"]._fit_key
    assert deformer is not None
    th.cook_sop(node, device="cpu")
    assert state["geo_cache"][0][1] is mesh0
    assert state["node"]._deformer is deformer and state["node"]._fit_key == fit_key
    node.inputs()[2]._cook_count += 1
    th.cook_sop(node, device="cpu")
    assert state["geo_cache"][0][1] is mesh0
    assert state["node"]._fit_key != fit_key or state["node"]._deformer is not deformer


def _raised(fn):
    try:
        fn()
    except (mock_hou.NodeError, mock_hou.NodeWarning) as e:
        return type(e), str(e)
    return None


ERROR_CASES = ["short_inputs", "unconnected_slot", "rig_count_mismatch", "string_attr",
               "missing_psd", "reduce_keeps_all", "regress_with_pu"]


def _error_scene(M, case):
    if case == "short_inputs":
        return mock_hou.SopNode(f"/obj/{M.__module__}/short", inputs=()), None
    node, meshes = _scene(M, n_ctrl=40 if case in ("reduce_keeps_all", "regress_with_pu")
                          else 30)
    if case == "unconnected_slot":
        node._inputs = (node.inputs()[0], None, node.inputs()[2])
    elif case == "rig_count_mismatch":
        bad = M(points=meshes[1].points[:-2])
        node._inputs = (node.inputs()[0], node.inputs()[1],
                        mock_hou.SopNode(node.path() + "_b", mock_hou.geometry_from_mesh(bad)))
    elif case == "string_attr":
        node.inputs()[0].geometry()._add_point_attr(
            "name", np.array(["a"] * meshes[0].num_points))
    elif case == "missing_psd":
        node._parms["psd_file"] = "/nonexistent/missing.npz"
    elif case == "reduce_keeps_all":
        node._parms["reducerig"] = 50
    elif case == "regress_with_pu":
        node._parms.update({"reducerig": 12, "reducemode": 1, "solver": 3})
    return node, meshes


@pytest.mark.parametrize("case", ERROR_CASES)
def test_errors_and_warnings_match_jax(case):
    jnode, _ = _error_scene(JMesh, case)
    tnode, _ = _error_scene(TMesh, case)
    want = _raised(lambda: jh.cook_sop(jnode))
    got = _raised(lambda: th.cook_sop(tnode, device="cpu"))
    assert want is not None and got == want


def test_out_of_range_menu_index_is_a_node_error():
    """The port's _checked_index imports hou (the JAX adapter's raises
    NameError here): a hand-built parm pane's bad menu value is a cook
    error with the parm's name."""
    node, _ = _scene(TMesh, parms={"solver": 9})
    with pytest.raises(mock_hou.NodeError, match="solver parm value 9"):
        th.cook_sop(node, device="cpu")
    jnode, _ = _scene(JMesh, parms={"solver": 9})
    with pytest.raises(NameError):
        jh.cook_sop(jnode)


def test_mesh_geometry_round_trip_matches_jax():
    rng = np.random.default_rng(3)
    base = uv_sphere(8, 8)
    for M, adapter in ((JMesh, jh), (TMesh, th)):
        mesh = M(points=base.points, faces=base.faces)
        mesh.set_attr("N", rng.standard_normal((mesh.num_points, 3)).astype(np.float32))
        mesh.set_attr("class", np.arange(mesh.num_points, dtype=np.int32) % 3)
        mesh.set_group("lip", np.arange(10, dtype=np.int64))
        warnings = []
        back = adapter.mesh_from_geometry(mock_hou.geometry_from_mesh(mesh), warnings)
        assert not warnings
        np.testing.assert_array_equal(back.points, mesh.points)
        np.testing.assert_array_equal(back.faces, base.faces)
        np.testing.assert_array_equal(back.point_attrs["class"], mesh.point_attrs["class"])
        np.testing.assert_array_equal(back.group_mask("lip"), mesh.group_mask("lip"))
        np.testing.assert_array_equal(back.triangles(), mesh.triangles())


def test_parm_specs_and_templates_match_jax():
    assert th.PARM_SPECS == jh.PARM_SPECS
    assert [t.name() for t in th.build_parm_templates()] == [s[0] for s in jh.PARM_SPECS]
    d = mock_hou._Definition()
    th.apply_parm_templates(d)
    th.apply_parm_templates(d)
    assert [t.name() for t in d.parmTemplateGroup().entries()] == [s[0] for s in th.PARM_SPECS]
    assert "from facedeform_tpu_torch import houdini" in th.PYTHON_SOP_CODE
    parms = {"model": 2, "kernel": 5, "solver": 2, "falloff_metric": 1, "layers": 3,
             "weightrange": (0.2, 0.9), "group": " lips ", "maxedges": 7}
    node, _ = _scene(TMesh, parms=parms)
    jnode, _ = _scene(JMesh, parms=parms)
    (tc, tp, tg), (jc, jp, jg) = th.config_from_node(node), jh.config_from_node(jnode)
    assert tc.__dict__ == jc.__dict__
    assert tuple(tp) == tuple(jp) and tg == jg == "lips"


def test_cook_sop_psd_checkpoint_matches_jax(tmp_path):
    """The psd_file parm: a JAX-written PSD checkpoint applied by both
    adapters (the port through its checkpoint.load_psd), identity-cached
    across cooks."""
    jnode, jmeshes = _scene(JMesh)
    mesh, rig0, rig1 = jmeshes
    feats = np.stack([jpsd.features_from_rig(rig0.points, rig1.points)])
    corr = 0.05 * np.random.default_rng(7).standard_normal(
        (1, mesh.num_points, 3)).astype(np.float32)
    model, report = jpsd.fit_psd(feats, corr)
    path = str(tmp_path / "sop_psd.npz")
    jck.save_psd(path, jpsd.PSDDeformer(model, report=report))
    tnode, _ = _scene(TMesh)
    jnode._parms["psd_file"] = tnode._parms["psd_file"] = path
    jh.cook_sop(jnode)
    th.cook_sop(tnode, device="cpu")
    _assert_same_output(jnode, tnode, mesh.points)
    first = th._NODE_STATE[tnode.path()]["psd_cache"][1]
    assert first.model.corrections.device.type == "cpu"
    th.cook_sop(tnode, device="cpu")
    assert th._NODE_STATE[tnode.path()]["psd_cache"][1] is first


def test_regress_cache_keys_on_unclamped_params():
    """The reduce-fit cache key holds fit_params_key(cfg, params) of the
    unclamped params (plain floats, the floors applied inside it): a
    lambda under the 0.01 floor and an eval-only slider keep the cached
    fit; a fit-relevant change refits."""
    node, _ = _scene(TMesh, parms={"reducerig": 12, "reducemode": 1, "model": 2,
                                   "lambda": 0.001}, n_ctrl=40)
    with pytest.raises(mock_hou.NodeWarning, match="regress"):
        th.cook_sop(node, device="cpu")
    state = th._NODE_STATE[node.path()]
    key, fitted = state["reduce_fit"]
    cfg, params, _ = th.config_from_node(node)
    assert key[4] == fit_params_key(cfg, params)
    assert all(type(v) is float for v in key[4])
    assert key[4][3] == 0.01
    node._parms["lambda"] = 0.005          # floored to the same 0.01
    node._parms["falloffradius"] = 0.3     # eval-only
    th.cook_sop(node, device="cpu")        # silent: the cached fit
    assert state["reduce_fit"][1] is fitted
    node._parms["radius"] = 0.8            # the solve reads it
    with pytest.raises(mock_hou.NodeWarning, match="regress"):
        th.cook_sop(node, device="cpu")
    assert state["reduce_fit"][1] is not fitted
