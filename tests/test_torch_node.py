"""PyTorch port: FaceDeformNode.cook against the JAX package's node on the
same seeded inputs (a 40 x 40 sphere, 30 markers), CPU tensors.

Off the TPU the JAX node defers its eval to XLA's "auto"; off the card the
port's node defers to the plain "auto" path, so both sides compare like
with like.  Positions are held to 5e-5 of the motion scale (BASELINE.md's
budget), fd_falloff to 1e-6, and every other attribute at least as
tightly as the JAX package's own test of that op.
"""

import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
from facedeform_tpu.geometry.mesh import Mesh as JMesh
from facedeform_tpu.geometry.primitives import fibonacci_points, uv_sphere
from facedeform_tpu.geometry.topology import compute_tangent_frame as j_frame
from facedeform_tpu.node import FaceDeformNode as JNode
from facedeform_tpu_torch import (
    DeformConfig, DeformParams, Deformer, FaceDeformNode, Mesh, convert,
)
from facedeform_tpu_torch.deformer import AUTOTUNE_BACKENDS
from facedeform_tpu_torch.geometry.topology import compute_tangent_frame as t_frame
from facedeform_tpu_torch.ops import dbse
from facedeform_tpu_torch.ops import psd as tpsd
from facedeform_tpu_torch.utils import profiling
from facedeform_tpu_torch.utils.profiling import StageTimes

POS_RTOL = 5e-5       # of the motion scale (BASELINE.md)
FALLOFF_TOL = 1e-6
# transported N / v / orient and the stretches: the JAX package's own
# transport tests hold these to 1e-4 and looser (tests/test_attr_transport.py)
ATTR_TOL = 1e-5
# fd_stretch / fd_compress: the JAX package's f32 closed form sits up to
# ~2e-5 off (two close singular values); its own test against an SVD holds
# it to 1e-4 (tests/test_attr_transport.py), the port evaluates in float64
STRETCH_TOL = 1e-4
# after a morph or PSD pass the map's gradient adds the 1-ring LSQ
# gradient of the discrete field (ops/jacobian.apply_field_gradient),
# which scales the two packages' f32 differences of that field by the
# inverse edge length and the small Gram ridge: such attrs are held to
# 5e-5 of their largest magnitude (the JAX package's own morph-transport
# tests hold angles to degrees, tests/test_attr_transport.py)
COMPOSED_RTOL = 5e-5
WEIGHTS_TOL = 1e-4    # DBSE weights (tests/test_dbse.py)
PSD_W_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One torch intra-op thread, as the other JAX-parity tests run (see
    tests/test_torch_eval.py); never raised again."""
    torch.set_num_threads(1)


class _Side:
    """One package's constructors, so a case builds the same inputs twice."""

    def __init__(self, jax_side: bool):
        self.jax = jax_side
        self.Mesh = JMesh if jax_side else Mesh
        self.frame = j_frame if jax_side else t_frame
        self.cfg = jcfg.DeformConfig if jax_side else DeformConfig
        self.params = jcfg.DeformParams if jax_side else DeformParams

    def node(self):
        return JNode() if self.jax else FaceDeformNode(device="cpu")


def _rig_pose(rest, amp=0.2, center=(0, 1, 0), dirn=(0.3, 1.0, 0.0)):
    bump = amp * np.exp(-2 * np.sum((rest - np.float32(center)) ** 2, -1, keepdims=True))
    return (rest + bump * np.float32(dirn)).astype(np.float32)


def _bumps(points, n, seed, radius=0.4, amp=0.05):
    rng = np.random.default_rng(seed)
    sites = fibonacci_points(64)[rng.choice(64, n, replace=False)]
    normal = points / np.linalg.norm(points, axis=1, keepdims=True)
    return [(points + amp * np.exp(-np.sum((points - s) ** 2, -1) / radius ** 2)[:, None]
             * normal).astype(np.float32) for s in sites]


def _scene(side: _Side, n_rig=30, rig_kw=None):
    """(mesh, rest rig, deformed rig) Meshes of one package."""
    sphere = uv_sphere(40, 40)
    mesh = side.Mesh(points=sphere.points.copy(), faces=sphere.faces.copy())
    rest = fibonacci_points(n_rig)
    return (mesh, side.Mesh(points=rest),
            side.Mesh(points=_rig_pose(rest, **(rig_kw or {}))))


def _sculpt(side, mesh, pose_scale, bump):
    """An example pose of the rig and its sculpt (a localized bump on the
    rest mesh: any sculpt is reproduced at its own pose)."""
    g = np.exp(-4.0 * np.sum((mesh.points - [0, 0, 1]) ** 2, -1))
    return side.Mesh(points=(mesh.points + bump * g[:, None] * np.float32([0, 0, 1])
                             ).astype(np.float32)), pose_scale


def _posed(side, rest, scale):
    pts = rest.points.copy()
    pts[:, 1] *= np.float32(scale)
    return side.Mesh(points=pts)


# Each case: side -> (inputs, cfg kwargs, params kwargs, cook kwargs).
def _case_default(s):
    return _scene(s), {}, {}, {}


def _case_capture(s):
    mesh, r0, r1 = _scene(s)
    r0.set_attr("class", (np.arange(30) % 3).astype(np.int32))
    return (mesh, r0, r1), dict(dofalloff=True), dict(radius=0.5, maxedges=6), {}


def _case_group_pattern(s):
    mesh, r0, r1 = _scene(s)
    mesh.set_group("top", mesh.points[:, 1] > 0.3)
    mesh.set_group("east", mesh.points[:, 0] > 0.2)
    return (mesh, r0, r1), {}, {}, dict(group="top ^east")


def _case_tangent_frame(s):
    mesh, r0, r1 = _scene(s)
    s.frame(mesh)
    return (mesh, r0, r1), dict(tangent=True), {}, {}


def _morph_inputs(s, n=3):
    mesh, r0, r1 = _scene(s)
    return (mesh, r0, r1) + tuple(s.Mesh(points=b) for b in _bumps(mesh.points, n, seed=5))


def _case_morph_lstsq(s):
    return _morph_inputs(s), dict(morphspace=True), {}, {}


def _case_morph_robust(s):
    return _morph_inputs(s), dict(morphspace=True, dbse_robust=True), {}, {}


def _case_morph_parity_strict(s):
    return (_morph_inputs(s), dict(morphspace=True, dbse_lstsq=False, strict_parity=True,
                                   dofalloff=True), dict(radius=0.8, maxedges=8), {})


def _attr_mesh(s, mesh):
    s.frame(mesh)
    rng = np.random.default_rng(11)
    mesh.set_attr("v", rng.standard_normal((mesh.num_points, 3)).astype(np.float32))
    q = rng.standard_normal((mesh.num_points, 4)).astype(np.float32)
    mesh.set_attr("orient", q / np.linalg.norm(q, axis=1, keepdims=True))


def _case_transport(s):
    mesh, r0, r1 = _scene(s)
    _attr_mesh(s, mesh)
    return ((mesh, r0, r1), {}, {},
            dict(update_normals=True, transform_attrs=["v", "orient"], output_stretch=True))


def _case_morph_transport(s):
    inputs = _morph_inputs(s)
    _attr_mesh(s, inputs[0])
    return (inputs, dict(morphspace=True, dofalloff=True), dict(falloffradius=0.5, maxedges=8),
            dict(update_normals=True, transform_attrs=["v"], output_stretch=True))


def _case_recompute_normals(s):
    mesh, r0, r1 = _scene(s)
    s.frame(mesh)
    return ((mesh, r0, r1), {}, {}, dict(update_normals=True, recompute_normals=True))


def _case_symmetrize(s):
    mesh, r0, r1 = _scene(s, rig_kw=dict(center=(0.4, 0.8, 0.2)))
    return (mesh, r0, r1), {}, {}, dict(symmetrize="x")


def _psd_examples(s, mesh, r0, scales=((1.10, 0.15), (0.92, -0.1))):
    return [(_posed(s, r0, k), _sculpt(s, mesh, k, b)[0]) for k, b in scales]


def _case_psd(s):
    mesh, r0, _ = _scene(s)
    ex = _psd_examples(s, mesh, r0)
    return (mesh, r0, ex[0][0]), {}, {}, dict(examples=ex)


def _case_psd_align_normalize(s):
    mesh, r0, _ = _scene(s)
    ex = _psd_examples(s, mesh, r0)
    s.frame(mesh)
    return ((mesh, r0, _posed(s, r0, 1.03)), {}, {},
            dict(examples=ex, psd_align=True, psd_normalize=True, update_normals=True))


def _case_psd_group(s):
    mesh, r0, _ = _scene(s)
    ex = _psd_examples(s, mesh, r0)
    return ((mesh, r0, ex[1][0]), {}, {},
            dict(examples=ex, group_mask=mesh.points[:, 2] > 0.0))


def _case_secondary(s):
    mesh, r0, r1 = _scene(s)
    teeth = uv_sphere(10, 12)
    a = s.Mesh(points=(0.5 * teeth.points + np.float32([0, 0.3, 0])).astype(np.float32),
               faces=teeth.faces.copy())
    b = s.Mesh(points=(0.3 * teeth.points).astype(np.float32), faces=teeth.faces.copy())
    s.frame(b)
    return ((mesh, r0, r1), dict(tangent=True), {},
            dict(secondary=[a, b], recompute_normals=True))


def _case_pu(s):
    return _scene(s), dict(solver="pu"), {}, {}


def _case_tps(s):
    return (_scene(s), dict(model=jcfg.RBFModelType.KERNEL, kernel=jcfg.RBFKernel.THIN_PLATE),
            dict(radius=1.0, lam=0.01), {})


def _case_confidence(s):
    mesh, r0, r1 = _scene(s)
    r0.set_attr("confidence", np.linspace(0.3, 1.0, 30).astype(np.float32))
    return ((mesh, r0, r1), dict(model=jcfg.RBFModelType.MULTILAYER, layers=2),
            dict(radius=1.2, lam=0.05), {})


def _case_confidence_qnn(s):
    mesh, r0, r1 = _scene(s)
    r0.set_attr("confidence", np.linspace(0.3, 1.0, 30).astype(np.float32))
    return (mesh, r0, r1), {}, {}, {}


def _case_picked(s):
    return _scene(s), dict(dofalloff=True), dict(radius=0.7, maxedges=8), dict(picked=True)


CASES = {
    "default": _case_default,
    "capture": _case_capture,
    "group_pattern": _case_group_pattern,
    "tangent_frame": _case_tangent_frame,
    "morph_lstsq": _case_morph_lstsq,
    "morph_robust": _case_morph_robust,
    "morph_parity_strict": _case_morph_parity_strict,
    "transport": _case_transport,
    "morph_transport": _case_morph_transport,
    "recompute_normals": _case_recompute_normals,
    "symmetrize": _case_symmetrize,
    "psd": _case_psd,
    "psd_align_normalize": _case_psd_align_normalize,
    "psd_group": _case_psd_group,
    "secondary": _case_secondary,
    "pu": _case_pu,
    "tps": _case_tps,
    "confidence": _case_confidence,
    "confidence_qnn": _case_confidence_qnn,
    "picked": _case_picked,
}


def _cook(side, case):
    inputs, cfg_kw, params_kw, cook_kw = case(side)
    node = side.node()
    res = node.cook(list(inputs), side.cfg(**cfg_kw), side.params(**params_kw), **cook_kw)
    return res, inputs[0].points, [m.points for m in cook_kw.get("secondary", ())]


def _assert_mesh_close(jm, tm, rest, what):
    scale = float(np.abs(jm.points - rest).max())
    assert scale > 0, what
    err = float(np.abs(tm.points.astype(np.float64) - jm.points).max())
    assert err <= POS_RTOL * scale, (what, err, scale)
    np.testing.assert_allclose(tm.point_attrs["fd_falloff"], jm.point_attrs["fd_falloff"],
                               rtol=0, atol=FALLOFF_TOL, err_msg=what)


def _assert_cook_close(jres, tres, rest, sec_rest=()):
    _assert_mesh_close(jres.mesh, tres.mesh, rest, "main mesh")
    assert tres.warnings == jres.warnings
    assert len(tres.messages) == len(jres.messages)
    for tm, jm in zip(tres.messages, jres.messages):
        if jm.startswith("Solve residual"):
            assert tm.startswith("Solve residual"), tm   # the numbers are each solve's
        else:
            assert tm == jm
    assert tres.transported == jres.transported
    composed = jres.weights is not None or "psd_weights" in jres.mesh.detail_attrs
    for name in jres.transported:
        tol = STRETCH_TOL if name in ("fd_stretch", "fd_compress") else ATTR_TOL
        if composed:
            tol = max(tol, COMPOSED_RTOL * float(np.abs(jres.mesh.attr(name)).max()))
        np.testing.assert_allclose(tres.mesh.attr(name), jres.mesh.attr(name),
                                   rtol=0, atol=tol, err_msg=name)
    for name in ("Cd", "rest"):
        if name in jres.mesh.point_attrs:
            np.testing.assert_allclose(tres.mesh.attr(name), jres.mesh.attr(name),
                                       rtol=0, atol=FALLOFF_TOL, err_msg=name)
    if jres.weights is None:
        assert tres.weights is None
    else:
        np.testing.assert_allclose(tres.weights, jres.weights, rtol=0, atol=WEIGHTS_TOL)
    if "psd_weights" in jres.mesh.detail_attrs:
        np.testing.assert_allclose(tres.mesh.detail_attrs["psd_weights"],
                                   jres.mesh.detail_attrs["psd_weights"], rtol=0, atol=PSD_W_TOL)
    if jres.capture is not None:
        np.testing.assert_array_equal(tres.capture.captured, jres.capture.captured)
        np.testing.assert_allclose(tres.capture.dist2, jres.capture.dist2, rtol=1e-5, atol=1e-6)
    assert len(tres.secondary) == len(jres.secondary)
    for i, (js, ts, r) in enumerate(zip(jres.secondary, tres.secondary, sec_rest)):
        _assert_mesh_close(js, ts, r, f"secondary {i}")
        if "N" in js.point_attrs:
            np.testing.assert_allclose(ts.attr("N"), js.attr("N"), rtol=0, atol=ATTR_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_cook_matches_jax(name):
    jres, rest, sec_rest = _cook(_Side(True), CASES[name])
    tres, _, _ = _cook(_Side(False), CASES[name])
    _assert_cook_close(jres, tres, rest, sec_rest)


# ------------------------------------------------------------------ errors
def _err_too_few(s):
    m = s.Mesh(points=uv_sphere(10, 10).points)
    return [m, m], {}


def _err_rig_mismatch(s):
    mesh, r0, _ = _scene(s)
    return [mesh, r0, s.Mesh(points=fibonacci_points(31))], {}


def _err_group_and_mask(s):
    mesh, r0, r1 = _scene(s)
    mesh.set_group("top", mesh.points[:, 1] > 0)
    return [mesh, r0, r1], dict(group="top", group_mask=mesh.points[:, 1] > 0)


def _err_nan_rig(s):
    mesh, r0, r1 = _scene(s, n_rig=20)
    bad = np.where(np.arange(60).reshape(20, 3) == 0, np.nan, r1.points).astype(np.float32)
    return [mesh, r0, s.Mesh(points=bad)], {}


ERROR_CASES = {
    "too_few_inputs": (_err_too_few, "ShapeMismatchError"),
    "rig_mismatch": (_err_rig_mismatch, "ShapeMismatchError"),
    "group_and_mask": (_err_group_and_mask, "ValueError"),
    "nan_rig": (_err_nan_rig, "SolveFailedError"),
}


@pytest.mark.parametrize("name", list(ERROR_CASES))
def test_cook_errors_match_jax(name):
    build, want = ERROR_CASES[name]
    raised = []
    for side in (_Side(True), _Side(False)):
        inputs, kw = build(side)
        with pytest.raises(Exception) as e:
            side.node().cook(inputs, **kw)
        raised.append(type(e.value).__name__)
    assert raised == [want, want]


def test_mesh_devices_raises_slice_h():
    mesh, r0, r1 = _scene(_Side(False))
    with pytest.raises(NotImplementedError, match="slice H"):
        FaceDeformNode(device="cpu").cook([mesh, r0, r1], mesh_devices=object())


# ------------------------------------------------------ caches and the drag
def test_cache_reuse_and_drag_refit_matches_fresh_fit():
    """Unchanged inputs reuse capture and solve; a pose-only change re-solves
    through the cached FitPlan, equal to a fresh node's cook bit for bit and
    to the JAX node's drag within the budget; stage times name the stages
    that ran."""
    side = _Side(False)
    mesh, r0, r1 = _scene(side)
    cfg, params = DeformConfig(dofalloff=True), DeformParams(radius=0.8, maxedges=8)
    node = FaceDeformNode(device="cpu")
    times = StageTimes()
    node.cook([mesh, r0, r1], cfg, params, times=times)
    assert {"capture", "solve", "eval", "output"} <= set(times.ms)
    deformer, capkey, plan = node._deformer, node._capture_key, node._plan
    times2 = StageTimes()
    node.cook([mesh, r0, r1], cfg, params, times=times2)
    assert node._deformer is deformer and node._capture_key == capkey
    assert "capture" not in times2.ms and "solve" not in times2.ms and "eval" in times2.ms
    # an eval-only knob keeps the solve, refreshes the knobs
    node.cook([mesh, r0, r1], cfg, params._replace(falloffrate=2.0))
    assert node._deformer.model is deformer.model
    # the drag: new pose, same rest rig -> refit through the same plan
    jside = _Side(True)
    jmesh, jr0, _ = _scene(jside)
    jnode = JNode()
    jnode.cook([jmesh, jr0, jside.Mesh(points=r1.points)], jside.cfg(dofalloff=True),
               jside.params(radius=0.8, maxedges=8))
    for step in range(3):
        pose = _rig_pose(r0.points, amp=0.2 + 0.05 * step, dirn=(0.1 * step, 1.0, 0.2))
        got = node.cook([mesh, r0, Mesh(points=pose)], cfg, params).mesh.points
        assert node._plan is plan
        fresh = FaceDeformNode(device="cpu").cook([mesh, r0, Mesh(points=pose)], cfg,
                                                  params).mesh.points
        np.testing.assert_array_equal(got, fresh)
        want = jnode.cook([jmesh, jr0, jside.Mesh(points=pose)], jside.cfg(dofalloff=True),
                          jside.params(radius=0.8, maxedges=8)).mesh.points
        scale = float(np.abs(want - mesh.points).max())
        assert np.abs(got.astype(np.float64) - want).max() <= POS_RTOL * scale
    # maxedges recaptures
    node.cook([mesh, r0, r1], cfg, params._replace(maxedges=6))
    assert node._capture_key != capkey


ROUTES = {"dense": {}, "krylov": dict(solver="krylov"), "pu": dict(solver="pu")}


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_seam_keeps_what_each_route_keeps(route):
    """Poses A, B, A through one node: each cook equals a fresh node's cook
    of its pose bit for bit, and the cooks' spans and counters show what
    the route's plan (deformer.fit_route) keeps.  The dense route factors
    once and refits the later poses; the PU route builds its patches, its
    patch factorizations and its eval plan for the first pose only and
    solves the later poses against them; the Krylov route has no plan and
    fits every pose."""
    mesh, r0, _ = _scene(_Side(False))
    cfg, params = DeformConfig(**ROUTES[route]), DeformParams()
    a = Mesh(points=_rig_pose(r0.points))
    b = Mesh(points=_rig_pose(r0.points, amp=0.3, dirn=(0.2, 1.0, 0.1)))
    fresh = [FaceDeformNode(device="cpu").cook([mesh, r0, p], cfg, params).mesh.points
             for p in (a, b, a)]
    node = FaceDeformNode(device="cpu")
    first = profiling._REC.next_id
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = [node.cook([mesh, r0, p], cfg, params).mesh.points for p in (a, b, a)]
    for g, f in zip(got, fresh):
        np.testing.assert_array_equal(g, f)
    recorded = [s for s in profiling.spans() if s.id >= first]
    roots = [s for s in recorded if s.parent is None]
    assert [s.name for s in roots] == ["FaceDeformNode.cook"] * 3

    def spans_named(name):
        return [sum(s.name == name for s in recorded if s.request == r.request) for r in roots]

    def moved(name):
        return [r.counters.get(name, 0) for r in roots]

    assert spans_named("solve") == [1, 1, 1]
    if route == "dense":
        assert type(node._plan).__name__ == "FitPlan"
        assert spans_named("fit.factor") == [1, 0, 0]
        assert spans_named("fit.refit") == [0, 1, 1]
    elif route == "pu":
        assert type(node._plan).__name__ == "PUFitPlan"
        assert moved("pu.patch_sets") == [1, 0, 0]
        assert spans_named("fit.factor")[0] > 0 and spans_named("fit.factor")[1:] == [0, 0]
        assert moved("pu.fit_hits") == [0, 1, 1]
        assert moved("pu.plans") == [1, 0, 0] and moved("pu.plan_hits") == [0, 1, 1]
        assert spans_named("fit.refit") == [0, 0, 0]
    else:
        assert node._plan is None
        assert all(n > 0 for n in moved("fit.gmres_restarts"))
        assert spans_named("fit.refit") == [0, 0, 0]


class _TimedEvent:
    """torch.cuda.Event on the CPU: a timed eval reads a fixed time for the
    backend it ran, so the autotune's choice is known."""

    ms = {"cuda": 2.0, "cuda_culled": 1.0}
    ran = None

    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return self.ms[_TimedEvent.ran]


@pytest.fixture
def two_candidates(monkeypatch):
    """Every deformer names the dense and the culled kernel for the
    autotune, and either backend evaluates on the CPU path, so a CPU node
    times two candidates as a card's does."""
    real_apply = Deformer.apply

    def apply(self, points, *args, backend="auto", **kw):
        if backend in AUTOTUNE_BACKENDS:
            _TimedEvent.ran, backend = backend, "auto"
        return real_apply(self, points, *args, backend=backend, **kw)

    monkeypatch.setattr(Deformer, "autotune_backends", lambda self, n: AUTOTUNE_BACKENDS)
    monkeypatch.setattr(Deformer, "apply", apply)
    monkeypatch.setattr(torch.cuda, "Event", _TimedEvent)


def _tuned_cook(node, inputs, cfg, params, **kw):
    """(P, (autotune runs, autotune hits)) of one cook."""
    names = ("eval.autotune_runs", "eval.autotune_hits")
    before = [profiling.counter(n) for n in names]
    pts = node.cook(inputs, cfg, params, **kw).mesh.points
    return pts, tuple(profiling.counter(n) - b for n, b in zip(names, before))


def test_autotune_choice_is_kept_across_poses(two_candidates):
    """Poses A, B, A of one rest rig time the two kernels once: the later
    cooks reuse the choice (an autotune hit each), each cook equal to a
    fresh node's bit for bit; an eval-only param change keeps it too."""
    mesh, r0, _ = _scene(_Side(False))
    cfg, params = DeformConfig(dofalloff=True), DeformParams()
    a = Mesh(points=_rig_pose(r0.points))
    b = Mesh(points=_rig_pose(r0.points, amp=0.3, dirn=(0.2, 1.0, 0.1)))
    node = FaceDeformNode(device="cpu")
    for pose, want in zip((a, b, a), ((1, 0), (0, 1), (0, 1))):
        got, moved = _tuned_cook(node, [mesh, r0, pose], cfg, params)
        assert moved == want
        fresh = FaceDeformNode(device="cpu").cook([mesh, r0, pose], cfg, params)
        np.testing.assert_array_equal(got, fresh.mesh.points)
        assert node.backend_timings == {"cuda": 2.0, "cuda_culled": 1.0}
        assert node.last_backend == "cuda_culled"
    _, moved = _tuned_cook(node, [mesh, r0, b], cfg, params._replace(falloffrate=2.0))
    assert moved == (0, 1)


def _moved_rest(mesh, r0, cfg, params):
    rest = Mesh(points=(r0.points * np.float32(1.05)).astype(np.float32))
    return mesh, rest, params, {}


def _moved_mesh(mesh, r0, cfg, params):
    return (Mesh(points=(mesh.points * np.float32(1.02)).astype(np.float32),
                 faces=mesh.faces.copy()), r0, params, {})


def _new_radius(mesh, r0, cfg, params):
    return mesh, r0, params._replace(radius=0.8), {}


def _second_checkpoint(mesh, r0, cfg, params):
    pose = _rig_pose(r0.points, amp=0.25)
    d = Deformer.fit(r0.points, pose, cfg, params, device="cpu")
    return mesh, r0, params, {"deformer": d}


@pytest.mark.parametrize("change", [_moved_rest, _moved_mesh, _new_radius, _second_checkpoint],
                         ids=["rest_rig", "mesh_positions", "radius", "external_deformer"])
def test_autotune_reruns_once_when_its_key_moves(two_candidates, change):
    """A moved rest rig, a new mesh pos_id, a fit param (radius) or a
    second external deformer after a first re-times the kernels once; the
    next pose under the change keeps that choice.  Each cook equals a fresh
    node's bit for bit."""
    mesh, r0, _ = _scene(_Side(False))
    cfg, params = DeformConfig(dofalloff=True), DeformParams()
    first = {}
    if change is _second_checkpoint:
        first = {"deformer": Deformer.fit(r0.points, _rig_pose(r0.points), cfg, params,
                                          device="cpu")}
    mesh2, r2, params2, kw = change(mesh, r0, cfg, params)
    cooks = [(mesh, r0, params, first, _rig_pose(r0.points)),
             (mesh2, r2, params2, kw, _rig_pose(r2.points, amp=0.3)),
             (mesh2, r2, params2, kw, _rig_pose(r2.points))]
    node = FaceDeformNode(device="cpu")
    for (m, rest, p, cook_kw, pose), want in zip(cooks, ((1, 0), (1, 0), (0, 1))):
        inputs = [m, rest, Mesh(points=pose)]
        got, moved = _tuned_cook(node, inputs, cfg, p, **cook_kw)
        assert moved == want
        fresh = FaceDeformNode(device="cpu").cook(inputs, cfg, p, **cook_kw)
        np.testing.assert_array_equal(got, fresh.mesh.points)


def test_node_passes_equal_their_ops():
    """The node adds no arithmetic: its RBF pass equals Deformer.apply on
    the backend it took, bit for bit, and its morph pass equals dbse
    called directly."""
    side = _Side(False)
    inputs = _morph_inputs(side)
    mesh = inputs[0]
    cfg = DeformConfig(morphspace=True, dofalloff=True)
    params = DeformParams(radius=0.8, maxedges=8, falloffradius=0.5)
    node = FaceDeformNode(device="cpu")
    rbf = node.cook(list(inputs[:3]), DeformConfig(dofalloff=True), params)
    d = node._deformer
    want, w = d.apply(mesh.points, dist2=rbf.capture.dist2, backend=node.last_backend)
    np.testing.assert_array_equal(rbf.mesh.points, want.numpy())
    np.testing.assert_array_equal(rbf.mesh.point_attrs["fd_falloff"], w.numpy())
    res = node.cook(list(inputs), cfg, params)
    model = dbse.build_model(mesh.points, [b.points for b in inputs[3:]], device="cpu")
    rest = torch.as_tensor(mesh.points)
    wts, _ = dbse.weights_lstsq(model, want, rest)
    morphed = dbse.morph_apply(model, want, rest, wts, cfg, params)
    np.testing.assert_array_equal(res.mesh.points, morphed.numpy())
    np.testing.assert_array_equal(res.weights, wts.numpy())


def test_external_deformer_matches_jax():
    """cook(deformer=...) skips the solve; solve fields come from the
    deformer's fit, eval toggles from the cook's cfg; a rig-size mismatch
    warns (the JAX node's contract, tests/test_node_extras.py)."""
    out = {}
    for side in (_Side(True), _Side(False)):
        mesh, r0, r1 = _scene(side)
        cfg = side.cfg(model=jcfg.RBFModelType.KERNEL, kernel=jcfg.RBFKernel.MULTIQUADRIC,
                       dofalloff=True)
        params = side.params(radius=1.5, maxedges=8)
        fit_node = side.node()
        base = fit_node.cook([mesh, r0, r1], cfg, params)
        node = side.node()
        res = node.cook([mesh, r0, r1], side.cfg(dofalloff=True), params,
                        deformer=fit_node._deformer)
        np.testing.assert_array_equal(res.mesh.points, base.mesh.points)
        side.frame(mesh)
        res_t = node.cook([mesh, r0, r1], side.cfg(dofalloff=True, tangent=True), params,
                          deformer=fit_node._deformer)
        small = node.cook([mesh, side.Mesh(points=r0.points[:20]),
                           side.Mesh(points=r1.points[:20])], side.cfg(), params,
                          deformer=fit_node._deformer)
        out[side.jax] = (res, res_t, small)
    for j, t in zip(out[True], out[False]):
        _assert_cook_close(j, t, uv_sphere(40, 40).points)
    assert any("precomputed deformer" in w for w in out[False][2].warnings)


def test_psd_model_carried_from_jax():
    """A JAX node's fitted PSD model carries across through
    convert.psd_model_from_numpy: cook(psd=...) in the port equals the JAX
    node's cook(psd=...), and psd_state() hands back the carried model."""
    jside, tside = _Side(True), _Side(False)
    jmesh, jr0, _ = _scene(jside)
    ex = _psd_examples(jside, jmesh, jr0)
    jnode = JNode()
    jnode.cook([jmesh, jr0, ex[0][0]], examples=ex, psd_normalize=True)
    jpsd, _ = jnode.psd_state()
    model = convert.psd_model_from_numpy(
        {f: np.asarray(getattr(jpsd.model, f)) for f in jpsd.model._fields}, device="cpu")
    tpsd_d = tpsd.PSDDeformer(model, kernel=int(jpsd.kernel), normalize=jpsd.normalize,
                              align=jpsd.align)
    pose = _posed(jside, jr0, 1.04).points
    want = JNode().cook([jmesh, jr0, jside.Mesh(points=pose)], psd=jpsd)
    tmesh, tr0, _ = _scene(tside)
    node = FaceDeformNode(device="cpu")
    got = node.cook([tmesh, tr0, Mesh(points=pose)], psd=tpsd_d)
    _assert_cook_close(want, got, jmesh.points)
    state, corr = node.psd_state()
    assert state is tpsd_d and corr is model.corrections


def test_psd_examples_reproduce_sculpt_and_cache():
    """At an example pose the cook reproduces its sculpt; the fit is
    reused at a new pose and refitted when a PSD knob changes."""
    side = _Side(False)
    mesh, r0, _ = _scene(side)
    ex = _psd_examples(side, mesh, r0)
    node = FaceDeformNode(device="cpu")
    res = node.cook([mesh, r0, ex[0][0]], examples=ex)
    scale = float(np.abs(ex[0][1].points - mesh.points).max())
    assert np.abs(res.mesh.points - ex[0][1].points).max() <= POS_RTOL * scale
    np.testing.assert_allclose(res.mesh.detail_attrs["psd_weights"], [1.0, 0.0], atol=PSD_W_TOL)
    fitted = node._psd_deformer
    node.cook([mesh, r0, _posed(side, r0, 1.05)], examples=ex)
    assert node._psd_deformer is fitted
    node.cook([mesh, r0, ex[0][0]], examples=ex, psd_lam=0.05)
    assert node._psd_deformer is not fitted
    res_dup = FaceDeformNode(device="cpu").cook([mesh, r0, ex[0][0]], examples=[ex[0], ex[0]])
    assert any("duplicate example poses" in w for w in res_dup.warnings)


def test_solve_report_read_once(monkeypatch):
    """The solve message's four scalars cross to the host in one copy."""
    calls = []
    real = torch.Tensor.cpu

    def counted(t, *a, **k):
        calls.append(tuple(t.shape))
        return real(t, *a, **k)

    mesh, r0, r1 = _scene(_Side(False))
    node = FaceDeformNode(device="cpu")
    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    res = node.cook([mesh, r0, r1])
    assert (4,) in calls
    assert res.messages[0].startswith("Solve residual") and "cond est" in res.messages[0]
