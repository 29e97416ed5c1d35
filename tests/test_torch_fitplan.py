"""PyTorch port: the interactive-drag FitPlan (ops/fit.prepare/refit,
Deformer.fit_with_plan), the plain deform step apply_fn, apply's Z-order
round trip, the model fronts, and check_frames' Krylov-CPD route, against
the port's own fit and the JAX package's counterparts."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
from facedeform_tpu import models as jmodels
from facedeform_tpu.deformer import Deformer as JDeformer
from facedeform_tpu.deformer import FitPlan as JFitPlan
from facedeform_tpu.geometry.primitives import fibonacci_points, uv_sphere
from facedeform_tpu.utils import errors as jerrors
from facedeform_tpu_torch import (
    Deformer, FitPlan, KernelZooDeformModel, MultilayerDeformModel, PartitionOfUnityModel,
    QNNDeformModel, convert,
)
from facedeform_tpu_torch.deformer import apply_fn
from facedeform_tpu_torch.ops import fit as tfit
from facedeform_tpu_torch.ops.morton import spatial_order
from facedeform_tpu_torch.ops.solve import SolveReport
from facedeform_tpu_torch.utils import errors

K = jcfg.RBFKernel
M = jcfg.RBFModelType
BUDGET = 5e-5     # growing kernels, port vs JAX field (tests/test_torch_precise.py)
FIELD_TOL = 1e-5  # decaying kernels, port vs JAX field (tests/test_torch_fit.py)

CFGS = [
    ("gaussian", dict(model=M.KERNEL, kernel=K.GAUSSIAN), dict(radius=0.3, lam=0.01)),
    ("multilayer3", dict(model=M.MULTILAYER, layers=3), dict(radius=1.0, lam=0.05)),
    ("tps", dict(model=M.KERNEL, kernel=K.THIN_PLATE), dict(radius=1.0, lam=0.01)),
    ("qnn", dict(model=M.QNN), dict()),
]
FIELDS = ("ctrl", "w_rbf", "w_poly", "eps", "w_rbf_lo", "w_poly_lo")


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One torch intra-op thread, as tests/test_torch_krylov.py's fixture
    of this name sets it (the count is never raised again)."""
    torch.set_num_threads(1)


def _port(cfg_kw, params_kw):
    jc = jcfg.DeformConfig(**cfg_kw)
    jp = jcfg.DeformParams(**params_kw)
    return (jc, jp, convert.config_from_fields(dataclasses.asdict(jc)),
            convert.params_from_fields(jp._asdict()))


def _poses(n=150, seed=0):
    rng = np.random.default_rng(seed)
    rest = fibonacci_points(n)
    pose_a = rest + 0.05 * rng.standard_normal((n, 3)).astype(np.float32)
    pose_b = rest + 0.05 * rng.standard_normal((n, 3)).astype(np.float32)
    return rest, pose_a, pose_b


def _assert_same_model(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f


def _assert_same_report(got, want):
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


@pytest.mark.parametrize("name,cfg_kw,params_kw", CFGS, ids=[c[0] for c in CFGS])
def test_refit_equals_fit_bit_for_bit(name, cfg_kw, params_kw):
    """plan.refit(pose) == Deformer.fit(rest, pose), every field (lo words
    included) and the report, through both ways of getting a plan."""
    _, _, tc, tp = _port(cfg_kw, params_kw)
    rest, pose_a, pose_b = _poses()
    d_a, plan = Deformer.fit_with_plan(rest, pose_a, tc, tp, device="cpu")
    _assert_same_model(d_a.model, Deformer.fit(rest, pose_a, tc, tp, device="cpu").model)
    want = Deformer.fit(rest, pose_b, tc, tp, device="cpu")
    for p in (plan, FitPlan.prepare(rest, tc, tp, device="cpu")):
        got = p.refit(pose_b)
        _assert_same_model(got.model, want.model)
        _assert_same_report(got.report, want.report)
        assert got.cfg == tc and got.params == tp
    assert plan.num_controls == rest.shape[0]
    if name == "tps":   # the float64 pair rides in the plan
        assert plan.factors.layers[0].a_lo is not None
        assert want.model.w_rbf_lo is not None


def test_refit_with_confidence_equals_fit():
    """The per-marker ridge is baked into the plan."""
    _, _, tc, tp = _port(dict(model=M.KERNEL, kernel=K.GAUSSIAN), dict(radius=0.3, lam=0.01))
    rest, pose_a, pose_b = _poses()
    conf = np.random.default_rng(3).uniform(0.0005, 1.0, rest.shape[0]).astype(np.float32)
    _, plan = Deformer.fit_with_plan(rest, pose_a, tc, tp, confidence=conf, device="cpu")
    want = Deformer.fit(rest, pose_b, tc, tp, confidence=conf, device="cpu")
    _assert_same_model(plan.refit(pose_b).model, want.model)
    _assert_same_model(FitPlan.prepare(rest, tc, tp, confidence=conf, device="cpu")
                       .refit(pose_b).model, want.model)
    assert plan.factors.lam0.shape == (rest.shape[0],)


@pytest.mark.parametrize("name,cfg_kw,params_kw", CFGS, ids=[c[0] for c in CFGS])
def test_refit_matches_jax(name, cfg_kw, params_kw):
    jc, jp, tc, tp = _port(cfg_kw, params_kw)
    rest, pose_a, pose_b = _poses()
    probes = 1.1 * np.random.default_rng(1).standard_normal((300, 3)).astype(np.float32)
    _, jplan = JDeformer.fit_with_plan(rest, pose_a, jc, jp)
    _, tplan = Deformer.fit_with_plan(rest, pose_a, tc, tp, device="cpu")
    want = np.asarray(jplan.refit(pose_b).displacement(probes))
    got = tplan.refit(pose_b).displacement(probes).numpy()
    tol = BUDGET if name == "tps" else FIELD_TOL
    np.testing.assert_allclose(got, want, atol=tol)


def test_gates_and_validation():
    rest, pose_a, _ = _poses(48)
    tc = convert.config_from_fields(dataclasses.asdict(jcfg.DeformConfig(solver="krylov")))
    with pytest.raises(ValueError, match="Krylov"):
        Deformer.fit_with_plan(rest, pose_a, tc, device="cpu")
    pu = convert.config_from_fields(dataclasses.asdict(jcfg.DeformConfig(solver="pu")))
    with pytest.raises(ValueError, match="PU"):
        Deformer.fit_with_plan(rest, pose_a, pu, device="cpu")
    default = convert.config_from_fields(dataclasses.asdict(jcfg.DeformConfig()))
    for cfg, n in ((pu, 10), (default, 10_000), (default, 1000), (tc, 10)):
        jc = jcfg.DeformConfig(solver=cfg.solver)
        assert FitPlan.supports(cfg, n) == JFitPlan.supports(jc, n)
    assert FitPlan.supports(default, 8192) and not FitPlan.supports(default, 8193)
    _, plan = Deformer.fit_with_plan(rest, pose_a, default, device="cpu")
    with pytest.raises(errors.ShapeMismatchError):
        plan.refit(pose_a[:-1])
    for call in (lambda: tfit.prepare(torch.as_tensor(rest), tc),
                 lambda: tfit.fit_with_factors(torch.as_tensor(rest), torch.as_tensor(pose_a), tc),
                 lambda: FitPlan.prepare(rest, tc, device="cpu")):
        with pytest.raises(ValueError, match="dense-route"):
            call()


def test_refit_raises_on_a_degenerate_rig():
    """The plan checks each refit at the dense threshold: a QNN rig of
    coincident markers (no ridge) fails its solve."""
    rig = np.zeros((20, 3), np.float32)
    tc = convert.config_from_fields(dataclasses.asdict(jcfg.DeformConfig()))
    plan = FitPlan.prepare(rig, tc, device="cpu")
    with pytest.raises(errors.SolveFailedError):
        plan.refit(rig + 0.1)


# ------------------------------------------------------------ apply paths
def _shuffled_sphere(seed=5):
    pts = uv_sphere(40, 40).points * 1.02
    return pts[np.random.default_rng(seed).permutation(pts.shape[0])]


@pytest.mark.parametrize("name,cfg_kw,params_kw", CFGS[:3], ids=[c[0] for c in CFGS[:3]])
def test_apply_fn_and_spatial_perm_equal_apply(name, cfg_kw, params_kw):
    """apply_fn is apply's plain f32 step; apply(spatial_perm=) on a
    shuffled sphere takes the Z-order round trip and gives apply's result
    (per-vertex evaluations, so only the summation order of a row could
    differ)."""
    _, _, tc, tp = _port(dict(cfg_kw, tangent=True), params_kw)
    rest, pose_a, _ = _poses()
    d = Deformer.fit(rest, pose_a, tc, tp, device="cpu")
    pts = _shuffled_sphere()
    rng = np.random.default_rng(2)
    dist2 = np.abs(0.5 * rng.standard_normal(pts.shape[0])).astype(np.float32)
    mask = rng.uniform(size=pts.shape[0]) > 0.2
    frame = tuple(rng.standard_normal(pts.shape).astype(np.float32) for _ in range(3))
    kw = dict(dist2=dist2, frame=frame, group_mask=mask)
    want, want_w = d.apply(pts, backend="dense", **kw)
    got, got_w = apply_fn(d.model, pts, dist2, tuple(map(torch.as_tensor, frame)),
                          torch.as_tensor(mask), tc, tp)
    assert torch.equal(got, want) and torch.equal(got_w, want_w)
    perm = spatial_order(torch.as_tensor(pts))
    auto, auto_w = d.apply(pts, **kw)
    z, z_w = d.apply(pts, spatial_perm=perm, **kw)
    torch.testing.assert_close(z, auto, rtol=0, atol=1e-6)
    assert torch.equal(z_w, auto_w)
    np.testing.assert_array_equal(z.numpy()[~mask], pts[~mask])
    assert not torch.equal(perm[0], torch.arange(pts.shape[0]))


# ------------------------------------------------------------ model fronts
FRONTS = [
    ("qnn", QNNDeformModel(qcoef=1.2, zcoef=4.0, device="cpu"),
     jmodels.QNNDeformModel(qcoef=1.2, zcoef=4.0)),
    ("multilayer", MultilayerDeformModel(radius=1.0, layers=3, lam=0.05, device="cpu"),
     jmodels.MultilayerDeformModel(radius=1.0, layers=3, lam=0.05)),
    ("kernel_zoo_imq", KernelZooDeformModel(kernel=K.INVERSE_MULTIQUADRIC, radius=0.3,
                                            device="cpu"),
     jmodels.KernelZooDeformModel(kernel=K.INVERSE_MULTIQUADRIC, radius=0.3)),
    ("kernel_zoo_tps", KernelZooDeformModel(kernel=K.THIN_PLATE, device="cpu"),
     jmodels.KernelZooDeformModel(kernel=K.THIN_PLATE)),
]


@pytest.mark.parametrize("name,front,jfront", FRONTS, ids=[c[0] for c in FRONTS])
def test_model_front_is_deformer_fit(name, front, jfront):
    rest, pose_a, _ = _poses()
    probes = 1.1 * np.random.default_rng(4).standard_normal((300, 3)).astype(np.float32)
    d = front.fit(rest, pose_a)
    assert isinstance(d, Deformer) and d.model.device.type == "cpu"
    assert d.cfg == front._config() and d.params == front._params()
    _assert_same_model(d.model, Deformer.fit(rest, pose_a, front._config(), front._params(),
                                             device="cpu").model)
    want = np.asarray(jfront.fit(rest, pose_a).displacement(probes))
    tol = BUDGET if name == "kernel_zoo_tps" else FIELD_TOL
    np.testing.assert_allclose(d.displacement(probes).numpy(), want, atol=tol)


def test_partition_of_unity_front():
    from facedeform_tpu_torch.ops.pu import PUDeformer

    rng = np.random.default_rng(6)
    rest = fibonacci_points(400)
    pose = rest + 0.05 * rng.standard_normal(rest.shape).astype(np.float32)
    probes = 0.9 * fibonacci_points(200)
    front = PartitionOfUnityModel(patch_size=96, device="cpu")
    d = front.fit(rest, pose)
    assert isinstance(d, PUDeformer)
    want = PUDeformer.fit(rest, pose, kernel=K.THIN_PLATE, patch_size=96, device="cpu")
    np.testing.assert_array_equal(d.displacement(probes).numpy(),
                                  want.displacement(probes).numpy())
    jd = jmodels.PartitionOfUnityModel(patch_size=96).fit(rest, pose)
    np.testing.assert_allclose(d.displacement(probes).numpy(),
                               np.asarray(jd.displacement(jnp.asarray(probes))), atol=BUDGET)


# --------------------------------------------------- check_frames' routes
TPS_KRYLOV = convert.config_from_fields(dataclasses.asdict(
    jcfg.DeformConfig(model=M.KERNEL, kernel=K.THIN_PLATE, solver="krylov")))
TPS_DIRECT = dataclasses.replace(TPS_KRYLOV, solver="direct")


def _shot(n=40, f=4, seed=7):
    rng = np.random.default_rng(seed)
    rest = fibonacci_points(n)
    return rest, rest[None] + 0.05 * rng.standard_normal((f, n, 3)).astype(np.float32)


def _report(resid, scale, col=None):
    resid = torch.as_tensor(resid, dtype=torch.float64)
    return SolveReport(residual_norm=resid, rhs_norm=resid, scale_norm=torch.as_tensor(scale),
                       col_backward=None if col is None else torch.as_tensor(col))


def test_check_frames_passes_a_healthy_krylov_cpd_frame():
    """A Krylov-CPD frame whose residual is 5e-3 of its rhs (above the
    dense route's 1e-3) but whose backward error is healthy passes; the
    same residuals on the dense route raise exactly as JAX's check_frames
    does."""
    rest, frames = _shot()
    rhs = np.linalg.norm(frames.astype(np.float64) - rest[None], axis=(1, 2))
    resid = 5e-3 * rhs
    report = _report(resid, 100.0 * rhs, col=np.full((4, 3), 5e-5))
    errors.check_frames(resid, rest, frames, cfg=TPS_KRYLOV, report=report)
    for cfg in (None, TPS_DIRECT):
        with pytest.raises(jerrors.SolveFailedError) as want:
            jerrors.check_frames(resid, rest, frames)
        with pytest.raises(errors.SolveFailedError) as got:
            errors.check_frames(resid, rest, frames, cfg=cfg, report=report)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bad", ["nan", "backward", "column"])
def test_check_frames_krylov_cpd_still_raises(bad):
    rest, frames = _shot()
    rhs = np.linalg.norm(frames.astype(np.float64) - rest[None], axis=(1, 2))
    resid, scale, col = 1e-6 * rhs, 100.0 * rhs, np.full((4, 3), 1e-8)
    if bad == "nan":
        resid[2] = np.nan
    elif bad == "backward":
        resid[2] = 0.5 * scale[2]            # backward error 0.5
    else:
        col[2, 1] = 2e-3
    with pytest.raises(errors.SolveFailedError, match="frame"):
        errors.check_frames(resid, rest, frames, cfg=TPS_KRYLOV, report=_report(resid, scale, col))
    with pytest.raises(ValueError, match="report"):
        errors.check_frames(resid, rest, frames, cfg=TPS_KRYLOV)


def test_check_frames_krylov_cpd_degenerate_pose_raises():
    """A lost marker (NaN) in one pose of a Krylov TPS shot: that frame's
    fit reports a non-finite residual and check_frames names it.  (The
    ridge keeps the TPS saddle system quasi-definite, so even coincident
    markers solve.)"""
    rest, frames = _shot(n=60, f=3)
    frames[1, 7] = np.nan
    _, resid, report = tfit.fit_frames_per_pose(
        torch.as_tensor(rest), torch.as_tensor(frames), TPS_KRYLOV, want_report=True)
    assert bool(torch.isfinite(resid[[0, 2]]).all()) and not bool(torch.isfinite(resid[1]))
    with pytest.raises(errors.SolveFailedError, match=r"frame\(s\) 1:"):
        errors.check_frames(resid, rest, frames, cfg=TPS_KRYLOV, report=report)


@pytest.mark.parametrize("route", ["per_pose", "shared"])
def test_fit_frames_report_per_frame(monkeypatch, route):
    """want_report gives each frame's worst-layer report on both dense
    routes: its residuals are the returned ones for the per-pose route,
    and frame by frame the shared route's per-frame view."""
    from facedeform_tpu_torch.parallel import batched

    if route == "shared":
        monkeypatch.setattr(batched, "vmap_fit_hbm_budget", 0.0)
    rest, frames = _shot(n=60, f=3)
    cfg = convert.config_from_fields(dataclasses.asdict(
        jcfg.DeformConfig(model=M.MULTILAYER, layers=2)))
    model, resid, report = batched.fit_frames(rest, frames, cfg, device="cpu", want_report=True)
    _, resid2 = batched.fit_frames(rest, frames, cfg, device="cpu")
    assert torch.equal(resid, resid2)
    assert tuple(report.col_backward.shape) == (3, 3)
    be = report.backward_error()
    assert be.shape == (3,) and bool((be <= errors.SOLVE_BACKWARD_RTOL).all())
    if route == "per_pose":
        assert torch.equal(report.residual_norm, resid)
    errors.check_frames(resid, rest, frames, cfg=cfg, report=report)
