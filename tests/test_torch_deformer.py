"""PyTorch port: Deformer.fit + apply against the JAX Deformer and the
float64 oracle (tests/oracle.py)."""

import dataclasses

import numpy as np
import pytest

import facedeform_tpu.config as jcfg
import facedeform_tpu.deformer as jdef
from facedeform_tpu.geometry.primitives import fibonacci_points
from facedeform_tpu_torch import DeformConfig, convert
from facedeform_tpu_torch.deformer import Deformer
from facedeform_tpu_torch.ops import cuda_eval
from facedeform_tpu_torch.utils import errors
from facedeform_tpu_torch.utils import profiling

import oracle

K = jcfg.RBFKernel
M = jcfg.RBFModelType
BUDGET = 5e-5  # max displacement error vs the float64 oracle (BASELINE.md)


def _scene(n=200, v=2000, seed=0):
    rng = np.random.default_rng(seed)
    rest = fibonacci_points(n)
    deformed = rest + 0.05 * rng.standard_normal((n, 3)).astype(np.float32)
    pts = rng.standard_normal((v, 3)).astype(np.float32)
    pts *= (1.0 + 0.1 * rng.standard_normal((v, 1))) / np.linalg.norm(pts, axis=1, keepdims=True)
    dist2 = np.abs(0.6 * rng.standard_normal(v)).astype(np.float32)
    dist2[::97] = -1.0
    mask = rng.uniform(size=v) > 0.2
    frame = tuple(rng.standard_normal((v, 3)).astype(np.float32) for _ in range(3))
    return rest, deformed, pts, dist2, mask, frame


def _port(jc, params):
    return (convert.config_from_fields(dataclasses.asdict(jc)),
            convert.params_from_fields(params._asdict()))


SCENES = [
    ("default", dict(), {}),
    ("capture-group", dict(), dict(dist2=True, mask=True)),
    ("tangent-strict", dict(tangent=True, strict_parity=True),
     dict(dist2=True, frame=True)),
    ("multilayer", dict(model=M.MULTILAYER, layers=3), dict(dist2=True)),
    ("wendland", dict(model=M.KERNEL, kernel=K.WENDLAND_C2), dict(mask=True)),
]


@pytest.mark.parametrize("name,cfg_kw,inputs", SCENES, ids=[s[0] for s in SCENES])
def test_fit_apply_matches_jax_and_oracle(name, cfg_kw, inputs):
    rest, deformed, pts, dist2, mask, frame = _scene()
    jc = jcfg.DeformConfig(**cfg_kw)
    params = jcfg.DeformParams(radius=0.3, lam=0.01, falloffrate=1.5)
    kw = dict(
        dist2=dist2 if inputs.get("dist2") else None,
        group_mask=mask if inputs.get("mask") else None,
        frame=frame if inputs.get("frame") else None,
    )
    jd = jdef.Deformer.fit(rest, deformed, jc, params)
    jp, jw = (np.asarray(a) for a in jd.apply(pts, backend="dense", **kw))
    tc, tp = _port(jc, params)
    td = Deformer.fit(rest, deformed, tc, tp, device="cpu")
    tpts, tw = td.apply(pts, **kw)                     # "auto" = dense on CPU
    tpts, tw = tpts.numpy(), tw.numpy()
    np.testing.assert_allclose(tpts, jp, atol=1e-5)
    np.testing.assert_allclose(tw, jw, atol=1e-6)
    want, want_w = oracle.deform(
        rest, deformed, pts, jc, params, dist2=kw["dist2"], frame=kw["frame"],
        group_mask=kw["group_mask"])
    assert np.abs(tpts - want).max() <= BUDGET
    assert np.abs(jp - want).max() <= BUDGET
    np.testing.assert_allclose(tw, want_w, atol=1e-6)
    if kw["group_mask"] is not None:
        np.testing.assert_array_equal(tpts[~mask], pts[~mask])
    # the kernel backends take their plain version on CPU tensors
    backends = ["cuda", "cuda_culled"] if tc.model != M.KERNEL or tc.kernel in (
        K.GAUSSIAN, K.WENDLAND_C2) else ["cuda"]
    for backend in backends:
        got, got_w = td.apply(pts, backend=backend, **kw)
        np.testing.assert_allclose(got.numpy(), tpts, atol=1e-6)
        np.testing.assert_array_equal(got_w.numpy(), tw)
    assert (profiling.counter("launches.evaluate_cuda")
            == profiling.counter("launches.evaluate_cuda_culled") == 0)


def test_displacement_matches_jax():
    rest, deformed, pts, *_ = _scene(n=120, v=500)
    jc, params = jcfg.DeformConfig(), jcfg.DeformParams()
    jd = jdef.Deformer.fit(rest, deformed, jc, params)
    td = Deformer.fit(rest, deformed, *_port(jc, params), device="cpu")
    np.testing.assert_allclose(
        td.displacement(pts).numpy(), np.asarray(jd.displacement(pts)), atol=1e-5)


def test_shape_mismatch_and_unknown_backend():
    rest, deformed, pts, *_ = _scene(n=50, v=100)
    with pytest.raises(errors.ShapeMismatchError):
        Deformer.fit(rest, deformed[:-1], device="cpu")
    d = Deformer.fit(rest, deformed, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        d.apply(pts, backend="pallas")
    with pytest.raises(ValueError, match="pu"):
        Deformer.fit(rest, deformed, DeformConfig(solver="pu"), device="cpu")


def test_degenerate_rig_fails_solve():
    rig = np.zeros((20, 3), np.float32)
    with pytest.raises(errors.SolveFailedError):
        Deformer.fit(rig, rig + 0.1, device="cpu")


def test_growing_kernels_and_krylov_not_ported():
    """Growing kernels and the Krylov route (both once not ported, hence
    the name) fit: growing kernels apply through the float64 path, the
    Krylov route gives a model without lo words."""
    rest, deformed, pts, dist2, mask, _ = _scene(n=40, v=50)
    mq = jcfg.DeformConfig(model=M.KERNEL, kernel=K.MULTIQUADRIC)
    own = Deformer.fit(rest, deformed, *_port(mq, jcfg.DeformParams()), device="cpu")
    assert own.model.w_rbf_lo is not None
    kd = Deformer.fit(rest, deformed, DeformConfig(solver="krylov"), device="cpu")
    assert kd.model.w_rbf_lo is None and kd.model.w_poly_lo is None
    assert float(kd.report.backward_error()) <= errors.SOLVE_BACKWARD_RTOL
    # a JAX-fitted growing-kernel model carries over and evaluates as
    # JAX's auto route (dense_precise) does
    jd = jdef.Deformer.fit(rest, deformed, mq, jcfg.DeformParams())
    model = convert.model_from_numpy(
        {f: np.asarray(getattr(jd.model, f)) for f in jd.model._fields}, device="cpu")
    assert model.w_rbf_lo is not None
    td = Deformer(model=model, cfg=_port(mq, jcfg.DeformParams())[0],
                  params=_port(mq, jcfg.DeformParams())[1], report=None)
    got, got_w = td.apply(pts, dist2=dist2, group_mask=mask)
    want, want_w = jd.apply(pts, dist2=dist2, group_mask=mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got.numpy()[~mask], pts[~mask])
    np.testing.assert_allclose(td.displacement(pts).numpy(), np.asarray(jd.displacement(pts)),
                               atol=1e-6)
    # forcing a backend evaluates the f32 field, as in the JAX package
    got = td.apply(pts, backend="dense")[0].numpy()
    want = np.asarray(jd.apply(pts, backend="dense")[0])
    np.testing.assert_allclose(got, want, atol=1e-4)
    got = td.apply(pts, backend="cuda")[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
