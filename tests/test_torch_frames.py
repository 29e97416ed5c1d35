"""PyTorch port: the animated shot (parallel/batched, ops/fit frame routes,
the frames eval kernel's plain twin, check_frames) against the JAX
package, with Pallas in interpret mode, and the slice end to end against
the float64 oracle (tests/oracle.py)."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
from facedeform_tpu.geometry.primitives import fibonacci_points
from facedeform_tpu.ops import evaluate as jeval
from facedeform_tpu.ops import fit as jfit
from facedeform_tpu.ops import pallas_eval
from facedeform_tpu.ops import temporal as jtemporal
from facedeform_tpu.parallel import batched as jbatched
from facedeform_tpu.utils import errors as jerrors
from facedeform_tpu_torch import convert
from facedeform_tpu_torch.ops import cuda_eval, temporal
from facedeform_tpu_torch.ops import evaluate as teval
from facedeform_tpu_torch.ops import fit as tfit
from facedeform_tpu_torch.parallel import batched as tbatched
from facedeform_tpu_torch.utils import errors
from facedeform_tpu_torch.utils import profiling

import oracle

K = jcfg.RBFKernel
M = jcfg.RBFModelType
TERM = jcfg.PolyTerm.LINEAR
GROWING = (K.THIN_PLATE, K.MULTIQUADRIC, K.LINEAR, K.CUBIC)
PARAMS = jcfg.DeformParams(radius=0.5, lam=0.01, falloffrate=1.5)
FIELD_TOL = 1e-5   # fits compared through their fields (tests/test_torch_fit.py)
APPLY_TOL = 5e-6   # apply_frames / deform_frames vs JAX on CPU
BUDGET = 5e-5      # max displacement error vs the float64 oracle (BASELINE.md)

# solve configs of the frame fits; radius 0.5 keeps the ridge families
# well conditioned
FIT_CASES = [
    ("qnn", dict()),
    ("multilayer3", dict(model=M.MULTILAYER, layers=3)),
    ("wendland", dict(model=M.KERNEL, kernel=K.WENDLAND_C2, term=jcfg.PolyTerm.CONSTANT)),
]


def _port_cfg(jc):
    return convert.config_from_fields(dataclasses.asdict(jc))


def _port_params(params=PARAMS):
    return convert.params_from_fields(params._asdict())


def _to_port(model):
    return convert.model_from_numpy(
        {f: np.asarray(getattr(model, f)) for f in model._fields
         if getattr(model, f) is not None}, device="cpu")


def _shot(n=80, n_frames=5, seed=0):
    rng = np.random.default_rng(seed)
    rest = fibonacci_points(n)
    frames = np.stack([rest + 0.05 * rng.standard_normal((n, 3)).astype(np.float32)
                       for _ in range(n_frames)])
    return rest, frames


def _mesh(v=400, seed=1):
    """Points near the unit sphere, capture d2 (some beyond the radius, a
    few strict-parity sentinels), a group gate and a tangent frame."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((v, 3)).astype(np.float32)
    pts *= (1.0 + 0.1 * rng.standard_normal((v, 1))) / np.linalg.norm(pts, axis=1, keepdims=True)
    dist2 = np.abs(0.4 * rng.standard_normal(v)).astype(np.float32)
    gate = (rng.uniform(size=v) > 0.2).astype(np.float32)
    frame = tuple(rng.standard_normal((v, 3)).astype(np.float32) for _ in range(3))
    return pts, dist2, gate, frame


def _fields(model, probes, kernel, term):
    """(F, V, 3) displacement of every frame of a frames-stacked port model."""
    return np.stack([
        teval.evaluate(cuda_eval.frame_model(model, f), torch.as_tensor(probes), kernel,
                       term).numpy()
        for f in range(model.w_rbf.shape[0])
    ])


def _jax_fields(model, probes, kernel, term):
    return np.stack([
        np.asarray(jeval.evaluate(
            jfit.RBFModel(ctrl=model.ctrl, w_rbf=model.w_rbf[f], w_poly=model.w_poly[f],
                          eps=model.eps), jnp.asarray(probes), kernel, term))
        for f in range(model.w_rbf.shape[0])
    ])


@functools.lru_cache(maxsize=None)
def _jax_fit_frames(name):
    jc = jcfg.DeformConfig(**dict(FIT_CASES)[name])
    rest, frames = _shot()
    return jc, jbatched.fit_frames(jnp.asarray(rest), jnp.asarray(frames), jc, PARAMS)


@pytest.mark.parametrize("name", [c[0] for c in FIT_CASES])
def test_fit_frames_per_pose_route_matches_jax(name):
    jc, (jm, jr) = _jax_fit_frames(name)
    rest, frames = _shot()
    tm, tr = tbatched.fit_frames(rest, frames, _port_cfg(jc), _port_params(), device="cpu")
    f, n = frames.shape[:2]
    n_layers, m = jc.n_layers, jc.n_poly
    # the round-5 fix: the per-pose route keeps the lo words, stacked
    assert tuple(tm.w_rbf_lo.shape) == (f, n_layers, n, 3)
    assert tuple(tm.w_poly_lo.shape) == (f, m, 3)
    for field in ("ctrl", "w_rbf", "w_poly", "eps", "w_rbf_lo", "w_poly_lo"):
        assert tuple(getattr(tm, field).shape) == tuple(np.shape(getattr(jm, field)))
    kernel = jfit.effective_kernel(jc)
    probes = _mesh()[0]
    np.testing.assert_allclose(_fields(tm, probes, kernel, jc.term),
                               _jax_fields(jm, probes, kernel, jc.term), atol=FIELD_TOL)
    assert tr.shape == (f,) and bool(torch.isfinite(tr).all())
    errors.check_frames(tr, rest, frames)
    jerrors.check_frames(jr, rest, frames)


@pytest.mark.parametrize("name", [c[0] for c in FIT_CASES])
def test_fit_frames_shared_route_matches_jax(name, monkeypatch):
    jc = jcfg.DeformConfig(**dict(FIT_CASES)[name])
    rest, frames = _shot()
    jm, jr, _ = jfit.fit_frames_dense(jnp.asarray(rest), jnp.asarray(frames), jc, PARAMS)
    tc = _port_cfg(jc)
    tm, tr, report = tfit.fit_frames_dense(torch.as_tensor(rest), torch.as_tensor(frames),
                                           tc, _port_params())
    # fit_frames routes here once the per-pose temporaries pass the budget
    monkeypatch.setattr(tbatched, "vmap_fit_hbm_budget", 0.0)
    routed, routed_r = tbatched.fit_frames(rest, frames, tc, _port_params(), device="cpu")
    assert routed.w_rbf_lo is None and routed.w_poly_lo is None   # lo words dropped
    assert torch.equal(routed.w_rbf, tm.w_rbf) and torch.equal(routed_r, tr)
    kernel = jfit.effective_kernel(jc)
    probes = _mesh()[0]
    np.testing.assert_allclose(_fields(tm, probes, kernel, jc.term),
                               _jax_fields(jm, probes, kernel, jc.term), atol=FIELD_TOL)
    assert tr.shape == (frames.shape[0],) and np.shape(jr) == tr.shape
    assert float(report.backward_error()) <= errors.SOLVE_BACKWARD_RTOL
    errors.check_frames(tr, rest, frames)


def test_per_pose_and_shared_routes_agree():
    """Both routes solve the same systems: fields agree to f32 rounding."""
    rest, frames = _shot()
    tc = _port_cfg(jcfg.DeformConfig())
    r, fr = torch.as_tensor(rest), torch.as_tensor(frames)
    per_pose, _ = tfit.fit_frames_per_pose(r, fr, tc, _port_params())
    shared, _, _ = tfit.fit_frames_dense(r, fr, tc, _port_params())
    probes = _mesh()[0]
    np.testing.assert_allclose(_fields(per_pose, probes, K.GAUSSIAN, TERM),
                               _fields(shared, probes, K.GAUSSIAN, TERM), atol=FIELD_TOL)
    # each pose of the per-pose route is fit() of that pose
    single, _ = tfit.fit(r, fr[2], tc, _port_params())
    np.testing.assert_allclose(per_pose.w_rbf[2].numpy(), single.w_rbf.numpy(),
                               rtol=0, atol=1e-6)


def test_vmap_fit_bytes_and_routing(monkeypatch):
    """The budget formula: F LU factors of the (R, R) system in f32 plus
    the shared system in f32 and float64."""
    assert tbatched._vmap_fit_bytes(1004, 8) == 4 * 8 * 1004 ** 2 + 12 * 1004 ** 2
    assert tbatched._vmap_fit_bytes(1004, 8) < tbatched.vmap_fit_hbm_budget
    # the rule's shape is the JAX package's: shared above the budget
    rest, frames = _shot(n=30, n_frames=3)
    cfg = _port_cfg(jcfg.DeformConfig())
    rows = 30 + cfg.n_poly
    monkeypatch.setattr(tbatched, "vmap_fit_hbm_budget", tbatched._vmap_fit_bytes(rows, 3))
    at, _ = tbatched.fit_frames(rest, frames, cfg, device="cpu")
    assert at.w_rbf_lo is not None                       # per-pose at the budget
    monkeypatch.setattr(tbatched, "vmap_fit_hbm_budget", tbatched._vmap_fit_bytes(rows, 3) - 1)
    above, _ = tbatched.fit_frames(rest, frames, cfg, device="cpu")
    assert above.w_rbf_lo is None                        # shared above it


def test_check_frames_raises_like_jax():
    rest, frames = _shot(n=40, n_frames=4)
    rhs = np.linalg.norm(frames.astype(np.float64) - rest[None], axis=(1, 2))
    healthy = 1e-9 * rhs
    errors.check_frames(healthy, rest, frames)
    jerrors.check_frames(healthy, rest, frames)
    for bad in ([0, np.nan, 0, 0], [0, 0, 2e-3, 0]):
        resid = healthy + np.asarray(bad) * rhs
        with pytest.raises(jerrors.SolveFailedError) as want:
            jerrors.check_frames(resid, rest, frames)
        with pytest.raises(errors.SolveFailedError) as got:
            errors.check_frames(torch.as_tensor(resid), rest, frames)
        assert str(got.value) == str(want.value)
    # a degenerate rig (every marker coincident) fails its solve
    rig = np.zeros((20, 3), np.float32)
    shot = np.stack([rig + 0.1, rig + 0.2])
    _, resid = tbatched.fit_frames(rig, shot, _port_cfg(jcfg.DeformConfig()), device="cpu")
    with pytest.raises(errors.SolveFailedError, match="frame"):
        errors.check_frames(resid, rig, shot)


def _synthetic(n, n_layers, n_frames, kernel, seed):
    """A frames-stacked model in numpy: Fibonacci controls, seeded radii,
    weights (layer 0 sums to zero per frame, the tail constraint), tails."""
    rng = np.random.default_rng(seed)
    lo, hi = (1.0, 2.0) if kernel in GROWING else (0.3, 0.6)
    w = rng.standard_normal((n_frames, n_layers, n, 3)) * (0.05 / np.sqrt(n))
    w[:, 0] -= w[:, 0].mean(axis=1, keepdims=True)
    return dict(
        ctrl=fibonacci_points(n), w_rbf=w.astype(np.float32),
        w_poly=(rng.standard_normal((n_frames, 4, 3)) * 0.01).astype(np.float32),
        eps=rng.uniform(lo, hi, (n_layers, n)).astype(np.float32),
    )


def _pos_atol(kernel, arrays):
    if kernel in (K.GAUSSIAN, K.WENDLAND_C2):
        return 5e-6
    # PR 1's bound for globally supported bases: f32 contraction error
    # scales with sum |w| |phi| (tests/test_pallas.py)
    return 2e-5 + 3e-7 * float(np.abs(arrays["w_rbf"]).sum())


FRAMES_GRID = (
    [(k, 1, 3, fr) for k in K for fr in (False, True)]
    + [(k, 3, f, fr) for k in (K.GAUSSIAN, K.WENDLAND_C2) for f in (1, 5)
       for fr in (False, True)]
)


@pytest.mark.parametrize(
    "kernel,n_layers,n_frames,with_frame", FRAMES_GRID,
    ids=[f"{k.name}-L{n_layers}-F{f}-{'frame' if fr else 'noframe'}"
         for k, n_layers, f, fr in FRAMES_GRID])
def test_frames_reference_matches_pallas(kernel, n_layers, n_frames, with_frame):
    """The frames kernel's plain twin against evaluate_pallas_frames, in
    apply_frames' call (dist2 = 0, radius = rate = 1, gate = the folded
    weight), where the falloff must equal that weight exactly."""
    arrays = _synthetic(120, n_layers, n_frames, kernel, seed=int(kernel) + 10 * n_frames)
    pts, dist2, gate, frame = _mesh(v=300)
    fold = (np.clip(1.0 - dist2, 0.0, None) * gate).astype(np.float32)
    want, want_w = pallas_eval.evaluate_pallas_frames(
        jfit.RBFModel(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        jnp.asarray(pts), jnp.zeros(300, jnp.float32), jnp.asarray(fold),
        jnp.float32(1.0), jnp.float32(1.0), kernel, TERM, tile_v=128, interpret=True,
        frame=tuple(map(jnp.asarray, frame)) if with_frame else None)
    got, got_w = cuda_eval.evaluate_frames_reference(
        convert.model_from_numpy(arrays, device="cpu"), torch.as_tensor(pts), torch.zeros(300),
        torch.as_tensor(fold), 1.0, 1.0, kernel, TERM,
        frame=tuple(map(torch.as_tensor, frame)) if with_frame else None)
    assert tuple(got.shape) == (n_frames, 300, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=_pos_atol(kernel, arrays))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_w.numpy(), fold)


@pytest.mark.parametrize("strict", [False, True], ids=["clamped", "strict"])
def test_frames_reference_general_falloff_matches_pallas(strict):
    """Capture distances, radius, rate and strict_parity in the frames
    kernel's own falloff, as evaluate_pallas_frames takes them."""
    arrays = _synthetic(100, 1, 3, K.GAUSSIAN, seed=5)
    pts, dist2, gate, frame = _mesh(v=300)
    dist2[::41] = -1.0
    want, want_w = pallas_eval.evaluate_pallas_frames(
        jfit.RBFModel(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        jnp.asarray(pts), jnp.asarray(dist2), jnp.asarray(gate), jnp.float32(0.8),
        jnp.float32(1.5), K.GAUSSIAN, TERM, strict_parity=strict, tile_v=128,
        interpret=True)
    got, got_w = cuda_eval.evaluate_frames_reference(
        convert.model_from_numpy(arrays, device="cpu"), torch.as_tensor(pts), torch.as_tensor(dist2),
        torch.as_tensor(gate), 0.8, 1.5, K.GAUSSIAN, TERM, strict_parity=strict)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-6)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-6)


@pytest.mark.parametrize("with_frame", [False, True], ids=["noframe", "frame"])
def test_frames_reference_matches_per_frame_eval(with_frame):
    """Frames eval == the single-pose eval run frame by frame
    (tests/test_pallas.py's 1e-6)."""
    arrays = _synthetic(100, 3, 4, K.GAUSSIAN, seed=7)
    model = convert.model_from_numpy(arrays, device="cpu")
    pts, dist2, gate, frame = (torch.as_tensor(a) if not isinstance(a, tuple)
                               else tuple(map(torch.as_tensor, a)) for a in _mesh(v=300))
    frame = frame if with_frame else None
    got, got_w = cuda_eval.evaluate_frames_reference(
        model, pts, dist2, gate, 0.9, 1.5, K.GAUSSIAN, TERM, frame=frame)
    for f in range(4):
        want, want_w = cuda_eval.evaluate_reference(
            cuda_eval.frame_model(model, f), pts, dist2, gate, 0.9, 1.5, K.GAUSSIAN, TERM,
            frame=frame)
        np.testing.assert_allclose(got[f].numpy(), want.numpy(), atol=1e-6)
        np.testing.assert_array_equal(got_w.numpy(), want_w.numpy())


def test_frames_wrapper_on_cpu_runs_the_plain_version():
    arrays = _synthetic(60, 1, 3, K.GAUSSIAN, seed=3)
    model = convert.model_from_numpy(arrays, device="cpu")
    pts, dist2, gate, _ = (torch.as_tensor(a) if not isinstance(a, tuple) else a
                           for a in _mesh(v=200))
    args = (model, pts, dist2, gate, 1.0, 1.5, K.GAUSSIAN, TERM)
    got = cuda_eval.evaluate_cuda_frames(*args)
    want = cuda_eval.evaluate_frames_reference(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert profiling.counter("launches.evaluate_cuda_frames") == 0 and cuda_eval._lib is None
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_eval.evaluate_cuda_frames(model, pts.to("meta"), *args[2:])


APPLY_CASES = [
    ("default", dict()),
    ("tangent", dict(tangent=True)),
    ("tangent-strict", dict(tangent=True, strict_parity=True)),
    ("multilayer", dict(model=M.MULTILAYER, layers=3)),
]


@pytest.mark.parametrize("name,cfg_kw", APPLY_CASES, ids=[c[0] for c in APPLY_CASES])
def test_apply_frames_matches_jax(name, cfg_kw):
    jc = jcfg.DeformConfig(**cfg_kw)
    rest, frames = _shot()
    jm, _ = jbatched.fit_frames(jnp.asarray(rest), jnp.asarray(frames), jc, PARAMS)
    pts, dist2, gate, frame = _mesh()
    dist2[::53] = -1.0
    want, want_w = jbatched.apply_frames(
        jm, jnp.asarray(pts), jnp.asarray(dist2), jnp.asarray(gate), jc, PARAMS,
        frame=tuple(map(jnp.asarray, frame)))
    tm = _to_port(jm)
    got, got_w = tbatched.apply_frames(tm, pts, dist2, gate, _port_cfg(jc), _port_params(),
                                       frame=frame)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=APPLY_TOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-6)
    # with tangent off, a frame passed in is dropped (round-5 gating)
    no_frame, _ = tbatched.apply_frames(tm, pts, dist2, gate, _port_cfg(jc), _port_params())
    if jc.tangent:
        assert not torch.equal(no_frame, got)
    else:
        assert torch.equal(no_frame, got)


def test_deform_frames_matches_jax():
    jc = jcfg.DeformConfig(tangent=True)
    rest, frames = _shot()
    pts, dist2, gate, frame = _mesh()
    want, want_w = jbatched.deform_frames(
        jnp.asarray(rest), jnp.asarray(frames), jnp.asarray(pts), jnp.asarray(dist2),
        jnp.asarray(gate), jc, PARAMS, frame=tuple(map(jnp.asarray, frame)))
    got, got_w = tbatched.deform_frames(rest, frames, pts, dist2, gate, _port_cfg(jc),
                                        _port_params(), frame=frame, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=APPLY_TOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-6)


def test_growing_kernels_and_mesh_not_ported():
    """Growing-kernel shots and Krylov-size shots (both once not ported,
    hence the name) fit: growing kernels apply through the float64 path,
    a Krylov shot is one Krylov fit per pose; mesh= still raises."""
    rest, frames = _shot(n=30, n_frames=2)
    pts, dist2, gate, _ = _mesh(v=50)
    mq = jcfg.DeformConfig(model=M.KERNEL, kernel=K.MULTIQUADRIC)
    jm, _ = jbatched.fit_frames(jnp.asarray(rest), jnp.asarray(frames), mq, PARAMS)
    want, want_w = jbatched.apply_frames(jm, jnp.asarray(pts), jnp.asarray(dist2),
                                         jnp.asarray(gate), mq, PARAMS)
    got, got_w = tbatched.apply_frames(_to_port(jm), pts, dist2, gate, _port_cfg(mq),
                                       _port_params())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-6)
    own, resid = tbatched.fit_frames(rest, frames, _port_cfg(mq), _port_params(), device="cpu")
    errors.check_frames(resid, rest, frames)
    assert tuple(own.w_rbf_lo.shape) == (2, 1, 30, 3)
    mine, _ = tbatched.apply_frames(own, pts, dist2, gate, _port_cfg(mq), _port_params())
    assert np.abs(mine.numpy() - np.asarray(want)).max() <= BUDGET
    cfg = _port_cfg(jcfg.DeformConfig())
    model, _ = tbatched.fit_frames(rest, frames, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="slice H"):
        tbatched.apply_frames(model, pts, dist2, gate, cfg, _port_params(), mesh=object())
    with pytest.raises(NotImplementedError, match="slice H"):
        tbatched.transport_frames(model, pts, (pts,), gate, cfg, ("vector",), mesh=object())
    krylov = dataclasses.replace(cfg, solver="krylov")
    km, kresid = tbatched.fit_frames(rest, frames, krylov, device="cpu")
    assert km.w_rbf_lo is None
    for f in range(frames.shape[0]):
        single, rep = tfit.fit(torch.as_tensor(rest), torch.as_tensor(frames[f]), krylov)
        assert torch.equal(km.w_rbf[f], single.w_rbf) and torch.equal(kresid[f], rep.residual_norm)


@pytest.mark.parametrize("route", ["per-pose", "shared"])
def test_convert_carries_frames_models(route):
    """model_from_numpy carries an F-stacked JAX model as it is, with the
    lo words (per-pose route) or without them (shared route)."""
    jc = jcfg.DeformConfig(model=M.MULTILAYER, layers=2)
    rest, frames = _shot()
    if route == "per-pose":
        jm, _ = jbatched.fit_frames(jnp.asarray(rest), jnp.asarray(frames), jc, PARAMS)
    else:
        jm, _, _ = jfit.fit_frames_dense(jnp.asarray(rest), jnp.asarray(frames), jc, PARAMS)
    tm = _to_port(jm)
    for field in jm._fields:
        value = getattr(jm, field)
        if value is None:
            assert getattr(tm, field) is None
        else:
            np.testing.assert_array_equal(getattr(tm, field).numpy(), np.asarray(value))
            assert getattr(tm, field).is_contiguous()
    assert (tm.w_rbf_lo is not None) == (route == "per-pose")
    assert tuple(tm.w_rbf.shape) == (5, 2, 80, 3) and tuple(tm.w_poly.shape) == (5, 4, 3)


def test_slice_end_to_end_matches_jax_and_oracle():
    """smooth_frames -> fit_frames -> apply_frames -> transport_frames, the
    port against the same chain in JAX (1e-5) and a frame against the
    float64 oracle (5e-5)."""
    from facedeform_tpu.ops.jacobian import _applied_gradient, displacement_jacobian
    from facedeform_tpu.ops.jacobian import principal_stretches as jstretches
    from facedeform_tpu.ops.jacobian import transform_normals as jnormals

    jc = jcfg.DeformConfig(tangent=True)
    rest, raw = _shot(n_frames=6, seed=4)
    smoothed = temporal.smooth_frames(raw, window=5)
    np.testing.assert_array_equal(smoothed, jtemporal.smooth_frames(raw, window=5))
    pts, dist2, gate, frame = _mesh(v=500)
    jframe = tuple(map(jnp.asarray, frame))

    jm, _ = jbatched.fit_frames(jnp.asarray(rest), jnp.asarray(smoothed), jc, PARAMS)
    jout, jw = jbatched.apply_frames(jm, jnp.asarray(pts), jnp.asarray(dist2),
                                     jnp.asarray(gate), jc, PARAMS, frame=jframe)
    jn, js = jbatched.transport_frames(jm, jnp.asarray(pts), (frame[2],), jw, jc,
                                       ("normal",), frame=jframe, want_stretch=True)

    tc = _port_cfg(jc)
    tm, resid = tbatched.fit_frames(rest, smoothed, tc, _port_params(), device="cpu")
    errors.check_frames(resid, rest, smoothed)
    tout, tw = tbatched.apply_frames(tm, pts, dist2, gate, tc, _port_params(), frame=frame)
    tn, ts = tbatched.transport_frames(tm, pts, (frame[2],), tw, tc, ("normal",),
                                       frame=frame, want_stretch=True)

    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    # the JAX chain's frame 2 by hand agrees with its batched transport
    jac = displacement_jacobian(
        jfit.RBFModel(ctrl=jm.ctrl, w_rbf=jm.w_rbf[2], w_poly=jm.w_poly[2], eps=jm.eps),
        jnp.asarray(pts), K.GAUSSIAN, TERM)
    f2 = _applied_gradient(jac, jw, jc, jframe)
    np.testing.assert_allclose(tn[2].numpy(), np.asarray(jnormals(jnp.asarray(frame[2]), f2)),
                               atol=1e-5)
    np.testing.assert_allclose(ts[2].numpy(), np.asarray(jstretches(f2)), atol=1e-5)
    for f in (0, 5):
        want, want_w = oracle.deform(rest, smoothed[f], pts, jc, PARAMS, dist2=dist2,
                                     frame=frame, group_mask=gate > 0)
        assert np.abs(tout[f].numpy() - want).max() <= BUDGET
        np.testing.assert_allclose(tw.numpy(), want_w, atol=1e-6)
