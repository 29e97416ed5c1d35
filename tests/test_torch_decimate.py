"""PyTorch port: rig decimation (greedy pivoted-Cholesky selection,
reduce_rig, the reduced-basis regressions) and Deformer.reduced against
the JAX package (CPU tensors)."""

import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
from facedeform_tpu.geometry.primitives import fibonacci_points
from facedeform_tpu.ops import decimate as jdec
from facedeform_tpu_torch import Deformer, DeformConfig, DeformParams, convert
from facedeform_tpu_torch.config import RBFKernel, RBFModelType
from facedeform_tpu_torch.ops import decimate
from facedeform_tpu_torch.ops.evaluate import evaluate
from facedeform_tpu_torch.parallel import batched
from facedeform_tpu_torch.utils import errors

# The reduced regression's weights are ill-conditioned (the design's
# condition squared in the normal equations), so the models are held by
# their field, what a user sees: evaluated in float64 at the dropped
# markers and on a dense point set, the port's field is within FIELD_RTOL
# of the motion scale of the exact (float64) regression's, built here
# independently of both packages' helpers.  The JAX package assembles the
# normal equations in float32 and its field sits 2e-5 (QNN) to 3e-3 (TPS)
# of scale from the exact one on these rigs, so the port is held to JAX
# within JAX's own distance from the exact field, plus FIELD_RTOL.
FIELD_RTOL = 1e-5
@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One torch intra-op thread, as the other JAX-parity tests run (see
    tests/test_torch_eval.py); never raised again."""
    torch.set_num_threads(1)


def _cfgs(**kw):
    j = jcfg.DeformConfig(**kw)
    return j, DeformConfig(**kw)


@pytest.mark.parametrize("n,k", [(300, 40), (600, 60), (1000, 150)])
def test_select_markers_same_picks_as_jax(n, k):
    """Fibonacci rigs have no near-ties in the pivot scores: the same picks
    in the same order, and the same residual report."""
    rest = fibonacci_points(n)
    j_idx, j_rep = jdec.select_markers(rest, k)
    t_idx, t_rep = decimate.select_markers(rest, k, device="cpu")
    np.testing.assert_array_equal(t_idx, np.asarray(j_idx))
    assert t_idx.dtype == np.int32 and len(set(t_idx.tolist())) == k
    assert t_rep.eps == pytest.approx(j_rep.eps, rel=1e-12)
    assert t_rep.residual_trace == pytest.approx(j_rep.residual_trace, rel=1e-4, abs=1e-6)
    assert t_rep.residual_max == pytest.approx(j_rep.residual_max, rel=1e-4, abs=1e-6)


def test_residual_trace_falls_monotonically_and_vanishes():
    rest = fibonacci_points(200)
    traces = [decimate.select_markers(rest, k, device="cpu")[1].residual_trace
              for k in (10, 40, 100, 200)]
    assert all(a >= b for a, b in zip(traces, traces[1:]))
    assert traces[-1] < 1e-3
    with pytest.raises(ValueError):
        decimate.select_markers(rest, 0, device="cpu")
    with pytest.raises(ValueError):
        decimate.select_markers(rest[:, :2], 3, device="cpu")


@pytest.mark.parametrize("model", ["qnn", "kernel"])
def test_reduce_rig_matches_jax(model):
    rng = np.random.default_rng(1)
    rest = fibonacci_points(400)
    deformed = rest + 0.1 * np.sin(3 * rest[:, [1, 2, 0]]).astype(np.float32)
    kw = {} if model == "qnn" else dict(model=RBFModelType.KERNEL, kernel=RBFKernel.GAUSSIAN)
    jc, tc = _cfgs(**kw)
    jp, tp = jcfg.DeformParams(radius=0.6, lam=0.01), DeformParams(radius=0.6, lam=0.01)
    j_idx, j_rep = jdec.reduce_rig(rest, deformed, 120, jc, jp)
    t_idx, t_rep = decimate.reduce_rig(rest, deformed, 120, tc, tp, device="cpu")
    np.testing.assert_array_equal(t_idx, np.asarray(j_idx))
    assert t_rep.max_err == pytest.approx(j_rep.max_err, rel=1e-3, abs=1e-6)
    assert t_rep.rms_err == pytest.approx(j_rep.rms_err, rel=1e-3, abs=1e-6)
    assert t_rep.motion_scale == j_rep.motion_scale
    assert t_rep.relative_max_err == pytest.approx(j_rep.relative_max_err, rel=1e-3)
    del rng
    full_idx, full = decimate.reduce_rig(rest[:50], deformed[:50], 50, tc, tp, device="cpu")
    assert full.max_err == 0.0 and len(full_idx) == 50


def _phi64(kernel, d2, eps):
    s = np.maximum(d2, 0.0) / np.square(eps)
    if kernel == RBFKernel.THIN_PLATE:
        return np.where(s > 1e-30, 0.5 * s * np.log(np.maximum(s, 1e-300)), 0.0)
    assert kernel == RBFKernel.GAUSSIAN
    return np.exp(-s)


def _linear64(x):
    return np.hstack([np.ones((len(x), 1)), x.astype(np.float64)])


def _field64(kernel, ctrl, eps, w, tail, pts):
    """A single-layer LINEAR-tail model's field at pts, in float64."""
    c = np.asarray(ctrl, np.float64)
    d2 = np.square(pts.astype(np.float64)[:, None] - c[None]).sum(-1)
    return (_phi64(kernel, d2, np.asarray(eps, np.float64)) @ np.asarray(w, np.float64)
            + _linear64(pts) @ np.asarray(tail, np.float64))


def _exact_fields(kernel, jc, jp, rest, deltas, idx, eps, confidence, pts):
    """The reduced regression in float64 from its definition (design,
    confidence rows, ridge lam on the weights and 1e-6 of the Gram diagonal
    on the tail, TPS under P_K^T w = 0 with the -1e-8 shift), and its field
    at pts for each frame of deltas (F, N, 3): (F, P, 3).  The radii are the
    JAX model's and the ridge the JAX family rule's, so no port helper
    enters."""
    import jax.numpy as jnp
    from facedeform_tpu.ops import fit as jfit

    x = rest.astype(np.float64)
    centers = x[idx]
    kk = len(idx)
    _, lam0 = jfit._family_radii(jc, jp.clamped(), jnp.asarray(rest[idx]), None)
    lam = max(float(np.max(np.asarray(lam0))), 1e-6)
    a = np.hstack([_phi64(kernel, np.square(x[:, None] - centers[None]).sum(-1), eps),
                   _linear64(x)])
    f = deltas.shape[0]
    b = np.transpose(deltas.astype(np.float64), (1, 0, 2)).reshape(len(x), 3 * f)
    if confidence is not None:
        sw = np.sqrt(np.clip(confidence.astype(np.float64), 1e-3, 1.0))[:, None]
        a, b = a * sw, b * sw
    g = a.T @ a
    g = g + np.diag(np.concatenate([np.full(kk, lam), 1e-6 * np.diag(g)[kk:]]))
    rhs = a.T @ b
    if kernel == RBFKernel.THIN_PLATE:
        p_k = _linear64(centers)
        g = np.block([[g, np.vstack([p_k, np.zeros((4, 4))])],
                      [np.hstack([p_k.T, np.zeros((4, 4))]), -1e-8 * np.eye(4)]])
        rhs = np.vstack([rhs, np.zeros((4, 3 * f))])
    z = np.linalg.solve(g, rhs)[:kk + 4].reshape(kk + 4, f, 3)
    return np.stack([_field64(kernel, centers, eps, z[:kk, i], z[kk:, i], pts)
                     for i in range(f)])


def _fields_close(kernel, t_model, j_model, exact, pts, scale):
    """The same centers and radii; per frame, the port model's field within
    FIELD_RTOL of scale of the exact field, and within JAX's own distance
    from it (plus FIELD_RTOL of scale) of the JAX model's field."""
    np.testing.assert_array_equal(t_model.ctrl.numpy(), np.asarray(j_model.ctrl))
    # QNN radii: nearest-neighbor distances, an ulp apart at most
    np.testing.assert_allclose(t_model.eps.numpy(), np.asarray(j_model.eps), rtol=1e-6)
    f = exact.shape[0]
    ctrl = t_model.ctrl.numpy()
    t_w, j_w = t_model.w_rbf.numpy().reshape(f, -1, 3), np.asarray(j_model.w_rbf).reshape(f, -1, 3)
    t_c, j_c = t_model.w_poly.numpy().reshape(f, 4, 3), np.asarray(j_model.w_poly).reshape(f, 4, 3)
    eps_t, eps_j = t_model.eps.numpy()[0], np.asarray(j_model.eps)[0]
    for i in range(f):
        got = _field64(kernel, ctrl, eps_t, t_w[i], t_c[i], pts)
        jax_f = _field64(kernel, ctrl, eps_j, j_w[i], j_c[i], pts)
        d_t = np.abs(got - exact[i]).max()
        d_tj, d_j = np.abs(got - jax_f).max(), np.abs(jax_f - exact[i]).max()
        assert d_t <= FIELD_RTOL * scale, (i, d_t, scale)
        assert d_tj <= d_j + FIELD_RTOL * scale, (i, d_tj, d_j, scale)


@pytest.mark.parametrize("kind", ["qnn", "gaussian", "tps"])
@pytest.mark.parametrize("conf", [False, True])
def test_fit_reduced_matches_jax(kind, conf):
    """The regression over the same centers: the model as close to the
    float64 regression as JAX's, the same misfit info; TPS with the
    P_K^T w = 0 constraint."""
    rng = np.random.default_rng(2)
    rest = fibonacci_points(300)
    deformed = rest + (0.08 * np.sin(2.0 * rest[:, [1, 2, 0]])
                       + 0.005 * rng.standard_normal(rest.shape)).astype(np.float32)
    kw = {"qnn": {}, "gaussian": dict(model=RBFModelType.KERNEL, kernel=RBFKernel.GAUSSIAN),
          "tps": dict(model=RBFModelType.KERNEL, kernel=RBFKernel.THIN_PLATE)}[kind]
    jc, tc = _cfgs(**kw)
    jp, tp = jcfg.DeformParams(radius=0.8, lam=0.01), DeformParams(radius=0.8, lam=0.01)
    confidence = rng.uniform(0.2, 1.0, 300).astype(np.float32) if conf else None
    idx = np.asarray(jdec.select_markers(rest, 50)[0])
    jm, jrep, jinfo = jdec.fit_reduced(rest, deformed, 50, jc, jp, confidence=confidence, idx=idx)
    tm, trep, tinfo = decimate.fit_reduced(rest, deformed, 50, tc, tp, confidence=confidence,
                                           idx=idx, device="cpu")
    kernel = RBFKernel.GAUSSIAN if kind != "tps" else RBFKernel.THIN_PLATE
    pts = np.concatenate([rest[np.setdiff1d(np.arange(len(rest)), idx)], fibonacci_points(3000)])
    exact = _exact_fields(kernel, jc, jp, rest, (deformed - rest)[None], idx,
                          np.asarray(jm.eps, np.float64)[0], confidence, pts)
    _fields_close(kernel, tm, jm, exact, pts, np.abs(deformed - rest).max())
    errors.check_solve(trep)
    # the misfits follow JAX's float32 field floor (above)
    assert tinfo.fit_rms == pytest.approx(jinfo.fit_rms, rel=1e-2)
    assert tinfo.fit_max == pytest.approx(jinfo.fit_max, rel=1e-2)
    np.testing.assert_array_equal(tinfo.idx, idx)
    if kind == "tps":
        from facedeform_tpu_torch.ops.assemble import poly_basis

        w = tm.w_rbf[0].double()
        assert float((poly_basis(tm.ctrl, tc.term).double().T @ w).abs().max()) < 1e-4 * max(
            float(w.abs().max()), 1.0)
    # a stock RBFModel: the plain evaluator (centered for TPS) reproduces
    # the regression's own misfit at the markers
    got = evaluate(tm, torch.as_tensor(rest), kernel, tc.term).numpy()
    err = np.linalg.norm(got - (deformed - rest), axis=1)
    assert float(np.sqrt(np.mean(err ** 2))) == pytest.approx(tinfo.fit_rms, rel=1e-3)


def test_fit_reduced_frames_matches_jax_and_per_frame():
    rng = np.random.default_rng(3)
    n, f, k = 250, 4, 50
    rest = rng.standard_normal((n, 3)).astype(np.float32)
    frames = (rest[None] + 0.1 * rng.standard_normal((f, n, 3))).astype(np.float32)
    conf = rng.uniform(0.2, 1.0, n).astype(np.float32)
    jc, tc = _cfgs()
    jp, tp = jcfg.DeformParams(), DeformParams()
    jm, _, jinfo = jdec.fit_reduced_frames(rest, frames, k, jc, jp, confidence=conf)
    tm, rep, info = decimate.fit_reduced_frames(rest, frames, k, tc, tp, confidence=conf,
                                                device="cpu")
    np.testing.assert_array_equal(info.idx, np.asarray(jinfo.idx))
    pts = np.concatenate([rest[np.setdiff1d(np.arange(n), info.idx)],
                          (rest + 0.3 * rng.standard_normal((n, 3))).astype(np.float32)])
    exact = _exact_fields(RBFKernel.GAUSSIAN, jc, jp, rest, frames - rest[None], info.idx,
                          np.asarray(jm.eps, np.float64)[0], conf, pts)
    _fields_close(RBFKernel.GAUSSIAN, tm, jm, exact, pts, np.abs(frames - rest[None]).max())
    errors.check_solve(rep)
    assert rep.col_backward.shape == (3 * f,)
    assert tm.w_rbf.shape == (f, 1, k, 3) and tm.w_poly.shape == (f, 4, 3)
    np.testing.assert_allclose(info.fit_rms, jinfo.fit_rms, rtol=1e-4)
    for fi in range(f):
        m1, _, i1 = decimate.fit_reduced(rest, frames[fi], k, tc, tp, confidence=conf,
                                         idx=info.idx, device="cpu")
        np.testing.assert_allclose(tm.w_rbf[fi, 0].numpy(), m1.w_rbf[0].numpy(), atol=1e-6)
        np.testing.assert_allclose(tm.w_poly[fi].numpy(), m1.w_poly.numpy(), atol=1e-6)
        assert info.fit_rms[fi] == pytest.approx(i1.fit_rms, rel=1e-3)
    # a stock frames model: apply_frames takes it, the misfit bounds it
    out, _ = batched.apply_frames(tm, torch.as_tensor(rest), torch.zeros(n), torch.ones(n),
                                  tc, tp)
    err = np.linalg.norm(out.numpy() - frames, axis=2)
    assert err.max() <= 1.5 * info.fit_max.max() + 1e-5


def test_validation_and_deformer_reduced():
    rest = fibonacci_points(100)
    deformed = rest + 0.05
    with pytest.raises(ValueError, match="single-layer"):
        decimate.fit_reduced(rest, deformed, 10, DeformConfig(model=RBFModelType.MULTILAYER),
                             device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        decimate._resolve_centers(rest, 2, np.asarray([-1, 9]), None, "cpu")
    with pytest.raises(ValueError, match="duplicate"):
        decimate._resolve_centers(rest, 2, np.asarray([3, 3]), None, "cpu")
    with pytest.raises(ValueError, match="rig shapes differ"):
        decimate.fit_reduced(rest, deformed[:50], 10, device="cpu")
    with pytest.raises(ValueError, match=r"\(F, N, 3\)"):
        decimate.fit_reduced_frames(rest, deformed, 10, device="cpu")
    model, report, info = decimate.fit_reduced(rest, deformed, 20, device="cpu")
    d = Deformer(model=model, cfg=DeformConfig(), params=DeformParams(), report=report,
                 reduced=True)
    assert d.reduced and not Deformer.fit(rest, deformed, device="cpu").reduced
    moved, w = d.apply(rest)
    np.testing.assert_allclose(moved.numpy(), deformed, atol=1e-3)
    # a JAX reduced model carried across applies like the port's own
    jm, _, _ = jdec.fit_reduced(rest, deformed, 20, idx=info.idx)
    carried = convert.model_from_numpy({f: np.asarray(getattr(jm, f)) for f in jm._fields
                                        if getattr(jm, f) is not None}, device="cpu")
    d_j = Deformer(model=carried, cfg=DeformConfig(), params=DeformParams(), report=report,
                   reduced=True)
    np.testing.assert_allclose(d_j.apply(rest)[0].numpy(), moved.numpy(), atol=1e-5)
