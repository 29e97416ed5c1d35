"""PyTorch port: DBSE morph-space weights and morph pass against the JAX
package on the same bases and poses (CPU tensors), at the JAX tests'
tolerances (tests/test_dbse.py, tests/test_dbse_robust.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
from facedeform_tpu.ops import dbse as jdbse
from facedeform_tpu.utils import errors as jerrors
from facedeform_tpu_torch import convert
from facedeform_tpu_torch.ops import dbse
from facedeform_tpu_torch.utils import errors


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One torch intra-op thread, as the other JAX-parity tests run (see
    tests/test_torch_eval.py); never raised again."""
    torch.set_num_threads(1)


def _synthetic(seed, v=200, s=5):
    rng = np.random.default_rng(seed)
    rest = rng.standard_normal((v, 3)).astype(np.float32)
    shapes = [rest + 0.1 * rng.standard_normal((v, 3)).astype(np.float32) for _ in range(s)]
    return rng, rest, shapes


def _models(rest, shapes, parity=False):
    return (jdbse.build_model(rest, shapes, parity=parity),
            dbse.build_model(rest, shapes, parity=parity, device="cpu"))


def test_build_model_and_packed_qr_match_jax():
    _, rest, shapes = _synthetic(0, v=60, s=4)
    jm, tm = _models(rest, shapes, parity=True)
    np.testing.assert_array_equal(tm.deltas.numpy(), np.asarray(jm.deltas))
    np.testing.assert_array_equal(tm.packed_qr.numpy(), np.asarray(jm.packed_qr))
    b = np.random.default_rng(1).standard_normal((40, 6))
    np.testing.assert_array_equal(dbse.householder_packed(b), jdbse.householder_packed(b))
    carried = convert.dbse_model_from_numpy(
        {f: np.asarray(getattr(jm, f)) for f in jm._fields}, device="cpu")
    np.testing.assert_array_equal(carried.deltas.numpy(), tm.deltas.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lstsq_recovers_weights_like_jax(seed):
    rng, rest, shapes = _synthetic(seed)
    jm, tm = _models(rest, shapes)
    w_true = np.float32([0.3, -0.2, 0.7, 0.05, -0.5])
    pose = rest + np.einsum("s,svc->vc", w_true, tm.deltas.numpy())
    wj, _ = jdbse.weights_lstsq(jm, jnp.asarray(pose), jnp.asarray(rest))
    wt, rep = dbse.weights_lstsq(tm, pose, rest)
    np.testing.assert_allclose(wt.numpy(), w_true, atol=1e-4)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-5)
    errors.check_solve(rep)
    disp = dbse.reconstruct(tm, wt, None, parity_scale=False)
    np.testing.assert_allclose(rest + disp.numpy(), pose, atol=1e-4)
    # a pose outside the subspace: the same projection as JAX
    off = rest + 0.2 * rng.standard_normal(rest.shape).astype(np.float32)
    wj, _ = jdbse.weights_lstsq(jm, jnp.asarray(off), jnp.asarray(rest))
    wt, _ = dbse.weights_lstsq(tm, off, rest)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parity_weights_match_jax_and_f64(seed):
    """weights_parity = the float64 column sum of the delta-scaled packed
    QR (dbse.cpp:53-55), as JAX's."""
    rng, rest, shapes = _synthetic(seed, v=50, s=4)
    jm, tm = _models(rest, shapes, parity=True)
    pose = rest + 0.1 * rng.standard_normal((50, 3)).astype(np.float32)
    wt = dbse.weights_parity(tm, pose, rest).numpy()
    d = (pose - rest).astype(np.float64).reshape(-1)
    want = (d[:, None] * tm.packed_qr.double().numpy()).sum(axis=0)
    np.testing.assert_allclose(wt, want, rtol=1e-4, atol=1e-5)
    wj = np.asarray(jdbse.weights_parity(jm, jnp.asarray(pose), jnp.asarray(rest)))
    np.testing.assert_allclose(wt, wj, rtol=1e-4, atol=1e-5)


def _robust_setup(seed, outlier_frac):
    rng = np.random.default_rng(seed)
    v, s = 400, 4
    rest = rng.standard_normal((v, 3)).astype(np.float32)
    shapes = [rest + 0.1 * rng.standard_normal((v, 3)).astype(np.float32) for _ in range(s)]
    jm, tm = _models(rest, shapes)
    w_true = np.float32([0.4, -0.3, 0.6, 0.1])
    pose = rest + np.einsum("s,svc->vc", w_true, tm.deltas.numpy())
    if outlier_frac:
        bad = rng.choice(v, size=int(v * outlier_frac), replace=False)
        pose[bad] += 5.0 * rng.standard_normal((len(bad), 3)).astype(np.float32)
    return jm, tm, rest, pose.astype(np.float32), w_true


@pytest.mark.parametrize("outlier_frac", [0.0, 0.02, 0.05])
def test_robust_weights_match_jax(outlier_frac):
    jm, tm, rest, pose, w_true = _robust_setup(3, outlier_frac)
    wj, _ = jdbse.weights_robust(jm, jnp.asarray(pose), jnp.asarray(rest))
    wt, rep = dbse.weights_robust(tm, pose, rest)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-4)
    wl, _ = dbse.weights_lstsq(tm, pose, rest)
    err_r = np.abs(wt.numpy() - w_true).max()
    if outlier_frac:
        assert err_r < 0.1 * np.abs(wl.numpy() - w_true).max()
        assert err_r < 5e-3
    else:
        np.testing.assert_allclose(wt.numpy(), w_true, atol=1e-4)
    assert np.isfinite(rep.residual_norm.numpy()).all()


def test_huber_helpers_match_jax():
    rng = np.random.default_rng(5)
    for n in (101, 100):               # odd and even counts: the median
        r = np.abs(rng.standard_normal(n)).astype(np.float32)
        dj = float(jdbse.huber_scale(jnp.asarray(r)))
        dt = float(dbse.huber_scale(torch.as_tensor(r)))
        assert dt == pytest.approx(dj, rel=1e-6)
        np.testing.assert_allclose(
            dbse.huber_vertex_weights(torch.as_tensor(r), torch.tensor(dt)).numpy(),
            np.asarray(jdbse.huber_vertex_weights(jnp.asarray(r), jnp.asarray(dj))),
            rtol=1e-6)
    zero = torch.zeros(10)
    assert float(dbse.huber_scale(zero)) == 0.0
    assert (dbse.huber_vertex_weights(zero, torch.tensor(0.0)) == 1).all()


def test_reconstruct_clamp_and_parity_scale_x3():
    _, rest, shapes = _synthetic(4, v=30, s=2)
    jm, tm = _models(rest, shapes)
    for w, clamp, scale in (([0.5, -1.0], (0.0, 1.0), True), ([0.5, -1.0], None, True),
                            ([0.2, 0.3], (-0.1, 0.25), False), ([0.2, 0.3], None, False)):
        jc = None if clamp is None else tuple(jnp.asarray(c) for c in clamp)
        want = np.asarray(jdbse.reconstruct(jm, jnp.asarray(w), jc, parity_scale=scale))
        got = dbse.reconstruct(tm, torch.tensor(w), clamp, parity_scale=scale).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
    disp = dbse.reconstruct(tm, torch.tensor([0.5, -1.0]), (0.0, 1.0), parity_scale=True)
    want = np.einsum("s,svc->vc", [1.0, 0.0], tm.deltas.numpy())
    np.testing.assert_allclose(disp.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("dofalloff", [False, True])
@pytest.mark.parametrize("falloffradius", [0.0, 0.5])
def test_morph_pass_quirk5_matches_jax(dofalloff, falloffradius):
    """P = rest + disp + (P - rest) * falloffradius only when dofalloff and
    falloffradius != 0 (SURVEY.md quirk 5)."""
    rng = np.random.default_rng(6)
    rest, pos, disp = (rng.standard_normal((5, 3)).astype(np.float32) for _ in range(3))
    want = np.asarray(jdbse.morph_pass(jnp.asarray(pos), jnp.asarray(rest), jnp.asarray(disp),
                                       jnp.asarray(dofalloff), jnp.asarray(falloffradius)))
    got = dbse.morph_pass(torch.as_tensor(pos), torch.as_tensor(rest), torch.as_tensor(disp),
                          dofalloff, falloffradius).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    on = dbse.morph_pass(torch.ones(5, 3), torch.zeros(5, 3), torch.full((5, 3), 0.1), True, 0.5)
    np.testing.assert_allclose(on.numpy(), 0.6, atol=1e-6)


@pytest.mark.parametrize("route", ["lstsq", "robust", "parity"])
@pytest.mark.parametrize("clamp", [False, True])
def test_morph_apply_matches_jax(route, clamp):
    """The morph stage for each weights route (the node's cook, node.py
    960-1000): weights, clamp, parity x3 and the residual term."""
    rng, rest, shapes = _synthetic(7, v=80, s=4)
    parity = route == "parity"
    jm, tm = _models(rest, shapes, parity=parity)
    pose = rest + 0.1 * rng.standard_normal(rest.shape).astype(np.float32)
    fields = dict(dofalloff=True, doclampweight=clamp, dbse_lstsq=not parity,
                  dbse_robust=route == "robust", morphspace=True)
    jc = jcfg.DeformConfig(**fields)
    tc = convert.config_from_fields(dataclasses.asdict(jc))
    jp = jcfg.DeformParams(falloffradius=0.3, weight_lo=-0.2, weight_hi=0.4)
    tp = convert.params_from_fields(jp._asdict())
    if route == "parity":
        wj = jdbse.weights_parity(jm, jnp.asarray(pose), jnp.asarray(rest))
        wt = dbse.weights_parity(tm, pose, rest)
    elif route == "robust":
        wj, _ = jdbse.weights_robust(jm, jnp.asarray(pose), jnp.asarray(rest))
        wt, _ = dbse.weights_robust(tm, pose, rest)
    else:
        wj, _ = jdbse.weights_lstsq(jm, jnp.asarray(pose), jnp.asarray(rest))
        wt, _ = dbse.weights_lstsq(tm, pose, rest)
    want = np.asarray(jdbse.morph_apply(jm, jnp.asarray(pose), jnp.asarray(rest), wj, jc, jp))
    got = dbse.morph_apply(tm, pose, rest, wt, tc, tp).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_frames_axis_batched_matches_per_frame():
    """The shot forms (lstsq/parity/robust batched, reconstruct and
    morph_pass over a frame axis) reproduce the per-frame calls, and the
    frame axis matches JAX's vmapped forms."""
    rng, rest, shapes = _synthetic(8, v=60, s=3)
    jm, tm = _models(rest, shapes, parity=True)
    poses = rest + 0.1 * rng.standard_normal((4, 60, 3)).astype(np.float32)
    wf, rep = dbse.weights_lstsq_batched(tm, poses, rest)
    assert errors.frames_solve_ok(rep).tolist() == [True] * 4
    wp = dbse.weights_parity_batched(tm, poses, rest)
    wr, rep_r = dbse.weights_robust_batched(tm, poses, rest)
    assert rep_r.residual_norm.shape == (4,)
    np.testing.assert_allclose(
        wf.numpy(), np.asarray(jdbse.weights_lstsq_batched(jm, jnp.asarray(poses),
                                                           jnp.asarray(rest))[0]), atol=1e-5)
    np.testing.assert_allclose(
        wr.numpy(), np.asarray(jdbse.weights_robust_batched(jm, jnp.asarray(poses),
                                                            jnp.asarray(rest))[0]), atol=1e-4)
    disp_f = dbse.reconstruct(tm, wf, (-0.5, 0.5), parity_scale=False)
    disp_p = dbse.reconstruct(tm, wp, None, parity_scale=True)
    morph_f = dbse.morph_pass(torch.as_tensor(poses), torch.as_tensor(rest), disp_f, True, 0.25)
    for f in range(4):
        w1, _ = dbse.weights_lstsq(tm, poses[f], rest)
        np.testing.assert_allclose(wf[f].numpy(), w1.numpy(), atol=1e-6)
        np.testing.assert_allclose(wp[f].numpy(), dbse.weights_parity(tm, poses[f], rest).numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(wr[f].numpy(), dbse.weights_robust(tm, poses[f], rest)[0].numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(
            disp_f[f].numpy(), dbse.reconstruct(tm, w1, (-0.5, 0.5), False).numpy(), atol=1e-6)
        np.testing.assert_allclose(
            disp_p[f].numpy(), dbse.reconstruct(tm, wp[f], None, True).numpy(), atol=1e-6)
        np.testing.assert_allclose(
            morph_f[f].numpy(),
            dbse.morph_pass(torch.as_tensor(poses[f]), torch.as_tensor(rest), disp_f[f], True,
                            0.25).numpy(), atol=1e-6)


def test_frames_solve_ok_flags_only_bad_frames():
    """A corrupt pose fails its own frame only, as in JAX."""
    rng, rest, shapes = _synthetic(9, v=40, s=2)
    jm, tm = _models(rest, shapes)
    poses = rest + 0.1 * rng.standard_normal((4, 40, 3)).astype(np.float32)
    poses[2, 7, 1] = np.nan
    _, rep = dbse.weights_lstsq_batched(tm, poses, rest)
    _, jrep = jdbse.weights_lstsq_batched(jm, jnp.asarray(poses), jnp.asarray(rest))
    np.testing.assert_array_equal(errors.frames_solve_ok(rep), jerrors.frames_solve_ok(jrep))
    np.testing.assert_array_equal(errors.frames_solve_ok(rep), [True, True, False, True])
