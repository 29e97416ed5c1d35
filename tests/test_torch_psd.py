"""PyTorch port: pose-space deformation (ops/psd.py) against the JAX
package's facedeform_tpu.ops.psd on the same seeded examples, CPU tensors.

The host helpers (features_from_rig, rigid_align, auto_eps, pose_feature)
are numpy in both packages and must agree bit for bit; the cardinal solve,
the weights and the blended corrections are f32 on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
from facedeform_tpu.geometry.primitives import fibonacci_points
from facedeform_tpu.ops import psd as jpsd
from facedeform_tpu_torch.ops import psd as tpsd

ALPHA_RTOL = 1e-5     # the cardinal inverse, of its largest entry
# pose-space weights (tests/test_psd.py holds them to 1e-4); a TPS fit's
# cardinal inverse has large entries that cancel in phi @ alpha, where any
# two f32 solves differ by ~1e-4
W_TOL = 1e-4
DELTA_RTOL = 1e-4     # blended corrections, of the largest one (W_TOL's reason)
EXACT_TOL = 5e-5      # sculpt reproduction at an example pose (BASELINE.md), of scale

K = jcfg.RBFKernel


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One torch intra-op thread, as the other JAX-parity tests run (see
    tests/test_torch_eval.py); never raised again."""
    torch.set_num_threads(1)


def _examples(k=4, n_rig=24, v=300, seed=0):
    rng = np.random.default_rng(seed)
    rest = fibonacci_points(n_rig)
    posed = np.stack([rest + 0.05 * rng.standard_normal(rest.shape).astype(np.float32)
                      for _ in range(k)])
    corr = 0.1 * rng.standard_normal((k, v, 3)).astype(np.float32)
    return rest, posed, corr


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


FIT_CASES = [
    ("gaussian_auto", K.GAUSSIAN, None, 0.0),
    ("gaussian_eps", K.GAUSSIAN, 0.3, 0.0),
    ("imq_ridge", K.INVERSE_MULTIQUADRIC, None, 0.01),
    ("tps_ridge", K.THIN_PLATE, None, 0.05),
    ("wendland", K.WENDLAND_C2, 2.0, 0.0),
]


@pytest.mark.parametrize("name,kernel,eps,lam", FIT_CASES, ids=[c[0] for c in FIT_CASES])
def test_fit_weights_delta_match_jax(name, kernel, eps, lam):
    rest, posed, corr = _examples()
    feats = np.stack([jpsd.features_from_rig(rest, p) for p in posed])
    jm, jrep = jpsd.fit_psd(feats, corr, kernel, eps, lam)
    tm, trep = tpsd.fit_psd(feats, corr, kernel, eps, lam, device="cpu")
    np.testing.assert_array_equal(tm.features.numpy(), np.asarray(jm.features))
    np.testing.assert_array_equal(tm.corrections.numpy(), np.asarray(jm.corrections))
    assert float(tm.eps) == float(jm.eps)
    assert _rel(tm.alpha.numpy(), jm.alpha) <= ALPHA_RTOL
    assert float(trep.backward_error()) <= 1e-6
    rng = np.random.default_rng(1)
    queries = np.concatenate([feats, feats[:2] + 0.02 * rng.standard_normal(feats[:2].shape)
                              .astype(np.float32)])
    for normalize in (False, True):
        jw = np.asarray(jpsd.psd_weights(jm, queries, kernel, normalize))
        tw = tpsd.psd_weights(tm, queries, kernel, normalize).numpy()
        np.testing.assert_allclose(tw, jw, rtol=0, atol=W_TOL)
        jd = np.asarray(jpsd.psd_delta(jm, queries, kernel, normalize))
        td = tpsd.psd_delta(tm, queries, kernel, normalize).numpy()
        assert td.shape == jd.shape == (len(queries), corr.shape[1], 3)
        assert _rel(td, jd) <= DELTA_RTOL
        # one pose: (V, 3), its row of the batch (GEMMs of another shape
        # round apart, and the TPS weights cancel: W_TOL)
        one = tpsd.psd_delta(tm, queries[0], kernel, normalize).numpy()
        assert one.shape == td[0].shape and _rel(one, td[0]) <= W_TOL
    if lam == 0.0:
        # exact reproduction at each example pose (cardinal weights e_j)
        for j in range(len(feats)):
            d = tpsd.psd_delta(tm, feats[j], kernel).numpy()
            assert np.abs(d - corr[j]).max() <= EXACT_TOL * np.abs(corr[j]).max()


def test_normalize_gate_matches_jax_far_from_examples():
    """The gated, clamped normalize divide: exact w / s where |s| >= 1e-2,
    fading to the raw weights where every example is out of reach."""
    rest, posed, corr = _examples()
    feats = np.stack([jpsd.features_from_rig(rest, p) for p in posed])
    jm, _ = jpsd.fit_psd(feats, corr, K.GAUSSIAN)
    tm, _ = tpsd.fit_psd(feats, corr, K.GAUSSIAN, device="cpu")
    rng = np.random.default_rng(2)
    far = feats[:1] + np.linspace(0.0, 3.0, 16)[:, None] * rng.standard_normal(
        feats.shape[1]).astype(np.float32)[None]
    jw = np.asarray(jpsd.psd_weights(jm, far.astype(np.float32), K.GAUSSIAN, True))
    tw = tpsd.psd_weights(tm, far.astype(np.float32), K.GAUSSIAN, True).numpy()
    np.testing.assert_allclose(tw, jw, rtol=0, atol=W_TOL)
    raw = tpsd.psd_weights(tm, far.astype(np.float32), K.GAUSSIAN, False).numpy()
    s = raw.sum(-1)
    assert (np.abs(s) < 1e-2).any() and (np.abs(s) >= 1e-2).any()
    big = np.abs(s) >= 1e-2
    np.testing.assert_allclose(tw[big].sum(-1), 1.0, atol=1e-5)
    # at an example pose normalize keeps exact reproduction
    np.testing.assert_allclose(tpsd.psd_weights(tm, feats, K.GAUSSIAN, True).numpy(),
                               np.eye(len(feats)), atol=W_TOL)


def test_host_helpers_equal_jax():
    rest, posed, _ = _examples()
    rng = np.random.default_rng(4)
    theta = 0.4
    rot = np.asarray([[np.cos(theta), -np.sin(theta), 0], [np.sin(theta), np.cos(theta), 0],
                      [0, 0, 1]], np.float32)
    moved = (posed[0] @ rot.T + np.float32([0.3, -0.1, 0.2])).astype(np.float32)
    for p in (posed[1], moved):
        np.testing.assert_array_equal(tpsd.features_from_rig(rest, p),
                                      jpsd.features_from_rig(rest, p))
        for got, want in zip(tpsd.rigid_align(rest, p), jpsd.rigid_align(rest, p)):
            np.testing.assert_array_equal(got, want)
        for align in (False, True):
            tf, tr = tpsd.pose_feature(rest, p, align)
            jf, jr = jpsd.pose_feature(rest, p, align)
            np.testing.assert_array_equal(tf, jf)
            assert (tr is None) == (jr is None)
            if tr is not None:
                np.testing.assert_array_equal(tr, jr)
    feats = rng.standard_normal((5, 30)).astype(np.float32)
    assert tpsd.auto_eps(feats) == jpsd.auto_eps(feats)
    assert tpsd.auto_eps(feats[:1]) == jpsd.auto_eps(feats[:1])


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_deformer_facade_matches_jax(align, normalize):
    rest, posed, corr = _examples()
    jd = jpsd.PSDDeformer.fit(rest, posed, corr, normalize=normalize, align=align)
    td = tpsd.PSDDeformer.fit(rest, posed, corr, normalize=normalize, align=align, device="cpu")
    rng = np.random.default_rng(5)
    query = (posed[2] + 0.01 * rng.standard_normal(rest.shape)).astype(np.float32)
    np.testing.assert_allclose(td.weights(rest, query).numpy(),
                               np.asarray(jd.weights(rest, query)), atol=W_TOL)
    assert _rel(td.delta(rest, query).numpy(), jd.delta(rest, query)) <= DELTA_RTOL
    shot = np.stack([posed[0], query, posed[3]])
    frames = td.delta_frames(rest, shot).numpy()
    assert _rel(frames, jd.delta_frames(rest, shot)) <= DELTA_RTOL
    for f in range(len(shot)):
        assert _rel(frames[f], td.delta(rest, shot[f]).numpy()) <= 1e-6
    # an example pose gives back its (world-space) correction
    ex = td.delta(rest, posed[1]).numpy()
    assert np.abs(ex - corr[1]).max() <= EXACT_TOL * np.abs(corr[1]).max()


ERROR_CASES = {
    "duplicate_pose": lambda m, f, c: m.fit_psd(np.stack([f[0], f[0], f[1]]), c[:3]),
    "non_pd_without_ridge": lambda m, f, c: m.fit_psd(f, c, K.THIN_PLATE, None, 0.0),
    "bad_features": lambda m, f, c: m.fit_psd(f[0], c),
    "bad_corrections": lambda m, f, c: m.fit_psd(f, c[:, :, :2]),
    "bad_eps": lambda m, f, c: m.fit_psd(f, c, K.GAUSSIAN, -1.0),
    "rigid_align_two_markers": lambda m, f, c: m.rigid_align(np.zeros((2, 3)), np.ones((2, 3))),
}


@pytest.mark.parametrize("name", list(ERROR_CASES))
def test_errors_match_jax(name):
    rest, posed, corr = _examples()
    feats = np.stack([jpsd.features_from_rig(rest, p) for p in posed])
    msgs = []
    for mod in (jpsd, tpsd):
        with pytest.raises(ValueError) as e:
            ERROR_CASES[name](mod, feats, corr)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_pairwise_sqdist_nd_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((5, 90)).astype(np.float32)
    y = rng.standard_normal((7, 90)).astype(np.float32)
    want = np.asarray(jpsd.pairwise_sqdist_nd(jnp.asarray(x), jnp.asarray(y)))
    got = tpsd.pairwise_sqdist_nd(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
