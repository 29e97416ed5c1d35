"""PyTorch port: the skinning decomposition (ops/skinning.py) against the
JAX package's facedeform_tpu.ops.skinning on the same seeded inputs, CPU
tensors.

Each stage is held to JAX from identical inputs: the capped-simplex
projection at 1e-6, Horn's quaternions at 1e-5 after the w >= 0 rule,
Procrustes at 1e-5 (and to a float64 reference), k-means labels exactly
from the same init, one PGD call at 1e-5, lbs_apply at 1e-6.

fit_skinning runs on every fixture of tests/test_skinning.py.  Its
reports must agree within 1% (or 1e-6 of the bbox diagonal where both
sit at the f32 floor).  Weights are held at 1e-4 where the fixture
determines them: the two rigid clusters, the single bone and the noisy
Laplacian sweeps.  On the smooth twists, the exact-ties case and the pure
translation of the edges-only fixture the weights (and so their
roughness) are not determined by the data (bone bases that are nearly or
exactly parallel leave a flat valley): each stage from identical inputs
agrees to ~1e-7, yet eight alternation rounds carry that to weights 0.2
apart whose reconstructions agree to 1e-7 of the bbox, so those
fixtures hold the reconstructed frames at 1e-4 of the bbox instead.  On
the off-origin mesh the JAX package's uncentered f32 Procrustes moments
cancel (its fit sits at 4.2e-4 of the bbox, the port's centered moments
at ~1e-6): the port must fit at least as well as JAX and within the JAX
test's bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedeform_tpu.geometry.primitives import fibonacci_points, uv_sphere
from facedeform_tpu.geometry.topology import unique_edges
from facedeform_tpu.ops import skinning as J
from facedeform_tpu_torch.ops import skinning as T

PROJ_TOL = 1e-6
HORN_TOL = 1e-5
PROCRUSTES_TOL = 1e-5
PGD_TOL = 1e-5
# PGD iterations of the stage test: the twist's weights sit in a flat valley
# (see above), where later iterates drift apart at ~1e-4 from identical inputs
PGD_ITERS = 4
LBS_TOL = 1e-6
W_TOL = 1e-4
REPORT_RTOL = 1e-2
REPORT_FLOOR = 1e-6   # of the bbox diagonal: both fits at the f32 floor
RECON_TOL = 1e-4      # of the bbox diagonal


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One torch intra-op thread, as the other JAX-parity tests run (see
    tests/test_torch_eval.py); never raised again."""
    torch.set_num_threads(1)


def _rotation(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)).astype(np.float32)


def _twist(pts, noise=0.0, seed=42):
    ang = 0.6 * (pts[:, 1] - pts[:, 1].min())
    ca, sa = np.cos(ang), np.sin(ang)
    moved = np.stack([ca * pts[:, 0] - sa * pts[:, 2], pts[:, 1],
                      sa * pts[:, 0] + ca * pts[:, 2]], -1).astype(np.float32)
    frames = np.stack([pts + 0.5 * (moved - pts), moved])
    if noise:
        frames = frames + noise * np.random.default_rng(seed).standard_normal(
            frames.shape).astype(np.float32)
    return frames


def _two_clusters():
    pts = fibonacci_points(400) * np.float32([2.0, 1.0, 1.0])
    left = pts[:, 0] < 0
    frames = []
    for ang in (0.2, 0.5, -0.3):
        moved = pts.copy()
        moved[left] = pts[left] @ _rotation([0, 0, 1], ang).T + np.float32([0.1, 0.3, 0.0]) * ang
        frames.append(moved)
    return pts, np.stack(frames), dict(n_bones=2, max_influences=2, seed=3)


def _single_bone():
    pts = fibonacci_points(200)
    frames = (pts @ _rotation([1, 2, 0], 0.7).T + np.float32([0.4, -0.2, 1.0]))[None]
    return pts, frames, dict(n_bones=1, max_influences=1, outer_iters=2)


def _off_origin():
    pts = fibonacci_points(300) + np.float32([50.0, -30.0, 20.0])
    left = pts[:, 0] < 50.0
    moved = pts.copy()
    moved[left] = ((pts[left] - pts.mean(0)) @ _rotation([0, 1, 0], 0.4).T + pts.mean(0)
                   + np.float32([0, 0.2, 0]))
    return pts, moved[None], dict(n_bones=2, max_influences=2, seed=1)


def _smooth(b):
    pts = uv_sphere(24, 24).points
    return pts, _twist(pts), dict(n_bones=b, max_influences=4, seed=0)


def _laplacian(lam):
    mesh = uv_sphere(20, 20)
    kw = dict(n_bones=8, max_influences=4, seed=0, edges=unique_edges(mesh.faces))
    if lam:
        kw["smooth_lambda"] = lam
    return mesh.points, _twist(mesh.points, noise=0.01), kw


def _edges_only():
    mesh = uv_sphere(8, 8)
    frames = (mesh.points + np.float32([0, 0.2, 0]))[None]
    return mesh.points, frames, dict(n_bones=2, max_influences=2, seed=0,
                                     edges=unique_edges(mesh.faces))


def _ties():
    pts = fibonacci_points(60)
    frames = np.stack([pts + np.float32([0.3, 0, 0]), pts + np.float32([0, 0.5, 0])])
    return pts, frames, dict(n_bones=4, max_influences=2, seed=0)


# (fixture, weights determined by the data)
FIT_CASES = {
    "two_rigid_clusters": (_two_clusters, True),
    "single_bone": (_single_bone, True),
    "smooth_4_bones": (lambda: _smooth(4), False),
    "smooth_12_bones": (lambda: _smooth(12), False),
    "laplacian_edges_only": (lambda: _laplacian(0.0), True),
    "laplacian_lambda_0.1": (lambda: _laplacian(0.1), True),
    "edges_without_lambda": (_edges_only, False),
    "exact_ties": (_ties, False),
}


def _frames_of(mod, model, n, to_np):
    return np.stack([to_np(mod.lbs_apply(model.weights, model.rest, model.rotations[f],
                                         model.translations[f])) for f in range(n)])


def _fit_both(make):
    x, p, kw = make()
    mj, rj = J.fit_skinning(x, p, **kw)
    mt, rt = T.fit_skinning(x, p, device="cpu", **kw)
    return x, p, kw, (mj, rj), (mt, rt)


def _close(a, b, bbox):
    return abs(a - b) <= max(REPORT_RTOL * abs(a), REPORT_FLOOR * bbox)


@pytest.mark.parametrize("name", list(FIT_CASES))
def test_fit_skinning_matches_jax(name):
    make, determined = FIT_CASES[name]
    x, p, kw, (mj, rj), (mt, rt) = _fit_both(make)
    bbox = rj.bbox_diag
    assert rt.bbox_diag == rj.bbox_diag
    assert _close(rj.rmse, rt.rmse, bbox), (rj, rt)
    assert _close(rj.max_err, rt.max_err, bbox), (rj, rt)
    assert (rj.weight_roughness is None) == (rt.weight_roughness is None)
    if determined and rj.weight_roughness is not None:
        assert abs(rj.weight_roughness - rt.weight_roughness) <= REPORT_RTOL * rj.weight_roughness
    wj, wt = np.asarray(mj.weights), mt.weights.numpy()
    assert wt.shape == wj.shape and mt.rotations.shape == tuple(mj.rotations.shape)
    np.testing.assert_allclose(wt.sum(-1), 1.0, atol=1e-4)
    assert (wt >= -1e-6).all()
    assert ((wt > 1e-6).sum(-1) <= kw["max_influences"]).all()
    if determined:
        assert float(np.abs(wt - wj).max()) <= W_TOL
        # the same influence support: a bone one side gives more than the
        # tolerance, the other gives some weight too
        assert not ((wj > W_TOL) & (wt <= 0)).any() and not ((wt > W_TOL) & (wj <= 0)).any()
    else:
        recon_j = _frames_of(J, mj, len(p), np.asarray)
        recon_t = _frames_of(T, mt, len(p), lambda t: t.numpy())
        assert float(np.abs(recon_t - recon_j).max()) <= RECON_TOL * bbox


def test_off_origin_fits_at_least_as_well_as_jax():
    x, p, kw, (mj, rj), (mt, rt) = _fit_both(_off_origin)
    assert rt.rmse < 2e-3 * rt.bbox_diag            # tests/test_skinning.py's bound
    assert rt.rmse <= rj.rmse and rt.max_err <= rj.max_err, (rj, rt)
    assert rt.rmse <= 1e-5 * rt.bbox_diag, rt


def test_influence_cap_holds_under_exact_ties():
    x, p, kw = _ties()
    model, report = T.fit_skinning(x, p, device="cpu", **kw)
    w = model.weights.numpy()
    assert ((w > 1e-6).sum(-1) <= 2).all()
    np.testing.assert_allclose(w.sum(-1), 1.0, atol=1e-4)
    assert report.rmse < 1e-5


def test_project_capped_simplex_matches_jax(rng):
    w = rng.normal(size=(40, 12)).astype(np.float32)
    for mask in (np.ones_like(w, bool), rng.random((40, 12)) < 0.5):
        mask[:, 0] = True
        want = np.asarray(J.project_capped_simplex(jnp.asarray(w), jnp.asarray(mask)))
        got = T.project_capped_simplex(torch.tensor(w), torch.tensor(mask)).numpy()
        np.testing.assert_allclose(got, want, atol=PROJ_TOL)
        assert (got[~mask] == 0).all()


def test_top_eigenvector_matches_float64_eigh(rng):
    """The squaring solver that stands in for eigh (cuSOLVER's batched
    eigh refuses 1M matrices): within 1e-5 of a float64 eigh's top
    eigenvector, up to sign, and LAPACK's answer on a zero matrix."""
    a = rng.normal(size=(4096, 4, 4))
    a = (a + np.swapaxes(a, -1, -2)).astype(np.float32)
    vals, vecs = np.linalg.eigh(a.astype(np.float64))
    got = T._top_eigenvector(torch.tensor(a)).numpy().astype(np.float64)
    want = vecs[..., -1] * np.sign(np.sum(got * vecs[..., -1], -1, keepdims=True))
    np.testing.assert_allclose(got, want, atol=HORN_TOL)
    np.testing.assert_array_equal(T._top_eigenvector(torch.zeros(2, 4, 4)).numpy(),
                                  [[0, 0, 0, 1], [0, 0, 0, 1]])


def test_horn_quaternions_match_jax(rng):
    s = rng.normal(size=(64, 3, 3)).astype(np.float32)
    want = np.asarray(J._horn_quaternions(jnp.asarray(s)))
    got = T._horn_quaternions(torch.tensor(s)).numpy()
    assert (got[:, 0] >= 0).all()
    np.testing.assert_allclose(got, want, atol=HORN_TOL)


def _procrustes64(x, frames, w):
    x, frames, w = (np.asarray(a, np.float64) for a in (x, frames, w))
    sw = w.sum(0)
    xc = (w.T @ x) / sw[:, None]
    r_all, t_all = [], []
    for p in frames:
        pc = (w.T @ p) / sw[:, None]
        s = (np.einsum("vb,vi,vj->bij", w, p, x)
             - sw[:, None, None] * pc[:, :, None] * xc[:, None, :])
        u, _, vt = np.linalg.svd(s)
        d = np.ones((len(sw), 3))
        d[:, 2] = np.linalg.det(u @ vt)
        r = (u * d[:, None, :]) @ vt
        r_all.append(r)
        t_all.append(pc - np.einsum("bij,bj->bi", r, xc))
    return np.stack(r_all), np.stack(t_all)


@pytest.mark.parametrize("offset", [0.0, 50.0], ids=["origin", "off_origin"])
def test_procrustes_matches_jax_and_float64(rng, offset):
    x, p, _ = _smooth(6)
    x = x + np.float32(offset)
    p = p + np.float32(offset)
    w = rng.random((len(x), 6)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    r, t = T._procrustes_transforms(torch.tensor(x), torch.tensor(p), torch.tensor(w))
    r64, t64 = _procrustes64(x, p, w)
    np.testing.assert_allclose(r.numpy(), r64, atol=PROCRUSTES_TOL)
    np.testing.assert_allclose(t.numpy(), t64, atol=PROCRUSTES_TOL * max(1.0, offset))
    if offset == 0.0:
        rj, tj = J._procrustes_transforms(jnp.asarray(x), jnp.asarray(p), jnp.asarray(w))
        np.testing.assert_allclose(r.numpy(), np.asarray(rj), atol=PROCRUSTES_TOL)
        np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=PROCRUSTES_TOL)


def test_kmeans_labels_equal_from_the_same_init():
    x, p, kw = _smooth(12)
    feats = J._local_rigid_features(x, p, 8)
    got = T._local_rigid_features(x, p, 8, "cpu").numpy()
    np.testing.assert_allclose(got, feats, atol=HORN_TOL)
    idx = J._kmeanspp_indices(feats.astype(np.float64), 12, np.random.default_rng(0))
    idx_t = T._kmeanspp_indices(feats.astype(np.float64), 12, np.random.default_rng(0))
    np.testing.assert_array_equal(idx_t, idx)
    want = np.asarray(J._kmeans_labels(jnp.asarray(feats), jnp.asarray(feats[idx]), 12, 15,
                                       jnp.ones(len(x))))
    got = T._kmeans_labels(torch.tensor(feats), torch.tensor(feats[idx]), 12, 15,
                           torch.ones(len(x))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("capped", [False, True], ids=["full", "top2"])
def test_one_pgd_call_matches_jax(rng, capped):
    x, p, _ = _smooth(4)
    labels = rng.integers(0, 4, len(x))
    w0 = np.eye(4, dtype=np.float32)[labels]
    rj, tj = J._procrustes_transforms(jnp.asarray(x), jnp.asarray(p), jnp.asarray(w0))
    mask = np.ones_like(w0, bool)
    if capped:
        mask = np.argsort(np.argsort(-(w0 + rng.random(w0.shape).astype(np.float32)), -1), -1) < 2
    want = np.asarray(J._weights_pgd(jnp.asarray(x), jnp.asarray(p), rj, tj, jnp.asarray(w0),
                                     jnp.asarray(mask), PGD_ITERS))
    got = T._weights_pgd(torch.tensor(x), torch.tensor(p), torch.tensor(np.asarray(rj)),
                         torch.tensor(np.asarray(tj)), torch.tensor(w0), torch.tensor(mask),
                         PGD_ITERS).numpy()
    np.testing.assert_allclose(got, want, atol=PGD_TOL)


def test_pgd_bases_recomputed_past_the_cache_budget(monkeypatch):
    """Past BASIS_CACHE_BYTES the bases are recomputed per pass: the
    same arithmetic in the same order, so the same weights bit for bit."""
    x, p, _ = _smooth(4)
    xt, pt = torch.tensor(x), torch.tensor(p)
    w0 = torch.full((len(x), 4), 0.25)
    r, t = T._procrustes_transforms(xt, pt, w0)
    mask = torch.ones_like(w0, dtype=torch.bool)
    kept = T._weights_pgd(xt, pt, r, t, w0, mask, 6)
    monkeypatch.setattr(T, "BASIS_CACHE_BYTES", 0)
    assert T._Bases(xt, r, t).kept is None
    np.testing.assert_array_equal(T._weights_pgd(xt, pt, r, t, w0, mask, 6).numpy(),
                                  kept.numpy())


def test_lbs_apply_matches_jax(rng):
    v, b = 50, 6
    w = rng.random((v, b)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    rest = rng.normal(size=(v, 3)).astype(np.float32)
    r = np.stack([_rotation(rng.normal(size=3), rng.uniform(-1, 1)) for _ in range(b)])
    t = rng.normal(size=(b, 3)).astype(np.float32)
    want = np.asarray(J.lbs_apply(jnp.asarray(w), jnp.asarray(rest), jnp.asarray(r),
                                  jnp.asarray(t)))
    got = T.lbs_apply(*(torch.tensor(a) for a in (w, rest, r, t))).numpy()
    np.testing.assert_allclose(got, want, atol=LBS_TOL)


BAD_INPUTS = {
    "rest_2d": lambda pts: ((pts[:, :2], pts[None]), dict(n_bones=2)),
    "frames_2d": lambda pts: ((pts, pts), dict(n_bones=2)),
    "no_bones": lambda pts: ((pts, pts[None]), dict(n_bones=0)),
    "cap_over_bones": lambda pts: ((pts, pts[None]), dict(n_bones=2, max_influences=3)),
    "lambda_without_edges": lambda pts: (
        (pts, (pts + np.float32([0, 0.1, 0]))[None]),
        dict(n_bones=2, max_influences=2, smooth_lambda=0.1)),
    "edges_not_pairs": lambda pts: (
        (pts, pts[None]), dict(n_bones=2, max_influences=2, edges=np.zeros((3, 3), np.int64))),
    "edges_outside": lambda pts: (
        (pts, pts[None]),
        dict(n_bones=2, max_influences=2, edges=np.array([[0, 99]], np.int64),
             smooth_lambda=1.0)),
}


@pytest.mark.parametrize("name", list(BAD_INPUTS))
def test_validation_errors_match_jax(name):
    args, kw = BAD_INPUTS[name](fibonacci_points(20))
    with pytest.raises(ValueError) as want:
        J.fit_skinning(*args, **kw)
    with pytest.raises(ValueError) as got:
        T.fit_skinning(*args, device="cpu", **kw)
    assert str(got.value) == str(want.value)
