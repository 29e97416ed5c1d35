"""PyTorch port: the partition-of-unity route (ops/pu.py, ops/cuda_pu.py)
against the JAX package (Pallas in interpret mode) on the same numpy
inputs, and against float64 compositions written out here: the host
builders, the batched fit on both refinement routes, the plain and
float64 evals, the tile kernel's plain twin, the Jacobian, the facades
and their routing."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
from facedeform_tpu.geometry.primitives import fibonacci_points
from facedeform_tpu.ops import pallas_pu as jpallas
from facedeform_tpu.ops import pu as jpu
from facedeform_tpu.ops import solve as jsolve
from facedeform_tpu_torch import DeformConfig, Deformer, convert
from facedeform_tpu_torch.config import DeformParams
from facedeform_tpu_torch.ops import cuda_pu, pu, solve
from facedeform_tpu_torch.utils import profiling

K = jcfg.RBFKernel
T = jcfg.PolyTerm
BUDGET = 5e-5      # max displacement error at the controls (BASELINE.md)
# port vs JAX, f32 paths on the same weights: both sum a few hundred
# products per point in different orders (matmul vs segment_sum)
F32_TOL = 1e-6
# float64 evals vs a float64 composition: both round once to f32
F64_TOL = 1e-6
# the tile kernel's function (twin) vs Pallas: exact differences in f32 on
# both sides, contraction sums in another order; relative to max|disp|
TWIN_TOL = 2e-6


def _smooth_rig(n):
    rest = fibonacci_points(n)
    disp = (0.1 * np.exp(-3 * np.sum((rest - [0, 1, 0]) ** 2, -1, keepdims=True))
            ).astype(np.float32) * np.float32([0, 1, 0])
    return rest, disp


def _queries(n=300, seed=0):
    """Points near the rig, two far points (forced fallback) and points in
    the coverage-margin shell of the first patches."""
    rng = np.random.default_rng(seed)
    q = (fibonacci_points(n) * rng.uniform(0.97, 1.03, (n, 1))).astype(np.float32)
    return np.concatenate([q, np.float32([[5, 5, 5], [0, 0, -8]])])


def _shell(patches, n=3):
    """Points at 0.99995 R_k of the first n patches (inside the support,
    outside the 0.9999 coverage margin)."""
    ray = np.float32([0.6, 0.8, 0.0])
    return np.stack([patches.centers[k] + ray * patches.radii[k] * 0.99995
                     for k in range(n)]).astype(np.float32)


def _plain_plan(patches, q):
    plan = jpu.plan_eval(patches, q)
    return plan.tiles_patch, plan.tiles_vidx, plan.forced


def _port_model(m, device="cpu"):
    return convert.pu_model_from_numpy(
        {f: np.asarray(getattr(m, f)) for f in m._fields}, device)


@functools.lru_cache(maxsize=None)
def _jax_fit(kernel=K.THIN_PLATE, term=T.LINEAR, eps="auto", lam=1e-5, n=900,
             confidence=False):
    rest, disp = _smooth_rig(n)
    patches = jpu.build_patches(rest, patch_size=64)
    conf = np.linspace(0.3, 1.0, n).astype(np.float32) if confidence else None
    model, rep = jpu.fit_pu(rest, rest + disp, kernel, term, eps=eps, lam=lam,
                            patches=patches, confidence=conf)
    return rest, disp, patches, model, rep, conf


# ----------------------------------------------------------------- host build
@pytest.mark.parametrize("n,patch_size,bucket", [(600, 64, 64), (2000, 64, 1), (50, 192, 64)])
def test_build_patches_equal_jax(n, patch_size, bucket):
    rest, _ = _smooth_rig(n)
    want = jpu.build_patches(rest, patch_size=patch_size, width_bucket=bucket)
    got = pu.build_patches(rest, patch_size=patch_size, width_bucket=bucket)
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("n", [600, 40])
def test_plans_equal_jax(n):
    """coverage_and_fallback, plan_eval and plan_eval_tiles build JAX's
    arrays bit for bit, incl. forced-fallback and margin-shell points; the
    tile plan's CSR offsets index its sorted items."""
    rest, _ = _smooth_rig(n)
    patches = jpu.build_patches(rest, patch_size=64)
    q = np.concatenate([_queries(400), _shell(patches, min(3, len(patches.radii)))])
    per_w, cov_w, (un_w, pick_w) = jpu.coverage_and_fallback(patches, q)
    per_g, cov_g, (un_g, pick_g) = pu.coverage_and_fallback(patches, q)
    assert len(per_g) == len(per_w)
    for a, b in zip(per_g, per_w):
        np.testing.assert_array_equal(a, b)
    for a, b in ((cov_g, cov_w), (un_g, un_w), (pick_g, pick_w)):
        np.testing.assert_array_equal(a, b)
    assert un_g.size >= 2  # the far points and the shell take the fallback
    ep_w, ep_g = jpu.plan_eval(patches, q), pu.plan_eval(patches, q)
    for f in ("tiles_patch", "tiles_vidx", "forced"):
        np.testing.assert_array_equal(getattr(ep_g, f), getattr(ep_w, f), err_msg=f)
    assert ep_g.num_points == ep_w.num_points
    tp_w, tp_g = jpallas.plan_eval_tiles(patches, q), cuda_pu.plan_eval_tiles(patches, q)
    for f in ("item_patch", "item_vt", "forced_patch", "perm", "inv_perm"):
        np.testing.assert_array_equal(getattr(tp_g, f), getattr(tp_w, f), err_msg=f)
    assert (tp_g.num_points, tp_g.tile_v) == (tp_w.num_points, tp_w.tile_v)
    off = tp_g.item_offsets
    n_vt = tp_g.forced_patch.shape[0] // tp_g.tile_v
    assert off.shape == (n_vt + 1,) and off[0] == 0 and off[-1] == len(tp_g.item_vt)
    for t in range(n_vt):
        assert (tp_g.item_vt[off[t]:off[t + 1]] == t).all() and off[t + 1] > off[t]
    arrs = tp_g.device_arrays("cpu")
    assert arrs is tp_g.device_arrays("cpu")  # copied once per device
    assert all(a.dtype == torch.int32 for a in arrs)


def test_lru_cache_policy():
    cache: dict = {}
    for i in range(10):
        pu._lru_put(cache, i, str(i))
    assert list(cache) == [2, 3, 4, 5, 6, 7, 8, 9]
    assert pu._lru_hit(cache, 2) == "2" and list(cache)[-1] == 2
    assert pu._lru_hit(cache, 0) is None


# ----------------------------------------------------------------------- solve
@pytest.mark.parametrize("gmres_ir", [False, True])
def test_refined_against_df_batched_matches_jax(gmres_ir):
    """The batched solve (stationary or GMRES-IR) equals a per-system loop,
    sits within 1e-12 (relative) of a float64 solve of the split system,
    and within 1e-7 of JAX's lu_solve_refined_against_df, whose
    double-float residual loses ~1 ulp per transform on XLA:CPU (2e-8
    measured here)."""
    rest, _ = _smooth_rig(300)
    patches = jpu.build_patches(rest, patch_size=64)
    k_, p_ = patches.idx.shape
    safe = np.maximum(patches.idx, 0)
    valid = (patches.idx >= 0).astype(np.float32)
    rng = np.random.default_rng(3)
    rhs = rng.standard_normal((k_, p_, 6)).astype(np.float32)
    t = torch.as_tensor
    a_hi, a_lo, _ = pu._assemble_patch(
        t(rest[safe]), t(valid), t(patches.centers), K.THIN_PLATE, T.LINEAR,
        t(2.0 * patches.spacing), t(np.full((k_, p_), 1e-5, np.float32)))
    b = torch.cat([t(rhs) * t(valid)[..., None], torch.zeros(k_, 4, 6)], dim=1)
    (x_hi, x_lo), rep = solve.lu_solve_refined_against_df(a_hi, a_lo, b, gmres_ir=gmres_ir)
    assert x_hi.shape == (k_, p_ + 4, 6) and rep.col_backward.shape == (k_, 6)
    assert float(rep.backward_error().max()) < 1e-12
    for i in (0, k_ - 1):
        (y_hi, y_lo), r1 = solve.lu_solve_refined_against_df(a_hi[i], a_lo[i], b[i],
                                                            gmres_ir=gmres_ir)
        np.testing.assert_array_equal(x_hi[i].numpy(), y_hi.numpy())
        np.testing.assert_array_equal(x_lo[i].numpy(), y_lo.numpy())
        (j_hi, j_lo), _ = jsolve.lu_solve_refined_against_df(
            jnp.asarray(a_hi[i].numpy()), jnp.asarray(a_lo[i].numpy()),
            jnp.asarray(b[i].numpy()), gmres_ir=gmres_ir)
        x = (x_hi[i].double() + x_lo[i].double()).numpy()
        exact = torch.linalg.solve(a_hi[i].double() + a_lo[i].double(), b[i].double()).numpy()
        assert np.abs(x - exact).max() <= 1e-12 * np.abs(exact).max()
        want = np.asarray(j_hi, np.float64) + np.asarray(j_lo, np.float64)
        assert np.abs(x - want).max() <= 1e-7 * np.abs(want).max()


# ------------------------------------------------------------------------ fit
@pytest.mark.parametrize("eps,confidence", [("auto", False), ("auto", True),
                                            (0.5, False), (0.5, True)])
def test_fit_pu_matches_jax(eps, confidence):
    """fit_pu: stationary refinement (eps='auto') and GMRES-IR (forced eps),
    with a ridge and per-marker confidence: the port's weights (hi + lo)
    match JAX's to 1e-6 relative (JAX's double-float assembly sits ~5e-9
    off float64 on XLA:CPU, measured), and both reports are healthy."""
    rest, disp, patches, jmodel, jrep, conf = _jax_fit(eps=eps, lam=1e-4, confidence=confidence)
    model, rep = pu.fit_pu(rest, rest + disp, K.THIN_PLATE, T.LINEAR, eps=eps, lam=1e-4,
                           patches=pu.PUPatches(*patches), confidence=conf, device="cpu")
    for hi, lo in (("w_hi", "w_lo"), ("poly_hi", "poly_lo")):
        got = getattr(model, hi).double() + getattr(model, lo).double()
        want = (np.asarray(getattr(jmodel, hi), np.float64)
                + np.asarray(getattr(jmodel, lo), np.float64))
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max(), hi
    for f in ("centers", "radii", "ctrl", "valid", "eps"):
        np.testing.assert_array_equal(getattr(model, f).numpy(), np.asarray(getattr(jmodel, f)))
    assert float(rep.backward_error()) < 1e-9 and float(jrep.backward_error()) < 1e-9
    assert rep.col_backward.shape == (3,) and float(rep.col_backward.max()) < 1e-9


def test_fit_pu_frames_matches_jax_and_single_fits():
    """fit_pu_frames (one factorization, 3F columns in 3-column blocks):
    every frame's weights (hi + lo) equal the port's own single-pose
    fit_pu's to 1e-12 relative (both converge to the float64 solution;
    the hi/lo split may differ by an ulp when a threaded LAPACK factors
    the batch differently), and JAX's fit_pu_frames' to 1e-6."""
    rng = np.random.default_rng(1)
    rest = fibonacci_points(500)
    frames = rest + 0.05 * rng.standard_normal((3, 500, 3)).astype(np.float32)
    patches = jpu.build_patches(rest, patch_size=64)
    conf = np.linspace(0.5, 1.0, 500).astype(np.float32)
    jmodels, jrep = jpu.fit_pu_frames(rest, frames, K.THIN_PLATE, T.LINEAR, lam=0.01,
                                      patches=patches, confidence=conf)
    models, rep = pu.fit_pu_frames(rest, frames, K.THIN_PLATE, T.LINEAR, lam=0.01,
                                   patches=pu.PUPatches(*patches), confidence=conf,
                                   device="cpu")
    assert len(models) == 3 and rep.col_backward.shape == (9,)
    assert float(rep.backward_error()) < 1e-9
    for f in range(3):
        single, _ = pu.fit_pu(rest, frames[f], K.THIN_PLATE, T.LINEAR, lam=0.01,
                              patches=pu.PUPatches(*patches), confidence=conf, device="cpu")
        for name in ("centers", "radii", "ctrl", "valid", "eps"):
            np.testing.assert_array_equal(getattr(models[f], name).numpy(),
                                          getattr(single, name).numpy(), err_msg=name)
        for hi, lo in (("w_hi", "w_lo"), ("poly_hi", "poly_lo")):
            got = (getattr(models[f], hi).double() + getattr(models[f], lo).double()).numpy()
            one = (getattr(single, hi).double() + getattr(single, lo).double()).numpy()
            assert np.abs(got - one).max() <= 1e-12 * np.abs(one).max(), hi
        got = (models[f].w_hi.double() + models[f].w_lo.double()).numpy()
        want = np.asarray(jmodels[f].w_hi, np.float64) + np.asarray(jmodels[f].w_lo, np.float64)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_fit_chunking_does_not_change_the_model():
    """Patches solve independently: chunks of 3 give the weights (hi + lo)
    of one batch to 1e-12 relative (a threaded LAPACK may factor batches of
    other sizes an ulp apart)."""
    rest, disp = _smooth_rig(600)
    a, ra = pu.fit_pu(rest, rest + disp, patch_size=64, lam=1e-5, device="cpu")
    b, rb = pu.fit_pu(rest, rest + disp, patch_size=64, lam=1e-5, chunk=3, device="cpu")
    for hi, lo in (("w_hi", "w_lo"), ("poly_hi", "poly_lo")):
        x = (getattr(a, hi).double() + getattr(a, lo).double()).numpy()
        y = (getattr(b, hi).double() + getattr(b, lo).double()).numpy()
        assert np.abs(x - y).max() <= 1e-12 * np.abs(x).max()
    assert float(ra.backward_error()) < 1e-12 and float(rb.backward_error()) < 1e-12


@pytest.mark.parametrize("kernel,term", [(K.THIN_PLATE, T.LINEAR), (K.GAUSSIAN, T.LINEAR),
                                         (K.MULTIQUADRIC, T.CONSTANT), (K.WENDLAND_C2, T.ZERO)])
def test_interpolation_at_controls(kernel, term):
    """A small ridge interpolates the controls within the budget through
    both eval routes (plain f32 and the tile kernel's twin)."""
    rest, disp = _smooth_rig(800)
    d = pu.PUDeformer.fit(rest, rest + disp, kernel=kernel, term=term, lam=1e-6,
                          patch_size=64, device="cpu")
    assert float(d.report.backward_error()) < 1e-9
    for backend in ("plain", "cuda"):
        err = np.abs(d.displacement(rest, backend=backend).numpy() - disp).max()
        assert err < BUDGET, (backend, err)


# ----------------------------------------------------------------------- eval
@pytest.mark.parametrize("kernel,eps,precise", [
    (K.THIN_PLATE, "auto", False), (K.THIN_PLATE, 0.5, True),
    (K.GAUSSIAN, "auto", True), (K.MULTIQUADRIC, 0.5, True)])
def test_evaluate_pu_matches_jax(kernel, eps, precise):
    """evaluate_pu on a JAX-fitted model carried over by convert, same plan:
    f32 (decaying kernels are f32 even when precise) to 1e-6; the port's
    float64 tiles against JAX's double-float, which on XLA:CPU loses ~1 ulp
    per transform (PERF.md, Findings), to 1e-5."""
    rest, _, patches, jmodel, _, _ = _jax_fit(kernel=kernel, eps=eps)
    q = _queries()
    plan = jpu.plan_eval(patches, q)
    want = np.asarray(jpu.evaluate_pu(
        jmodel, jnp.asarray(q), jnp.asarray(plan.tiles_patch), jnp.asarray(plan.tiles_vidx),
        jnp.asarray(plan.forced), kernel, T.LINEAR, plan.num_points, precise=precise))
    got = pu.evaluate_pu(_port_model(jmodel), torch.as_tensor(q), plan.tiles_patch,
                         plan.tiles_vidx, plan.forced, kernel, T.LINEAR, plan.num_points,
                         precise=precise).numpy()
    tol = 1e-5 if precise and kernel != K.GAUSSIAN else F32_TOL
    assert np.abs(got - want).max() <= tol
    assert np.isfinite(got).all()


def _f64_field(model, q, kernel, term):
    """The PU field in float64, written out: every patch whose support
    holds the point (0.9999 margin), else the nearest patch relative to
    its radius, with the JAX package's phi definitions, on the f32
    patch-centered coordinates the fit assembled its systems from."""
    m = {f: getattr(model, f).double().numpy() for f in model._fields}
    c32 = model.centers.numpy()
    l32 = ((model.ctrl.numpy() - c32[:, None]) * model.valid.numpy()[..., None]).astype(np.float64)
    w = m["w_hi"] + m["w_lo"]
    pl = m["poly_hi"] + m["poly_lo"]
    out = np.zeros((len(q), 3))
    for i, x in enumerate(q.astype(np.float64)):
        r = np.linalg.norm(x.astype(np.float32) - c32, axis=1).astype(np.float64)
        ks = np.nonzero(r <= m["radii"])[0]
        if not (r[ks] <= 0.9999 * m["radii"][ks]).any():
            ks = np.asarray([int(np.argmin(r / m["radii"]))])
            forced = True
        else:
            forced = False
        num, den = np.zeros(3), 0.0
        for k in ks:
            xl = (x.astype(np.float32) - c32[k]).astype(np.float64)
            lc = l32[k]
            s = ((xl - lc) ** 2).sum(-1) / m["eps"][k] ** 2
            if kernel == K.THIN_PLATE:
                phi = np.where(s > 0, 0.5 * s * np.log(np.maximum(s, 1e-300)), 0.0)
            elif kernel == K.MULTIQUADRIC:
                phi = np.sqrt(1.0 + s)
            else:
                phi = np.exp(-s)
            sk = (phi * m["valid"][k]) @ w[k]
            if term == T.LINEAR:
                sk = sk + pl[k][0] + xl @ pl[k][1:4]
            t = np.sqrt((xl ** 2).sum()) / m["radii"][k]
            wk = 1.0 if forced else max(1.0 - t, 0.0) ** 4 * (4.0 * t + 1.0)
            num, den = num + wk * sk, den + wk
        out[i] = num / den
    return out


@pytest.mark.parametrize("kernel", [K.THIN_PLATE, K.MULTIQUADRIC])
def test_precise_eval_matches_float64_composition(kernel):
    """The forced-eps (flat, cancelling) growing-kernel fit: the float64
    tiles sit within 1e-6 of a float64 composition of the same weights,
    which the f32 tiles miss (the reason precise=True is the default)."""
    rest, _, patches, jmodel, _, _ = _jax_fit(kernel=kernel, eps=0.5)
    d = pu.PUDeformer(_port_model(jmodel), pu.PUPatches(*patches), kernel, T.LINEAR,
                      auto_eps=False)
    q = _queries(120)
    want = _f64_field(d.model, q, kernel, T.LINEAR)
    got = d.displacement(q).numpy()                      # precise by default
    assert np.abs(got - want).max() <= F64_TOL
    f32 = d.displacement(q, precise=False, backend="plain").numpy()
    assert np.abs(f32 - want).max() > F64_TOL


def test_f32_eval_matches_float64_with_auto_eps():
    """eps='auto' keeps the local bases well conditioned: the f32 tiles, the
    tile kernel's twin and the float64 tiles agree to 5e-6 (JAX's own
    bound for f32 vs double-float tiles)."""
    rest, disp = _smooth_rig(1200)
    d = pu.PUDeformer.fit(rest, rest + disp, kernel=K.THIN_PLATE, patch_size=64,
                          lam=1e-5, device="cpu")
    q = _queries(300)[:300]  # near the rig: far extrapolation grows TPS values
    slow = d.displacement(q, precise=True).numpy()
    for backend in ("plain", "cuda"):
        np.testing.assert_allclose(d.displacement(q, backend=backend).numpy(), slow, atol=5e-6)


@pytest.mark.parametrize("kernel,term", [(K.THIN_PLATE, T.LINEAR), (K.GAUSSIAN, T.CONSTANT),
                                         (K.MULTIQUADRIC, T.ZERO)])
def test_tiles_twin_matches_pallas_interpret(kernel, term):
    """evaluate_pu_tiles (the twin on CPU tensors) and the frames entry
    against pallas_pu in interpret mode on the same model, plan and
    points, incl. forced-fallback and margin-shell points: the same
    arithmetic up to the contraction's summation order.  Held to 1e-5, JAX's
    own bound for Mosaic vs XLA (tests/test_pu.py): at the far fallback
    point (5, 5, 5) TPS extrapolates through heavily cancelling terms, and
    there both sides sit ~3e-6 from the float64 tiles; near the rig the
    twin is held to the float64 tiles at 2e-6 of max|disp|."""
    rest, _, patches, jm, _, _ = _jax_fit(kernel=kernel, term=term)
    q = np.concatenate([_queries(300), _shell(patches)])
    tplan = jpallas.plan_eval_tiles(patches, q)
    jargs = (jnp.asarray(q), *tplan.device_arrays(), kernel, term, tplan.num_points,
             tplan.tile_v)
    want = np.asarray(jpallas.evaluate_pu_tiles(jm, *jargs, interpret=True))
    pplan = cuda_pu.plan_eval_tiles(pu.PUPatches(*patches), q)
    pargs = (torch.as_tensor(q), pplan, kernel)
    model = _port_model(jm)
    launches = (profiling.counter("launches.evaluate_pu_tiles"),
                profiling.counter("launches.evaluate_pu_tiles_frames"))
    got = cuda_pu.evaluate_pu_tiles(model, *pargs).numpy()
    assert np.abs(got - want).max() <= 1e-5
    near = slice(0, 300)
    f64 = pu.evaluate_pu(model, torch.as_tensor(q), *_plain_plan(patches, q), kernel, term,
                         len(q), precise=True).numpy()
    if kernel in (K.THIN_PLATE, K.MULTIQUADRIC):  # float64 tiles: growing kernels
        assert np.abs(got[near] - f64[near]).max() <= TWIN_TOL * np.abs(f64[near]).max()
    # frames: model, -0.5 x model, and 2 x model in one pass
    scaled = [model._replace(w_hi=model.w_hi * s, w_lo=model.w_lo * s,
                             poly_hi=model.poly_hi * s, poly_lo=model.poly_lo * s)
              for s in (1.0, -0.5, 2.0)]
    jscaled = [jm._replace(w_hi=jm.w_hi * s, w_lo=jm.w_lo * s, poly_hi=jm.poly_hi * s,
                           poly_lo=jm.poly_lo * s) for s in (1.0, -0.5, 2.0)]
    want_f = np.asarray(jpallas.evaluate_pu_tiles_frames(tuple(jscaled), *jargs,
                                                          interpret=True))
    got_f = cuda_pu.evaluate_pu_tiles_frames(scaled, *pargs).numpy()
    assert got_f.shape == (3, len(q), 3)
    assert np.abs(got_f - want_f).max() <= 2e-5
    np.testing.assert_array_equal(got_f[0], got)       # frames share phi and weights
    assert (profiling.counter("launches.evaluate_pu_tiles"),
            profiling.counter("launches.evaluate_pu_tiles_frames")) == launches  # CPU: the twin


def test_jacobian_pu_matches_jax_and_differences():
    """jacobian_pu vs JAX on a carried-over model (1e-5 relative) and vs a
    central difference of the port's float64 field (1e-3 relative: an f32
    Jacobian of a ~0.1 field)."""
    rest, _, patches, jm, _, _ = _jax_fit(kernel=K.GAUSSIAN)
    q = _queries(200)
    plan = jpu.plan_eval(patches, q)
    want = np.asarray(jpu.jacobian_pu(
        jm, jnp.asarray(q), jnp.asarray(plan.tiles_patch), jnp.asarray(plan.tiles_vidx),
        jnp.asarray(plan.forced), K.GAUSSIAN, T.LINEAR, plan.num_points))
    d = pu.PUDeformer(_port_model(jm), pu.PUPatches(*patches), K.GAUSSIAN, T.LINEAR)
    got = d.jacobian(q).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    h = 1e-3
    sub = q[:40].astype(np.float64)
    fd = np.zeros((40, 3, 3))
    for b in range(3):
        step = np.zeros(3)
        step[b] = h
        fd[:, :, b] = (_f64_field(d.model, sub + step, K.GAUSSIAN, T.LINEAR)
                       - _f64_field(d.model, sub - step, K.GAUSSIAN, T.LINEAR)) / (2 * h)
    assert np.abs(got[:40] - fd).max() <= 1e-3 * scale


# -------------------------------------------------------------------- facades
def test_apply_seq_matches_jax():
    """PUSeqDeformer.apply_seq (capture d2, gate, tangent frame) on JAX
    models carried over, against JAX's apply_seq and against its own plain
    composition (displacement_frames, projection, falloff)."""
    from facedeform_tpu_torch.ops.falloff import falloff_weight
    from facedeform_tpu_torch.ops.tangent import project_to_tangents

    rng = np.random.default_rng(2)
    rest, disp = _smooth_rig(400)
    frames = np.stack([rest + disp * s for s in (1.0, -0.5, 0.25)])
    jseq = jpu.PUSeqDeformer.fit(rest, frames, lam=1e-5, patch_size=64)
    seq = pu.PUSeqDeformer([_port_model(m) for m in (p.model for p in jseq.puds)],
                           pu.PUPatches(*jseq.patches), jseq.kernel, jseq.term)
    q = _queries(250)[:250]  # near the rig (f32 extrapolation far away is loose in both)
    v = len(q)
    d2 = np.abs(0.8 * rng.standard_normal(v)).astype(np.float32)
    gate = (rng.uniform(size=v) > 0.2).astype(np.float32)
    frame = tuple(rng.standard_normal((v, 3)).astype(np.float32) for _ in range(3))
    jc, params = jcfg.DeformConfig(tangent=True), jcfg.DeformParams(radius=1.1,
                                                                     falloffrate=1.5)
    want, want_w = jseq.apply_seq(q, d2, gate, jc, params, frame=frame)
    cfg, prm = DeformConfig(tangent=True), DeformParams(radius=1.1, falloffrate=1.5)
    got, got_w = seq.apply_seq(q, d2, gate, cfg, prm, frame=frame)
    assert got.shape == (3, v, 3)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-7)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= F32_TOL
    w, _ = falloff_weight(torch.as_tensor(d2), 1.1, 1.5)
    disp = seq.displacement_frames(q)
    t = [torch.as_tensor(f) for f in frame]
    plain = torch.as_tensor(q)[None] + torch.stack(
        [project_to_tangents(*t, disp[f]) for f in range(3)]) * (w * torch.as_tensor(gate))[None, :, None]
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    # without cfg.tangent the frame is ignored
    got_nt, _ = seq.apply_seq(q, d2, gate, DeformConfig(), prm, frame=frame)
    base, _ = seq.apply_seq(q, d2, gate, DeformConfig(), prm)
    np.testing.assert_array_equal(got_nt.numpy(), base.numpy())
    assert len(seq.puds[0].plans) == 1 and seq.puds[2].plans is seq.puds[0].plans


def test_seq_frames_equal_single_pose_models():
    """displacement_frames equals each frame's PUDeformer.displacement; at
    lam = 0 every frame interpolates its controls."""
    rng = np.random.default_rng(4)
    rest = fibonacci_points(300)
    frames = rest + 0.04 * rng.standard_normal((2, 300, 3)).astype(np.float32)
    seq = pu.PUSeqDeformer.fit(rest, frames, lam=0.0, patch_size=64, device="cpu")
    out = seq.displacement_frames(rest)
    for f in range(2):
        np.testing.assert_array_equal(out[f].numpy(), seq.puds[f].displacement(rest).numpy())
        assert np.abs(out[f].numpy() - (frames[f] - rest)).max() < BUDGET


def test_no_seam_at_coverage_boundary():
    rest, disp = _smooth_rig(60)
    d = pu.PUDeformer.fit(rest, rest + disp, patch_size=192, lam=1e-6, device="cpu")
    c = d.model.centers[0].numpy()
    r = float(d.model.radii[0])
    ray = np.float32([0, 1, 0])
    qs = np.stack([c + ray * r * (1.0 - 1e-3), c + ray * r * (1.0 - 1e-7),
                   c + ray * r * (1.0 + 1e-3)]).astype(np.float32)
    for backend in ("plain", "cuda"):
        out = d.displacement(qs, backend=backend).numpy()
        assert np.abs(out[1] - out[0]).max() < 1e-4
        assert np.abs(out[2] - out[1]).max() < 1e-4


def test_plan_cache_not_fooled_by_prefix():
    rest, disp = _smooth_rig(600)
    d = pu.PUDeformer.fit(rest, rest + disp, patch_size=64, lam=1e-5, device="cpu")
    q1 = (fibonacci_points(200) * 1.01).astype(np.float32)
    q2 = q1.copy()
    q2[100:] += np.float32([5, 5, 5])          # same prefix, moved tail
    out1 = d.displacement(q1).numpy()
    out2 = d.displacement(q2).numpy()
    assert len(d.plans) == 2
    fresh = pu.PUDeformer(d.model, d.patches, d.kernel, d.term)
    np.testing.assert_array_equal(out2, fresh.displacement(q2).numpy())
    assert np.abs(out1[:100] - out2[:100]).max() < 1e-6


def test_plan_type_selects_path():
    rest, disp = _smooth_rig(600)
    d = pu.PUDeformer.fit(rest, rest + disp, patch_size=64, lam=1e-5, device="cpu")
    q = (fibonacci_points(300) * 1.01).astype(np.float32)
    tplan = d.make_plan(q, backend="cuda")
    eplan = d.make_plan(q)           # a CPU model: "auto" is the plain route
    assert isinstance(tplan, cuda_pu.PUTilePlan) and isinstance(eplan, pu.PUEvalPlan)
    out_t = d.displacement(q, plan=tplan).numpy()
    out_x = d.displacement(q, plan=eplan, precise=False).numpy()
    np.testing.assert_allclose(out_t, out_x, atol=1e-5)
    np.testing.assert_array_equal(out_t, d.displacement(q, backend="cuda").numpy())
    with pytest.raises(ValueError, match="precise"):
        d.displacement(q, plan=tplan, precise=True)
    with pytest.raises(ValueError, match="plain"):
        d.displacement(q, plan=tplan, backend="plain")
    with pytest.raises(ValueError, match="stale plan"):
        d.displacement(q[:100], plan=tplan)
    with pytest.raises(ValueError, match="backend"):
        d.displacement(q, backend="xla")
    with pytest.raises(ValueError, match="PUEvalPlan"):
        d.jacobian(q, plan=tplan)
    forced = pu.PUDeformer(d.model, d.patches, d.kernel, d.term, auto_eps=False)
    with pytest.raises(ValueError, match="eps='auto'"):
        forced.make_plan(q, backend="cuda")
    assert isinstance(forced.make_plan(q), pu.PUEvalPlan)


def test_fit_argument_errors():
    rest, disp = _smooth_rig(300)
    with pytest.raises(ValueError, match="eps"):
        pu.fit_pu(rest, rest + disp, eps="spacing", patch_size=64, device="cpu")
    with pytest.raises(ValueError, match="lam > 0"):
        pu.fit_pu(rest, rest + disp, lam=0.0, confidence=np.ones(300), patch_size=64,
                  device="cpu")
    with pytest.raises(ValueError, match="must be"):
        pu.fit_pu_frames(rest, rest + disp, patch_size=64, device="cpu")


@pytest.mark.parametrize("entry", ["fit_pu", "fit_pu_frames", "PUDeformer.fit",
                                   "PUSeqDeformer.fit", "displacement_frames"])
def test_mesh_raises_slice_h(entry):
    rest, disp = _smooth_rig(100)
    calls = {
        "fit_pu": lambda: pu.fit_pu(rest, rest + disp, mesh=object(), device="cpu"),
        "fit_pu_frames": lambda: pu.fit_pu_frames(rest, (rest + disp)[None], mesh=object(),
                                                  device="cpu"),
        "PUDeformer.fit": lambda: pu.PUDeformer.fit(rest, rest + disp, mesh=object(),
                                                    device="cpu"),
        "PUSeqDeformer.fit": lambda: pu.PUSeqDeformer.fit(rest, (rest + disp)[None],
                                                          mesh=object(), device="cpu"),
        "displacement_frames": lambda: pu.PUSeqDeformer.fit(
            rest, (rest + disp)[None], device="cpu").displacement_frames(rest, mesh=object()),
    }
    with pytest.raises(NotImplementedError, match="slice H"):
        calls[entry]()


def test_deformer_fit_points_to_pu_deformer():
    rest = fibonacci_points(30)
    with pytest.raises(ValueError, match=r"ops\.pu\.PUDeformer\.fit"):
        Deformer.fit(rest, rest * 1.02, DeformConfig(solver="pu"), device="cpu")


def test_convert_round_trip_and_device_default():
    """convert carries a JAX PUModel/PUPatches over field for field; the
    entry points default to the card (device='cuda')."""
    import inspect

    _, _, patches, jm, _, _ = _jax_fit()
    model = _port_model(jm)
    for f in jm._fields:
        np.testing.assert_array_equal(getattr(model, f).numpy(), np.asarray(getattr(jm, f)))
    assert model.device.type == "cpu"
    got = convert.pu_patches_from_numpy(patches._asdict())
    for f in patches._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(patches, f))
        assert getattr(got, f).dtype == getattr(patches, f).dtype
    for fn in (pu.fit_pu, pu.fit_pu_frames, pu.PUDeformer.fit, pu.PUSeqDeformer.fit):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
