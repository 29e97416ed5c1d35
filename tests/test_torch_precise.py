"""PyTorch port: growing kernels (TPS/MQ/linear/cubic) in float64 against
the JAX package's double-float path (Pallas in interpret mode) and the
float64 oracle (tests/oracle.py): the split float64 assembly, GMRES and
GMRES-IR, the precise eval and its kernel's plain twin, the slice end to
end and the growing-kernel shot."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
import facedeform_tpu.deformer as jdef
from facedeform_tpu.geometry.primitives import fibonacci_points
from facedeform_tpu.ops import assemble as jassemble
from facedeform_tpu.ops import fit as jfit
from facedeform_tpu.ops import krylov as jkrylov
from facedeform_tpu.ops import precise_eval as jprecise
from facedeform_tpu.ops import solve as jsolve
from facedeform_tpu.ops.pallas_precise import evaluate_pallas_precise
from facedeform_tpu.parallel import batched as jbatched
from facedeform_tpu_torch import convert
from facedeform_tpu_torch.deformer import Deformer
from facedeform_tpu_torch.ops import assemble as tassemble
from facedeform_tpu_torch.ops import cuda_eval, cuda_precise, krylov, solve
from facedeform_tpu_torch.ops import fit as tfit
from facedeform_tpu_torch.ops import precise_eval as tprecise
from facedeform_tpu_torch.parallel import batched as tbatched
from facedeform_tpu_torch.utils import errors
from facedeform_tpu_torch.utils import profiling

import oracle

K = jcfg.RBFKernel
M = jcfg.RBFModelType
TERM = jcfg.PolyTerm.LINEAR
GROWING = [K.THIN_PLATE, K.MULTIQUADRIC, K.LINEAR, K.CUBIC]
PARAMS = jcfg.DeformParams(radius=1.0, lam=0.01)
BUDGET = 5e-5      # max displacement error vs the float64 oracle (BASELINE.md)
EVAL_TOL = 1e-6    # precise evals of the same weights, port vs JAX


def _cfg(kernel, **kw):
    return jcfg.DeformConfig(model=M.KERNEL, kernel=kernel, solver="direct", **kw)


def _port(jc, params=PARAMS):
    return (convert.config_from_fields(dataclasses.asdict(jc)),
            convert.params_from_fields(params._asdict()))


def _to_port(model):
    return convert.model_from_numpy(
        {f: np.asarray(getattr(model, f)) for f in model._fields
         if getattr(model, f) is not None}, device="cpu")


def _rig(n, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    rest = fibonacci_points(n)
    return rest, rest + scale * rng.standard_normal((n, 3)).astype(np.float32)


def _mesh(v, seed=1):
    """Points inside the rig's reach, capture d2 (some beyond radius 1, a
    few strict-parity sentinels), a group mask and a tangent frame."""
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((v, 3)) * 0.7).astype(np.float32)
    dist2 = np.abs(0.7 * rng.standard_normal(v)).astype(np.float32)
    dist2[::53] = -1.0
    mask = rng.uniform(size=v) > 0.2
    frame = tuple(rng.standard_normal((v, 3)).astype(np.float32) for _ in range(3))
    return pts, dist2, mask, frame


@functools.lru_cache(maxsize=None)
def _jax_fit(kernel, n):
    rest, deformed = _rig(n)
    return jdef.Deformer.fit(rest, deformed, _cfg(kernel), PARAMS)


# ---------------------------------------------------------------- assembly
def test_assemble_system_df_matches_jax_and_f64():
    n = 300
    rest = fibonacci_points(n)
    a_hi, a_lo = tassemble.assemble_system_df(
        torch.as_tensor(rest), K.MULTIQUADRIC, TERM, torch.full((n,), 1.0), 0.01)
    j_hi, j_lo = jassemble.assemble_system_df(
        jnp.asarray(rest), K.MULTIQUADRIC, TERM, jnp.full((n,), 1.0, jnp.float32),
        jnp.float32(0.01))
    got = a_hi.double().numpy() + a_lo.double().numpy()
    d2 = oracle.pairwise_sqdist(rest.astype(np.float64), rest.astype(np.float64))
    want = oracle.apply_kernel(K.MULTIQUADRIC, d2, 1.0) + 0.01 * np.eye(n)
    assert np.abs(got[:n, :n] - want).max() < 1e-9
    jax_pair = np.asarray(j_hi, np.float64) + np.asarray(j_lo, np.float64)
    assert np.abs(got - jax_pair).max() < 1e-9
    # tail rows/columns and the -1e-8 block: the f32 values of JAX's
    np.testing.assert_array_equal(a_hi[n:].numpy(), np.asarray(j_hi)[n:])
    np.testing.assert_array_equal(a_hi[:, n:].numpy(), np.asarray(j_hi)[:, n:])
    lo = a_lo.numpy().copy()
    lo[:n, :n] = 0.0
    assert not lo.any()                      # a_lo lives in the phi block only
    assert np.abs(a_lo[:n, :n].numpy()).max() > 0


@pytest.mark.parametrize("kernel", GROWING, ids=[k.name for k in GROWING])
def test_assemble_system_df_is_the_float64_system(kernel):
    """hi + lo is the float64 phi block to ~1e-15 for every growing kernel,
    with a per-marker ridge and a constant tail; hi is its f32 rounding."""
    n = 120
    rest = fibonacci_points(n)
    lam = np.linspace(0.01, 0.1, n).astype(np.float32)
    a_hi, a_lo = tassemble.assemble_system_df(
        torch.as_tensor(rest), kernel, jcfg.PolyTerm.CONSTANT, 0.8, torch.as_tensor(lam))
    assert tuple(a_hi.shape) == (n + 1, n + 1)
    d2 = oracle.pairwise_sqdist(rest.astype(np.float64), rest.astype(np.float64))
    want = oracle.apply_kernel(kernel, d2, np.float64(np.float32(0.8))) + np.diag(
        lam.astype(np.float64))
    got = a_hi.double().numpy()[:n, :n] + a_lo.double().numpy()[:n, :n]
    assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()
    np.testing.assert_array_equal(a_hi[:n, :n].numpy(), want.astype(np.float32))
    np.testing.assert_array_equal(a_hi[n:].numpy()[0, :n], np.ones(n, np.float32))


# ------------------------------------------------------------------ GMRES
def _nonsym(n, seed):
    rng = np.random.default_rng(seed)
    a = np.eye(n) * 2.0 + rng.standard_normal((n, n)) / np.sqrt(n)
    return a.astype(np.float32)


@pytest.mark.parametrize("k", [3, 6])
def test_gmres_matches_jax(k):
    n = 200
    a = _nonsym(n, seed=k)
    rng = np.random.default_rng(10 + k)
    b = rng.standard_normal((n, k)).astype(np.float32)
    b[:, -1] = 0.0                                       # a zero column
    # a rough preconditioner: the inverse of a's diagonal
    dinv = (1.0 / np.diag(a)).astype(np.float32)
    a_t, d_t = torch.as_tensor(a), torch.as_tensor(dinv)
    a_j, d_j = jnp.asarray(a), jnp.asarray(dinv)

    def jmatvec(v):
        return jnp.dot(a_j, v, precision="highest")

    def jmsolve(v):
        return d_j[:, None] * v

    x, report = krylov.gmres(lambda v: a_t @ v, torch.as_tensor(b),
                             msolve=lambda v: d_t[:, None] * v, restart=16, max_restarts=4)
    xj, rj = jkrylov.gmres(jmatvec, jnp.asarray(b), msolve=jmsolve, restart=16,
                           max_restarts=4)
    x, xj = x.numpy(), np.asarray(xj)
    want = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    scale = np.abs(want).max()
    assert np.abs(x - xj).max() <= 1e-5 * scale
    assert np.abs(x - want).max() <= 1e-5 * scale
    assert np.isfinite(x).all() and not x[:, -1].any()   # zero column stays zero
    assert report.cond_est is None
    assert float(report.backward_error()) < 1e-6
    np.testing.assert_allclose(report.col_backward.numpy(), np.asarray(rj.col_backward),
                               atol=1e-7)


def test_gmres_warm_start_and_restart_limit():
    """GMRES starts cold at x = 0 (no warm start); max_restarts bounds the
    cycles: 0 returns zeros after one residual product, each cycle costs
    restart + 2 operator products, and a converged solve stops early."""
    n = 120
    a = torch.as_tensor(_nonsym(n, seed=3))
    b = torch.as_tensor(np.random.default_rng(4).standard_normal((n, 3)).astype(np.float32))
    calls = []

    def counted(v):
        calls.append(1)
        return a @ v

    def ident(v):
        return v

    x0, _ = krylov.gmres(counted, b, ident, max_restarts=0)
    assert not x0.any() and len(calls) == 1               # the final residual only
    calls.clear()
    x1, _ = krylov.gmres(counted, b, ident, restart=4, max_restarts=1)
    assert len(calls) == 4 + 2 + 1                        # one cycle, then the report
    calls.clear()
    x, report = krylov.gmres(counted, b, ident, tol=1e-4, restart=32, max_restarts=16)
    assert len(calls) <= 2 * (32 + 2) + 1                 # converged well before the limit
    assert float(report.backward_error()) < 1e-4
    assert float((a @ x1 - b).norm()) > float((a @ x - b).norm())


# ---------------------------------------------------------------- GMRES-IR
def _mq_system(n, seed=0):
    rest = fibonacci_points(n)
    delta = 0.05 * np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32)
    a_hi, a_lo = tassemble.assemble_system_df(
        torch.as_tensor(rest), K.MULTIQUADRIC, TERM, torch.full((n,), 1.0), 0.01)
    b = tassemble.assemble_rhs(torch.as_tensor(delta), TERM)
    return a_hi, a_lo, b


def test_gmres_ir_forward_accuracy_beside_jax():
    """GMRES-IR against the split float64 matrix converges the forward
    error (n = 512 MQ, cond ~1e6), in the port and in JAX on the same
    a_hi, a_lo, b."""
    a_hi, a_lo, b = _mq_system(512)
    a64 = a_hi.double().numpy() + a_lo.double().numpy()
    x_true = np.linalg.solve(a64, b.double().numpy())
    (xh, xl), report = solve.lu_solve_refined_against_df(a_hi, a_lo, b, n_refine=3)
    xf = xh.double().numpy() + xl.double().numpy()
    assert np.abs(xf - x_true).max() / np.abs(x_true).max() < 1e-5
    assert float(report.backward_error()) < 1e-6
    (jh, jl), jr = jsolve.lu_solve_refined_against_df(
        jnp.asarray(a_hi.numpy()), jnp.asarray(a_lo.numpy()), jnp.asarray(b.numpy()),
        n_refine=3)
    jf = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    assert np.abs(jf - x_true).max() / np.abs(x_true).max() < 1e-5
    assert float(jr.backward_error()) < 1e-6
    assert tuple(report.col_backward.shape) == (3,)


def test_resolve_faces_reuse_the_factors():
    """The resolve faces against precomputed factors give the factoring
    faces' results bit for bit; wide right-hand sides refine in 3-column
    blocks (a 7-column b equals its blocks solved one by one)."""
    a_hi, a_lo, b = _mq_system(160)
    lu_piv = solve.lu_factor_hp(a_hi)
    one = solve.lu_solve_refined_against_df(a_hi, a_lo, b)
    two = solve.lu_resolve_refined_against_df(lu_piv, a_hi, a_lo, b)
    assert all(torch.equal(p, q) for p, q in zip(one[0], two[0]))
    df1 = solve.lu_solve_refined_df(a_hi, b)
    df2 = solve.lu_resolve_refined_df(lu_piv, a_hi, b)
    assert all(torch.equal(p, q) for p, q in zip(df1[0], df2[0]))
    wide = torch.cat([b, 2 * b, b[:, :1]], dim=1)                  # 7 columns
    (wh, wl), _ = solve.lu_resolve_refined_against_df(lu_piv, a_hi, a_lo, wide)
    for lo, hi in ((0, 3), (3, 6), (6, 7)):
        (bh, bl), _ = solve.lu_resolve_refined_against_df(lu_piv, a_hi, a_lo, wide[:, lo:hi])
        assert torch.equal(wh[:, lo:hi], bh) and torch.equal(wl[:, lo:hi], bl)
    # and the refined pair converges on this well-conditioned system
    xf = one[0][0].double() + one[0][1].double()
    x_true = torch.linalg.solve(a_hi.double() + a_lo.double(), b.double())
    assert float((xf - x_true).abs().max() / x_true.abs().max()) < 1e-5


# ------------------------------------------------------------ precise eval
def test_evaluate_precise_tps_matches_jax():
    jd = _jax_fit(K.THIN_PLATE, 300)
    pts = np.random.default_rng(2).standard_normal((700, 3)).astype(np.float32)
    want = np.asarray(jprecise.evaluate_precise(jd.model, jnp.asarray(pts), K.THIN_PLATE, TERM))
    model = _to_port(jd.model)
    assert model.w_rbf_lo is not None and model.w_poly_lo is not None
    got = tprecise.evaluate_precise(model, torch.as_tensor(pts), K.THIN_PLATE, TERM)
    np.testing.assert_allclose(got.numpy(), want, atol=EVAL_TOL)
    # the lo words count: dropping them moves the field
    bare = tfit.RBFModel(ctrl=model.ctrl, w_rbf=model.w_rbf, w_poly=model.w_poly,
                         eps=model.eps)
    bare_disp = tprecise.evaluate_precise(bare, torch.as_tensor(pts), K.THIN_PLATE, TERM)
    assert not torch.equal(bare_disp, got)


def test_evaluate_precise_multilayer_and_chunking_matches_jax():
    """A 3-layer gaussian model through V-chunks (chunk 512 < V = 1200),
    against JAX's evaluate_precise and the float64 oracle of the same
    weights.  JAX promotes an f32 phi to double-float for decaying kernels,
    so it sits ~u sum|w phi| (3.7e-6 here, sum|w| ~2.5e3) from float64:
    the port is held to JAX at the 1e-5 JAX's own test holds it to the
    oracle, and to the oracle at 1e-6."""
    rest, deformed = _rig(128, seed=3, scale=0.1)
    jc = jcfg.DeformConfig(model=M.MULTILAYER, layers=3)
    jd = jdef.Deformer.fit(rest, deformed, jc, PARAMS)
    pts = np.random.default_rng(4).standard_normal((1200, 3)).astype(np.float32)
    want = np.asarray(jprecise.evaluate_precise(jd.model, jnp.asarray(pts), K.GAUSSIAN, TERM))
    model = _to_port(jd.model)
    got = tprecise.evaluate_precise(model, torch.as_tensor(pts), K.GAUSSIAN, TERM, chunk=512)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    whole = tprecise.evaluate_precise(model, torch.as_tensor(pts), K.GAUSSIAN, TERM)
    assert torch.equal(got, whole)
    w = model.w_rbf.double().numpy() + model.w_rbf_lo.double().numpy()
    wp = model.w_poly.double().numpy() + model.w_poly_lo.double().numpy()
    ref = oracle.evaluate(rest.astype(np.float64), w, wp, model.eps.double().numpy(),
                          pts, K.GAUSSIAN, TERM)
    assert np.abs(got.numpy() - ref).max() < 1e-6


REF_CASES = [(k, s) for k in (K.THIN_PLATE, K.MULTIQUADRIC) for s in (False, True)]
# evaluate_pallas_precise in interpret mode runs its double-float on
# XLA:CPU, which loses ~1 ulp per error-free transform (tests/test_precise.py
# pins that): measured 1.2e-7 from float64 on this TPS model and 6.7e-6 on
# the MQ one (sum|w| 1.3e4, the df sqrt), x the falloff's 2.8 amplification
# under strict parity.  The float64 composition of the same weights holds
# the port to 1e-6; JAX is held to it at the CPU accuracy it has.
PALLAS_CPU_TOL = {K.THIN_PLATE: EVAL_TOL, K.MULTIQUADRIC: BUDGET}


def _precise64(model, pts, dist2, gate, kernel, strict, frame):
    """Float64 composition: the field of w_hi + w_lo, tangent projection,
    falloff (radius 1, rate 1.5) times the gate."""
    w = model.w_rbf.double().numpy() + model.w_rbf_lo.double().numpy()
    wp = model.w_poly.double().numpy() + model.w_poly_lo.double().numpy()
    disp = oracle.evaluate(model.ctrl.double().numpy(), w, wp, model.eps.double().numpy(),
                           pts, kernel, TERM)
    disp = oracle.project_to_tangents(*frame, disp)
    fall, _ = oracle.falloff_weight(dist2, 1.0, 1.5, strict)
    return pts + disp * (fall * gate)[:, None], fall * gate


@pytest.mark.parametrize("kernel,strict", REF_CASES,
                         ids=[f"{k.name}-{'strict' if s else 'clamped'}" for k, s in REF_CASES])
def test_precise_reference_matches_pallas(kernel, strict):
    """The precise kernel's plain twin (what evaluate_cuda_precise runs on
    CPU tensors) against evaluate_pallas_precise in interpret mode and a
    float64 composition, with capture distances, a group gate and a
    tangent frame."""
    jd = _jax_fit(kernel, 300)
    pts, dist2, mask, frame = _mesh(700)
    gate = mask.astype(np.float32)
    want, want_w = evaluate_pallas_precise(
        jd.model, jnp.asarray(pts), jnp.asarray(dist2), jnp.asarray(gate),
        jnp.float32(1.0), jnp.float32(1.5), kernel, TERM, strict_parity=strict,
        tile_v=128, interpret=True, frame=tuple(map(jnp.asarray, frame)))
    model = _to_port(jd.model)
    before = profiling.counter("launches.evaluate_cuda_precise")
    got, got_w = cuda_precise.evaluate_cuda_precise(
        model, torch.as_tensor(pts), torch.as_tensor(dist2),
        torch.as_tensor(gate), 1.0, 1.5, kernel, TERM, strict_parity=strict,
        frame=tuple(map(torch.as_tensor, frame)))
    assert profiling.counter("launches.evaluate_cuda_precise") == before
    got, got_w = got.numpy(), got_w.numpy()
    ref, ref_w = _precise64(model, pts, dist2, gate, kernel, strict, frame)
    np.testing.assert_allclose(got, ref, atol=EVAL_TOL)
    np.testing.assert_allclose(got_w, ref_w, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(want), atol=PALLAS_CPU_TOL[kernel])
    np.testing.assert_allclose(got_w, np.asarray(want_w), atol=1e-6)
    still = got_w == 0
    assert still.any() and (~still).any()
    np.testing.assert_array_equal(got[still], pts[still])


def test_precise_wrapper_on_cpu_runs_the_plain_version():
    jd = _jax_fit(K.THIN_PLATE, 300)
    model = _to_port(jd.model)
    pts, dist2, mask, _ = _mesh(200)
    args = (model, torch.as_tensor(pts), torch.as_tensor(dist2),
            torch.as_tensor(mask.astype(np.float32)), 1.0, 1.5, K.THIN_PLATE, TERM)
    got = cuda_precise.evaluate_cuda_precise(*args)
    want = cuda_precise.evaluate_precise_reference(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert profiling.counter("launches.evaluate_cuda_precise") == 0 and cuda_eval._lib is None
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_precise.evaluate_cuda_precise(model, args[1].to("meta"), *args[2:])


# -------------------------------------------------------------- end to end
@pytest.mark.parametrize("kernel", GROWING, ids=[k.name for k in GROWING])
def test_slice_end_to_end_matches_jax_and_oracle(kernel):
    """Deformer.fit + apply("auto") at 1024 controls: the port within 5e-5
    of the float64 oracle and of the JAX Deformer, fields compared (not
    weights); displacement() is apply()'s displacement; a JAX-fitted model
    carried across evaluates as JAX's dense_precise does."""
    n = 1024
    rest, deformed = _rig(n)
    pts, dist2, mask, frame = _mesh(500)
    jc = _cfg(kernel, tangent=True)
    tc, tp = _port(jc)
    td = Deformer.fit(rest, deformed, tc, tp, device="cpu")
    assert float(td.report.backward_error()) <= errors.SOLVE_BACKWARD_RTOL
    kw = dict(dist2=dist2, frame=frame, group_mask=mask)
    got, got_w = (a.numpy() for a in td.apply(pts, **kw))
    want, want_w = oracle.deform(rest, deformed, pts, jc, PARAMS, **kw)
    assert np.abs(got - want).max() <= BUDGET
    np.testing.assert_allclose(got_w, want_w, atol=1e-6)
    np.testing.assert_array_equal(got[~mask], pts[~mask])
    jd = jdef.Deformer.fit(rest, deformed, jc, PARAMS)
    jp, _ = jd.apply(pts, **kw)
    assert np.abs(got - np.asarray(jp)).max() <= BUDGET
    # displacement() is the field apply() moves the points by
    plain, w1 = td.apply(pts)
    assert bool((w1 == 1).all())
    np.testing.assert_allclose(td.displacement(pts).numpy(), (plain - torch.as_tensor(pts)).numpy(),
                               atol=1e-6)
    # a JAX-fitted model carried across
    carried = Deformer(model=_to_port(jd.model), cfg=tc, params=tp, report=None)
    jdp, jdw = jd.apply(pts, backend="dense_precise", **kw)
    cp, cw = carried.apply(pts, **kw)
    np.testing.assert_allclose(cp.numpy(), np.asarray(jdp), atol=EVAL_TOL)
    np.testing.assert_array_equal(cw.numpy(), np.asarray(jdw))
    np.testing.assert_allclose(carried.displacement(pts).numpy(),
                               np.asarray(jd.displacement(pts)), atol=EVAL_TOL)


@pytest.mark.parametrize("backend", ["dense_precise", "cuda_precise"])
def test_forced_precise_backends(backend):
    """The precise backends forced on a decaying kernel: the float64 field,
    within f32 rounding of the f32 one; group-masked points pinned."""
    rest, deformed = _rig(150)
    pts, dist2, mask, _ = _mesh(300)
    d = Deformer.fit(rest, deformed, *_port(jcfg.DeformConfig()), device="cpu")
    f32, f32_w = d.apply(pts, dist2=dist2, group_mask=mask, backend="dense")
    got, got_w = d.apply(pts, dist2=dist2, group_mask=mask, backend=backend)
    np.testing.assert_allclose(got.numpy(), f32.numpy(), atol=1e-5)
    np.testing.assert_array_equal(got_w.numpy(), f32_w.numpy())
    np.testing.assert_array_equal(got.numpy()[~mask], pts[~mask])


# ------------------------------------------------------------------- shot
def _shot(n, n_frames, seed=5):
    rng = np.random.default_rng(seed)
    rest = fibonacci_points(n)
    return rest, np.stack([rest + 0.05 * rng.standard_normal((n, 3)).astype(np.float32)
                           for _ in range(n_frames)])


def test_tps_shot_per_pose_route():
    """fit_frames (per-pose route) of a 3-pose TPS shot: lo words stacked,
    each pose exactly fit() of that pose, apply_frames equal to the
    per-frame Deformer.apply."""
    n, f = 160, 3
    rest, frames = _shot(n, f)
    pts, dist2, mask, frame = _mesh(400)
    jc = _cfg(K.THIN_PLATE, tangent=True)
    tc, tp = _port(jc)
    model, resid = tbatched.fit_frames(rest, frames, tc, tp, device="cpu")
    assert tuple(model.w_rbf_lo.shape) == (f, 1, n, 3)
    assert tuple(model.w_poly_lo.shape) == (f, 4, 3)
    errors.check_frames(resid, rest, frames)
    out, w = tbatched.apply_frames(model, pts, dist2, mask.astype(np.float32), tc, tp,
                                   frame=frame)
    assert tuple(out.shape) == (f, 400, 3)
    probes = torch.as_tensor(pts)
    for i in range(f):
        single = Deformer.fit(rest, frames[i], tc, tp, device="cpu")
        frame_model = tfit.RBFModel(ctrl=model.ctrl, w_rbf=model.w_rbf[i],
                                    w_poly=model.w_poly[i], eps=model.eps,
                                    w_rbf_lo=model.w_rbf_lo[i], w_poly_lo=model.w_poly_lo[i])
        np.testing.assert_allclose(
            tprecise.evaluate_precise(frame_model, probes, K.THIN_PLATE, TERM).numpy(),
            single.displacement(pts).numpy(), atol=1e-6)
        want, want_w = single.apply(pts, dist2=dist2, frame=frame, group_mask=mask)
        np.testing.assert_allclose(out[i].numpy(), want.numpy(), atol=1e-6)
        np.testing.assert_array_equal(w.numpy(), want_w.numpy())


def test_tps_shot_shared_route_matches_jax(monkeypatch):
    """The shared factorization forced (budget 0): the lo words kept (JAX's
    shared route drops them), fields within 5e-5 of JAX's fit_frames_dense."""
    n, f = 160, 3
    rest, frames = _shot(n, f, seed=6)
    jc = _cfg(K.THIN_PLATE)
    tc, tp = _port(jc)
    monkeypatch.setattr(tbatched, "vmap_fit_hbm_budget", 0.0)
    model, resid = tbatched.fit_frames(rest, frames, tc, tp, device="cpu")
    assert tuple(model.w_rbf_lo.shape) == (f, 1, n, 3)
    assert tuple(model.w_poly_lo.shape) == (f, 4, 3)
    errors.check_frames(resid, rest, frames)
    jm, _, _ = jfit.fit_frames_dense(jnp.asarray(rest), jnp.asarray(frames), jc, PARAMS)
    pts = _mesh(300)[0]
    for i in range(f):
        got = tprecise.evaluate_precise(cuda_eval.frame_model(model, i), torch.as_tensor(pts),
                                        K.THIN_PLATE, TERM).numpy()
        want = np.asarray(jprecise.evaluate_precise(
            jfit.RBFModel(ctrl=jm.ctrl, w_rbf=jm.w_rbf[i], w_poly=jm.w_poly[i], eps=jm.eps),
            jnp.asarray(pts), K.THIN_PLATE, TERM))
        assert np.abs(got - want).max() <= BUDGET
    out, _ = tbatched.apply_frames(model, pts, np.zeros(300, np.float32),
                                   np.ones(300, np.float32), tc, tp)
    assert tuple(out.shape) == (f, 300, 3) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("kernel", GROWING, ids=[k.name for k in GROWING])
def test_deform_frames_matches_jax_and_oracle(kernel):
    """The whole growing-kernel shot against JAX's deform_frames and each
    frame against the float64 oracle."""
    n, f = 128, 2
    rest, frames = _shot(n, f, seed=7)
    pts, dist2, mask, frame = _mesh(300, seed=8)
    gate = mask.astype(np.float32)
    jc = _cfg(kernel, tangent=True)
    tc, tp = _port(jc)
    got, got_w = tbatched.deform_frames(rest, frames, pts, dist2, gate, tc, tp, frame=frame,
                                        device="cpu")
    want, want_w = jbatched.deform_frames(
        jnp.asarray(rest), jnp.asarray(frames), jnp.asarray(pts), jnp.asarray(dist2),
        jnp.asarray(gate), jc, PARAMS, frame=tuple(map(jnp.asarray, frame)))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= BUDGET
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-6)
    for i in range(f):
        ref, _ = oracle.deform(rest, frames[i], pts, jc, PARAMS, dist2=dist2, frame=frame,
                               group_mask=mask)
        assert np.abs(got[i].numpy() - ref).max() <= BUDGET
