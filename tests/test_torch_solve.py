"""PyTorch port: refined LU solve and SolveReport against the JAX package
and a float64 numpy solve."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedeform_tpu.config import PolyTerm, RBFKernel
from facedeform_tpu.geometry.primitives import fibonacci_points
from facedeform_tpu.ops import solve as jsolve
from facedeform_tpu.ops.assemble import assemble_rhs, assemble_system
from facedeform_tpu.ops.fit import _qnn_radii
from facedeform_tpu_torch.ops import solve as tsolve
from facedeform_tpu_torch.utils import errors


def _qnn_system(n=200, seed=0):
    """The default-config (QNN gaussian, linear tail) saddle system, built
    once by the JAX package so both solvers see the same matrix."""
    rng = np.random.default_rng(seed)
    ctrl = jnp.asarray(fibonacci_points(n))
    eps = _qnn_radii(ctrl, 1.0, 5.0)
    a = np.array(assemble_system(ctrl, RBFKernel.GAUSSIAN, PolyTerm.LINEAR, eps, 0.0))
    delta = 0.05 * rng.standard_normal((n, 3)).astype(np.float32)
    b = np.array(assemble_rhs(jnp.asarray(delta), PolyTerm.LINEAR))
    return a, b


@pytest.mark.parametrize("seed", [0, 1])
def test_lu_solve_refined_matches_jax_and_f64(seed):
    a, b = _qnn_system(seed=seed)
    x64 = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    xj, rj = jsolve.lu_solve_refined(jnp.asarray(a), jnp.asarray(b))
    xt, rt = tsolve.lu_solve_refined(torch.as_tensor(a), torch.as_tensor(b))
    xj, xt = np.asarray(xj), xt.numpy()
    scale = np.linalg.norm(x64)
    assert np.linalg.norm(xt - x64) / scale < 1e-4
    assert np.linalg.norm(xt - xj) / scale < 1e-4
    # report fields agree in order of magnitude
    for field in ("rhs_norm", "scale_norm", "cond_est"):
        tv, jv = float(getattr(rt, field)), float(getattr(rj, field))
        assert 0.1 < tv / jv < 10.0, (field, tv, jv)
    # the returned f32 solution's residual sits at the f32 storage floor
    # u * ||A|| ||x|| on both sides
    floor = 6e-8 * float(rt.scale_norm)
    for rep in (rt, rj):
        assert float(rep.residual_norm) < 10 * floor
    assert rt.col_backward.shape == (3,)
    assert float(rt.backward_error()) <= errors.SOLVE_BACKWARD_RTOL
    assert float(rt.col_backward.max()) <= errors.SOLVE_BACKWARD_RTOL
    errors.check_solve(rt)


def test_refined_pair_beats_f32_solution():
    """want_lo keeps the double-float pair: x_hi + x_lo is closer to the
    float64 solution than x_hi alone, and its report is the pair's."""
    a, b = _qnn_system(n=150)
    x64 = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    (x_hi, x_lo), rep_pair, _ = tsolve._lu_refined_impl(
        torch.as_tensor(a), torch.as_tensor(b), 2, want_lo=True)
    (x_only, zero), rep_hi, _ = tsolve._lu_refined_impl(
        torch.as_tensor(a), torch.as_tensor(b), 2, want_lo=False)
    assert torch.equal(x_only, x_hi) and not zero.any()
    pair = x_hi.double().numpy() + x_lo.double().numpy()
    assert np.linalg.norm(pair - x64) <= np.linalg.norm(x_hi.double().numpy() - x64)
    assert float(rep_pair.residual_norm) <= float(rep_hi.residual_norm)


def test_singular_system_fails_health_check():
    ctrl = np.zeros((10, 3), np.float32)               # all markers coincide
    a = np.array(assemble_system(
        jnp.asarray(ctrl), RBFKernel.GAUSSIAN, PolyTerm.LINEAR, jnp.ones(10), 0.0))
    b = np.ones((14, 3), np.float32)
    _, rep = tsolve.lu_solve_refined(torch.as_tensor(a), torch.as_tensor(b))
    with pytest.raises(errors.SolveFailedError, match="backward error"):
        errors.check_solve(rep)


def test_check_solve_legacy_report_branch():
    ok = tsolve.SolveReport(torch.tensor(1e-6), torch.tensor(1.0))
    errors.check_solve(ok)
    bad = tsolve.SolveReport(torch.tensor(float("nan")), torch.tensor(1.0))
    with pytest.raises(errors.SolveFailedError, match="residual"):
        errors.check_solve(bad)


def test_lu_solve_refined_factored_matches_jax():
    """The factored solve returns lu_solve_refined's solution and the LU
    factors of the same matrix (LOOCV's inverse diagonal), as JAX's."""
    a, b = _qnn_system(n=120, seed=3)
    x, rep, (lu, piv) = tsolve.lu_solve_refined_factored(torch.as_tensor(a), torch.as_tensor(b))
    x_plain, _ = tsolve.lu_solve_refined(torch.as_tensor(a), torch.as_tensor(b))
    assert torch.equal(x, x_plain)
    xj, _, (luj, pivj) = jsolve.lu_solve_refined_factored(jnp.asarray(a), jnp.asarray(b))
    x64 = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    scale = np.linalg.norm(x64)
    assert np.linalg.norm(x.numpy() - np.asarray(xj)) / scale < 1e-4
    inv_diag = torch.diagonal(torch.linalg.lu_solve(lu, piv, torch.eye(a.shape[0])))
    want = np.diagonal(np.linalg.inv(a.astype(np.float64)))
    np.testing.assert_allclose(inv_diag.numpy(), want, rtol=1e-3, atol=1e-6 * np.abs(want).max())
    errors.check_solve(rep)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cholesky_solve_refined_matches_jax_and_f64(seed):
    """The SPD solve of the DBSE normal equations: the JAX package's
    solution within 1e-5 of scale, refined to the float64 solution, one
    report field per system for a batch; a matrix that is not positive
    definite reports a non-finite backward error."""
    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((600, 12)).astype(np.float32)
    g = (basis.T @ basis).astype(np.float32)
    g += np.float32(1e-6 * np.trace(g) / 12) * np.eye(12, dtype=np.float32)
    c = rng.standard_normal((12, 1)).astype(np.float32)
    xt, rt = tsolve.cholesky_solve_refined(torch.as_tensor(g), torch.as_tensor(c))
    xj, rj = jsolve.cholesky_solve_refined(jnp.asarray(g), jnp.asarray(c))
    x64 = np.linalg.solve(g.astype(np.float64), c.astype(np.float64))
    scale = np.abs(x64).max()
    assert np.abs(xt.numpy() - x64).max() <= 1e-5 * scale
    assert np.abs(xt.numpy() - np.asarray(xj)).max() <= 1e-5 * scale
    errors.check_solve(rt)
    for field in ("rhs_norm", "scale_norm", "cond_est"):
        tv, jv = float(getattr(rt, field)), float(getattr(rj, field))
        assert 0.1 < tv / jv < 10.0, (field, tv, jv)
    xb, rb = tsolve.cholesky_solve_refined(torch.as_tensor(g).expand(3, 12, 12),
                                           torch.as_tensor(c).expand(3, 12, 1))
    assert rb.residual_norm.shape == (3,) and torch.equal(xb[1], xt)
    _, bad = tsolve.cholesky_solve_refined(-torch.as_tensor(g), torch.as_tensor(c))
    assert not np.isfinite(float(bad.backward_error()))
    with pytest.raises(errors.SolveFailedError):
        errors.check_solve(bad)
