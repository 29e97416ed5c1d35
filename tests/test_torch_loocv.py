"""PyTorch port: LOOCV (Rippa) radius / ridge selection against the JAX
package and explicit float64 leave-one-out refits (CPU tensors)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
from facedeform_tpu.geometry.primitives import fibonacci_points
from facedeform_tpu.ops import loocv as jloocv
from facedeform_tpu.ops.fit import _qnn_radii as j_qnn_radii
from facedeform_tpu_torch import Deformer, DeformConfig, DeformParams
from facedeform_tpu_torch.config import PolyTerm, RBFKernel, RBFModelType
from facedeform_tpu_torch.ops import loocv
from tests import oracle

# LOO errors against JAX's and against N float64 refits, relative to max
# |e| (well-conditioned decaying kernels: the f32 LU's inverse diagonal)
LOO_RTOL = 1e-4


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One torch intra-op thread, as the other JAX-parity tests run (see
    tests/test_torch_eval.py); never raised again."""
    torch.set_num_threads(1)


def _brute_loo(ctrl, delta, kernel, term, eps, lam):
    """float64 leave-one-out errors by N explicit refits (the definition),
    with the package's system (tail, -1e-8 tail block, ridge)."""
    n = len(ctrl)
    e = np.zeros((n, 3))
    for i in range(n):
        keep = np.arange(n) != i
        phi = oracle.apply_kernel(kernel, oracle.pairwise_sqdist(ctrl[keep], ctrl[keep]),
                                  eps[keep]) + lam * np.eye(n - 1)
        p = oracle.poly_basis(ctrl[keep], term)
        m = p.shape[1]
        a = phi if m == 0 else np.block([[phi, p], [p.T, -1e-8 * np.eye(m)]])
        x = np.linalg.solve(a, np.concatenate([delta[keep], np.zeros((m, 3))]))
        pred = oracle.apply_kernel(kernel, oracle.pairwise_sqdist(ctrl[i:i + 1], ctrl[keep]),
                                   eps[keep]) @ x[: n - 1]
        if m:
            pred = pred + oracle.poly_basis(ctrl[i:i + 1], term) @ x[n - 1:]
        e[i] = pred[0] - delta[i]
    return e


def _cloud(seed, n=40):
    rng = np.random.default_rng(seed)
    ctrl = rng.standard_normal((n, 3))
    delta = np.stack([np.sin(ctrl[:, 0]) * np.cos(ctrl[:, 1]), 0.5 * ctrl[:, 2] ** 2,
                      np.cos(0.7 * ctrl[:, 0] + ctrl[:, 2])], axis=1)
    return ctrl.astype(np.float32), (delta + 0.01 * rng.standard_normal((n, 3))).astype(np.float32)


CASES = {
    "gaussian-linear": (RBFKernel.GAUSSIAN, PolyTerm.LINEAR, 1.2, 0.0),
    "gaussian-zero-ridge": (RBFKernel.GAUSSIAN, PolyTerm.ZERO, 1.2, 0.1),
    "gaussian-narrow": (RBFKernel.GAUSSIAN, PolyTerm.LINEAR, 0.5, 0.0),
    "imq-constant": (RBFKernel.INVERSE_MULTIQUADRIC, PolyTerm.CONSTANT, 0.8, 0.01),
    "qnn-radii": (RBFKernel.GAUSSIAN, PolyTerm.LINEAR, None, 0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loocv_errors_match_jax_and_f64_refits(case):
    kernel, term, radius, lam = CASES[case]
    if radius is None:
        # QNN per-point radii: an unsymmetric system
        ctrl = fibonacci_points(150)
        delta = (0.05 * np.random.default_rng(4).standard_normal((150, 3))).astype(np.float32)
        eps = np.array(j_qnn_radii(jnp.asarray(ctrl), 1.0, 5.0))
    else:
        ctrl, delta = _cloud(int(kernel) + int(term))
        eps = np.full(len(ctrl), radius, np.float32)
    e_t, rep = loocv.loocv_errors(torch.as_tensor(ctrl), torch.as_tensor(delta), kernel, term,
                                  torch.as_tensor(eps), lam)
    e_j, _ = jloocv.loocv_errors(jnp.asarray(ctrl), jnp.asarray(delta),
                                 jcfg.RBFKernel(int(kernel)), jcfg.PolyTerm(int(term)),
                                 jnp.asarray(eps), jnp.asarray(lam, jnp.float32))
    e64 = _brute_loo(ctrl.astype(np.float64), delta.astype(np.float64),
                     jcfg.RBFKernel(int(kernel)), jcfg.PolyTerm(int(term)),
                     eps.astype(np.float64), lam)
    scale = np.abs(e64).max()
    assert np.abs(e_t.numpy() - e64).max() <= LOO_RTOL * scale
    assert np.abs(e_t.numpy() - np.asarray(e_j)).max() <= LOO_RTOL * scale
    assert np.isfinite(rep.residual_norm.numpy())
    s_t = float(loocv.loocv_score(torch.as_tensor(ctrl), torch.as_tensor(delta), kernel, term,
                                  torch.as_tensor(eps), lam))
    assert s_t == pytest.approx(float(np.sqrt(np.mean(e64 ** 2))), rel=LOO_RTOL)


def test_loocv_errors_growing_kernel_at_the_jax_bound():
    """TPS: the f32 LU of a growing kernel's system is held, as in the JAX
    test, to 3e-3 of max |e| from the float64 refits."""
    ctrl, delta = _cloud(9)
    eps = np.full(len(ctrl), 1.2, np.float32)
    e_t, _ = loocv.loocv_errors(torch.as_tensor(ctrl), torch.as_tensor(delta),
                                RBFKernel.THIN_PLATE, PolyTerm.LINEAR, torch.as_tensor(eps), 0.0)
    e64 = _brute_loo(ctrl.astype(np.float64), delta.astype(np.float64),
                     jcfg.RBFKernel.THIN_PLATE, jcfg.PolyTerm.LINEAR, eps.astype(np.float64), 0.0)
    assert np.abs(e_t.numpy() - e64).max() < 3e-3 * np.abs(e64).max()


def _smooth_rig(n=60, seed=7):
    rng = np.random.default_rng(seed)
    ctrl = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    field = np.stack([np.sin(2.0 * ctrl[:, 0]), np.cos(2.0 * ctrl[:, 1]) * ctrl[:, 2],
                      0.3 * ctrl[:, 0] * ctrl[:, 1]], axis=1).astype(np.float32)
    return ctrl, ctrl + field


@pytest.mark.parametrize("family", ["kernel", "kernel-ridge", "qnn", "multilayer"])
def test_autotune_picks_jax_candidate(family):
    """The same grid, the same pick and the same scores as the JAX package
    on the candidates whose f32 factorization holds (a score within 10x
    the best); past them (QNN at 4-8x the radius) both blow up, each to its
    own rounding, and both stay far above the best."""
    ctrl, deformed = _smooth_rig()
    kw, ridges = {
        "kernel": (dict(model=RBFModelType.KERNEL, kernel=RBFKernel.GAUSSIAN), None),
        "kernel-ridge": (dict(model=RBFModelType.KERNEL, kernel=RBFKernel.GAUSSIAN),
                         loocv.DEFAULT_RIDGE_VALUES),
        "qnn": ({}, None),
        "multilayer": (dict(model=RBFModelType.MULTILAYER), None),
    }[family]
    tc, jc = DeformConfig(**kw), jcfg.DeformConfig(**kw)
    tp, jp = DeformParams(radius=1.0, lam=0.01), jcfg.DeformParams(radius=1.0, lam=0.01)
    t_params, t_diag = loocv.autotune(ctrl, deformed, tc, tp, ridge_values=ridges, device="cpu")
    j_params, j_diag = jloocv.autotune(ctrl, deformed, jc, jp, ridge_values=ridges)
    np.testing.assert_array_equal(t_diag["factors"], j_diag["factors"])
    np.testing.assert_array_equal(t_diag["ridges"], j_diag["ridges"])
    js, ts = j_diag["scores"], t_diag["scores"]
    held = np.isfinite(js) & (js <= 10 * j_diag["best_score"])
    np.testing.assert_allclose(ts[held], js[held], rtol=1e-3)
    assert (~np.isfinite(ts[~held]) | (ts[~held] > 10 * t_diag["best_score"])).all()
    assert t_diag["best_factor"] == j_diag["best_factor"]
    assert t_diag["best_ridge"] == j_diag["best_ridge"]
    for f in ("qcoef", "zcoef", "radius", "lam"):
        assert getattr(t_params, f) == pytest.approx(float(getattr(j_params, f)), rel=1e-6)


def test_autotune_refusals_match_jax():
    ctrl = np.random.default_rng(1).standard_normal((32, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="dense factorization"):
        loocv.autotune(ctrl, ctrl, DeformConfig(solver="krylov"), DeformParams(), device="cpu")
    with pytest.raises(ValueError, match="exact interpolation"):
        loocv.autotune(ctrl, ctrl, DeformConfig(), DeformParams(), ridge_values=(0.01, 0.1),
                       device="cpu")
    with pytest.raises(ValueError, match="PU route"):
        loocv.autotune(ctrl, ctrl, DeformConfig(solver="pu"), DeformParams(), device="cpu")


def test_fit_auto_carries_the_tuned_params():
    """fit_auto's Deformer is Deformer.fit at the tuned params, bit for bit,
    and its params are those JAX's fit_auto picks."""
    ctrl, deformed = _smooth_rig(n=40, seed=2)
    cfg = DeformConfig(model=RBFModelType.KERNEL, kernel=RBFKernel.GAUSSIAN)
    d, diag = loocv.fit_auto(ctrl, deformed, cfg, DeformParams(radius=1.0), device="cpu")
    ref = Deformer.fit(ctrl, deformed, cfg, d.params, device="cpu")
    q = torch.as_tensor(np.random.default_rng(3).standard_normal((64, 3)).astype(np.float32))
    assert torch.equal(d.displacement(q), ref.displacement(q))
    assert diag["best_factor"] in [float(f) for f in diag["factors"]]
    jd, _ = jloocv.fit_auto(ctrl, deformed, jcfg.DeformConfig(
        model=jcfg.RBFModelType.KERNEL, kernel=jcfg.RBFKernel.GAUSSIAN),
        jcfg.DeformParams(radius=1.0))
    assert d.params.radius == pytest.approx(float(jd.params.radius), rel=1e-6)
