"""PyTorch port: dense-route fit against the JAX package's fit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
from facedeform_tpu.geometry.primitives import fibonacci_points
from facedeform_tpu.ops import evaluate as jeval
from facedeform_tpu.ops import fit as jfit
from facedeform_tpu_torch import convert
from facedeform_tpu_torch.ops import evaluate as teval
from facedeform_tpu_torch.ops import fit as tfit
from facedeform_tpu_torch.utils import errors

K = jcfg.RBFKernel
M = jcfg.RBFModelType

# radius 0.3 keeps the global-radius families well conditioned (cond ~1e2):
# there both solvers' fields agree to f32 rounding.  On ill-conditioned
# systems the weights of the two differ by ~cond * u ||w|| — the JAX side's
# double-float residual tree loses up to an ulp per step on XLA:CPU while
# the port's residual is native float64 — so weights are compared only
# through the field they produce, and against the float64 oracle in
# test_torch_deformer.
CASES = [
    ("qnn", dict(model=M.QNN)),
    ("multilayer3", dict(model=M.MULTILAYER, layers=3)),
    ("gaussian", dict(model=M.KERNEL, kernel=K.GAUSSIAN)),
    ("imq", dict(model=M.KERNEL, kernel=K.INVERSE_MULTIQUADRIC)),
    ("wendland", dict(model=M.KERNEL, kernel=K.WENDLAND_C2, term=jcfg.PolyTerm.CONSTANT)),
]
PARAMS = jcfg.DeformParams(radius=0.3, lam=0.01)


def _rig(n=150, seed=0):
    rng = np.random.default_rng(seed)
    rest = fibonacci_points(n)
    deformed = rest + 0.05 * rng.standard_normal((n, 3)).astype(np.float32)
    probes = 1.1 * rng.standard_normal((500, 3)).astype(np.float32)
    return rest, deformed, probes


def _both(cfg_kw, confidence=None):
    rest, deformed, probes = _rig()
    jc = jcfg.DeformConfig(**cfg_kw)
    jm, jr = jfit.fit(jnp.asarray(rest), jnp.asarray(deformed), jc, PARAMS,
                      confidence=None if confidence is None else jnp.asarray(confidence))
    tc = convert.config_from_fields(dataclasses.asdict(jc))
    tp = convert.params_from_fields(PARAMS._asdict())
    tm, tr = tfit.fit(torch.as_tensor(rest), torch.as_tensor(deformed), tc, tp,
                      confidence=None if confidence is None else torch.as_tensor(confidence))
    return jc, (jm, jr), (tm, tr), probes


@pytest.mark.parametrize("name,cfg_kw", CASES, ids=[c[0] for c in CASES])
def test_fit_matches_jax(name, cfg_kw):
    jc, (jm, jr), (tm, tr), probes = _both(cfg_kw)
    np.testing.assert_allclose(tm.eps.numpy(), np.asarray(jm.eps), rtol=1e-6, atol=1e-6)
    for field in ("ctrl", "w_rbf", "w_poly", "eps", "w_rbf_lo", "w_poly_lo"):
        assert tuple(getattr(tm, field).shape) == tuple(np.shape(getattr(jm, field)))
        assert getattr(tm, field).is_contiguous()  # the kernels take raw pointers
    kernel = jfit.effective_kernel(jc)
    want = np.asarray(jeval.evaluate(jm, jnp.asarray(probes), kernel, jc.term))
    got = teval.evaluate(tm, torch.as_tensor(probes), kernel, jc.term).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert float(tr.backward_error()) <= errors.SOLVE_BACKWARD_RTOL
    assert float(jr.backward_error()) <= errors.SOLVE_BACKWARD_RTOL


def test_confidence_weighted_fit_matches_jax():
    n = 150
    conf = np.linspace(0.0005, 1.0, n).astype(np.float32)   # incl. below the floor
    jc, (jm, _), (tm, _), probes = _both(
        dict(model=M.KERNEL, kernel=K.GAUSSIAN), confidence=conf)
    want = np.asarray(jeval.evaluate(jm, jnp.asarray(probes), K.GAUSSIAN, jc.term))
    got = teval.evaluate(tm, torch.as_tensor(probes), K.GAUSSIAN, jc.term).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(
        tfit.confidence_clipped(conf, n).numpy(),
        np.asarray(jfit.confidence_clipped(jnp.asarray(conf), n)),
    )


def test_fit_rejects_like_jax():
    rest, deformed, _ = _rig(n=40)
    r, d = torch.as_tensor(rest), torch.as_tensor(deformed)
    cfg = convert.config_from_fields(dataclasses.asdict(jcfg.DeformConfig()))
    with pytest.raises(ValueError, match="ridge family"):
        tfit.fit(r, d, cfg, confidence=torch.ones(40))
    ridge = dataclasses.replace(cfg, model=M.KERNEL)
    with pytest.raises(errors.ShapeMismatchError):
        tfit.fit(r, d, ridge, confidence=torch.ones(39))


@pytest.mark.parametrize("kernel", [K.THIN_PLATE, K.MULTIQUADRIC, K.LINEAR, K.CUBIC])
def test_growing_kernel_fit_not_ported(kernel):
    """Growing-kernel fits (once not ported, hence the name) take the
    float64-assembly GMRES-IR route: lo words kept, fields through the
    precise eval within 1e-5 of JAX's double-float fit."""
    from facedeform_tpu.ops import precise_eval as jprecise
    from facedeform_tpu_torch.ops import precise_eval as tprecise

    rest, deformed, probes = _rig()
    jc = jcfg.DeformConfig(model=M.KERNEL, kernel=kernel)
    params = jcfg.DeformParams(radius=1.0, lam=0.01)
    jm, jr = jfit.fit(jnp.asarray(rest), jnp.asarray(deformed), jc, params)
    cfg = convert.config_from_fields(dataclasses.asdict(jc))
    tm, tr = tfit.fit(torch.as_tensor(rest), torch.as_tensor(deformed), cfg,
                      convert.params_from_fields(params._asdict()))
    for field in ("ctrl", "w_rbf", "w_poly", "eps", "w_rbf_lo", "w_poly_lo"):
        assert tuple(getattr(tm, field).shape) == tuple(np.shape(getattr(jm, field)))
    assert bool(tm.w_rbf_lo.abs().max() > 0)
    want = np.asarray(jprecise.evaluate_precise(jm, jnp.asarray(probes), kernel, jc.term))
    got = tprecise.evaluate_precise(tm, torch.as_tensor(probes), kernel, jc.term).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert float(tr.backward_error()) <= errors.SOLVE_BACKWARD_RTOL
    assert float(jr.backward_error()) <= errors.SOLVE_BACKWARD_RTOL


def test_krylov_route_not_ported():
    """The Krylov route (once not ported, hence the name) fits as the JAX
    package's does: no lo words, the field within the JAX package's
    Krylov-vs-direct bound of JAX's Krylov field, the same routing."""
    rest, deformed, probes = _rig(n=20)
    jc = jcfg.DeformConfig(solver="krylov")
    cfg = convert.config_from_fields(dataclasses.asdict(jc))
    tm, tr = tfit.fit(torch.as_tensor(rest), torch.as_tensor(deformed), cfg)
    jm, _ = jfit.fit(jnp.asarray(rest), jnp.asarray(deformed), jc)
    assert tm.w_rbf_lo is None and jm.w_rbf_lo is None
    assert float(tr.backward_error()) <= errors.SOLVE_BACKWARD_RTOL
    want = np.asarray(jeval.evaluate(jm, jnp.asarray(probes), jcfg.RBFKernel.GAUSSIAN, jc.term))
    got = teval.evaluate(tm, torch.as_tensor(probes), jcfg.RBFKernel.GAUSSIAN, jc.term).numpy()
    assert np.abs(got - want).max() < 5e-5 + 1e-3 * np.abs(want).max()
    assert tfit.uses_krylov(cfg, 20) == jfit.uses_krylov(cfg, 20)
    auto = dataclasses.replace(cfg, solver="auto")
    for n in (8192, 8193):
        assert tfit.uses_krylov(auto, n) == jfit.uses_krylov(auto, n)


def test_state_dict_is_the_jax_field_set():
    _, (jm, _), (tm, _), _ = _both(dict(model=M.QNN))
    assert set(tm.state_dict()) == set(jm._fields)
    back = convert.model_from_numpy({k: v.numpy() for k, v in tm.state_dict().items()}, device="cpu")
    for k, v in tm.state_dict().items():
        assert torch.equal(getattr(back, k), v)
