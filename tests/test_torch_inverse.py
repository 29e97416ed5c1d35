"""PyTorch port: inverse rig fitting (inverse.py) against the JAX package's
facedeform_tpu.inverse.fit_rig on the cases of tests/test_inverse.py, CPU
tensors.

Where V <= subsample both packages use every vertex, so they are compared
directly: the closed-form rig within 1e-4 of the motion scale, the
gradient path's first five Adam iterates within 1e-5 and its 150-step
result within the JAX test's bound.  Past `subsample` the port draws its
subset from a torch.Generator (the JAX package from jax.random), so it is
held to the JAX test's recovery bound instead.  The dense-route guard
raises the JAX package's words.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
from facedeform_tpu.deformer import Deformer as JDeformer
from facedeform_tpu.geometry.primitives import fibonacci_points, uv_sphere
from facedeform_tpu.inverse import fit_rig as jfit_rig
from facedeform_tpu_torch import config as tcfg
from facedeform_tpu_torch import fit_rig as tfit_rig
from facedeform_tpu_torch.deformer import Deformer as TDeformer

RIG_TOL = 1e-4        # of the motion scale, closed form
ITERATE_TOL = 1e-5    # the gradient path's first Adam iterates
RECOVERY_TOL = 5e-4   # tests/test_inverse.py: refit reproduces the target
GATED_TOL = 1e-3
SUBSAMPLE_TOL = 5e-3


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One torch intra-op thread, as the other JAX-parity tests run (see
    tests/test_torch_eval.py); never raised again."""
    torch.set_num_threads(1)


def _setup(multilayer=False, seed=42):
    rng = np.random.default_rng(seed)
    mesh = uv_sphere(40, 40)
    rest = fibonacci_points(25)
    true = rest + 0.08 * rng.standard_normal((25, 3)).astype(np.float32)
    kw, pk = (dict(model=1, layers=2), dict(radius=1.5, lam=0.05)) if multilayer else ({}, {})
    d = JDeformer.fit(rest, true, jcfg.DeformConfig(**kw), jcfg.DeformParams(**pk))
    target = np.asarray(d.apply(mesh.points, backend="dense")[0])
    return mesh, rest, true, target, kw, pk, rng


def _apply_port(rest, ctrl, points, kw, pk, dist2=None):
    d = TDeformer.fit(rest, ctrl, tcfg.DeformConfig(**kw), tcfg.DeformParams(**pk), device="cpu")
    return d.apply(points, dist2=dist2, backend="dense")[0].numpy()


def test_closed_form_matches_jax_and_recovers():
    mesh, rest, true, target, kw, pk, _ = _setup()
    want = jfit_rig(rest, mesh.points, target, ridge=1e-8)
    got = tfit_rig(rest, mesh.points, target, ridge=1e-8, device="cpu")
    assert got.iterations == want.iterations == 0
    scale = float(np.abs(true - rest).max())
    assert float(np.abs(got.deformed_ctrl.numpy() - np.asarray(want.deformed_ctrl)).max()) \
        <= RIG_TOL * scale
    assert float(got.residual_rms) < 1e-4
    refit = _apply_port(rest, got.deformed_ctrl, mesh.points, kw, pk)
    assert float(np.abs(refit - target).max()) < RECOVERY_TOL


def test_closed_form_with_falloff_gating_matches_jax():
    mesh, rest, true, _, kw, pk, rng = _setup()
    dist2 = np.abs(rng.standard_normal(mesh.num_points)).astype(np.float32) * 0.3
    d = JDeformer.fit(rest, true)
    target = np.asarray(d.apply(mesh.points, dist2=dist2, backend="dense")[0])
    want = jfit_rig(rest, mesh.points, target, dist2=dist2, ridge=1e-8)
    got = tfit_rig(rest, mesh.points, target, dist2=dist2, ridge=1e-8, device="cpu")
    scale = float(np.abs(true - rest).max())
    assert float(np.abs(got.deformed_ctrl.numpy() - np.asarray(want.deformed_ctrl)).max()) \
        <= RIG_TOL * scale
    refit = _apply_port(rest, got.deformed_ctrl, mesh.points, kw, pk, dist2=dist2)
    assert float(np.abs(refit - target).max()) < GATED_TOL


@pytest.mark.parametrize("iters", [1, 2, 3, 4, 5])
def test_gradient_path_first_iterates_match_jax(iters):
    mesh, rest, _, target, kw, pk, _ = _setup(multilayer=True)
    want = jfit_rig(rest, mesh.points, target, jcfg.DeformConfig(**kw),
                    jcfg.DeformParams(**pk), max_iters=iters, learning_rate=0.05, ridge=1e-6)
    got = tfit_rig(rest, mesh.points, target, tcfg.DeformConfig(**kw), tcfg.DeformParams(**pk),
                   max_iters=iters, learning_rate=0.05, ridge=1e-6, device="cpu")
    assert got.iterations == want.iterations == iters
    np.testing.assert_allclose(got.deformed_ctrl.numpy(), np.asarray(want.deformed_ctrl),
                               atol=ITERATE_TOL)


def test_gradient_path_multilayer_converges_like_jax():
    mesh, rest, _, target, kw, pk, _ = _setup(multilayer=True)
    want = jfit_rig(rest, mesh.points, target, jcfg.DeformConfig(**kw),
                    jcfg.DeformParams(**pk), max_iters=150, learning_rate=0.05, ridge=1e-6)
    got = tfit_rig(rest, mesh.points, target, tcfg.DeformConfig(**kw), tcfg.DeformParams(**pk),
                   max_iters=150, learning_rate=0.05, ridge=1e-6, device="cpu")
    assert got.iterations == 150
    refit = _apply_port(rest, got.deformed_ctrl, mesh.points, kw, pk)
    base = float(np.abs(target - mesh.points).max())
    err = float(np.abs(refit - target).max())
    assert err < 0.2 * base, (err, base)
    # the same optimizer on the same inputs: the JAX package's refit error
    j_refit = np.asarray(JDeformer.fit(rest, np.asarray(want.deformed_ctrl),
                                       jcfg.DeformConfig(**kw), jcfg.DeformParams(**pk))
                         .apply(mesh.points, backend="dense")[0])
    j_err = float(np.abs(j_refit - target).max())
    assert abs(err - j_err) <= 0.1 * j_err + 1e-6, (err, j_err)
    assert abs(float(got.residual_rms) - float(want.residual_rms)) \
        <= 0.1 * float(want.residual_rms) + 1e-7


def test_gradient_path_tangent_matches_jax():
    """cfg.tangent with a frame takes the gradient path at one layer."""
    mesh, rest, _, target, _, _, _ = _setup()
    n = mesh.points / np.linalg.norm(mesh.points, axis=1, keepdims=True)
    u = np.cross(n, [0.0, 0.0, 1.0]).astype(np.float32)
    u /= np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-6)
    frame = (u, np.cross(n, u).astype(np.float32), n.astype(np.float32))
    want = jfit_rig(rest, mesh.points, target, jcfg.DeformConfig(tangent=True),
                    frame=frame, max_iters=3, ridge=1e-6)
    got = tfit_rig(rest, mesh.points, target, tcfg.DeformConfig(tangent=True), frame=frame,
                   max_iters=3, ridge=1e-6, device="cpu")
    assert got.iterations == want.iterations == 3
    np.testing.assert_allclose(got.deformed_ctrl.numpy(), np.asarray(want.deformed_ctrl),
                               atol=ITERATE_TOL)


def test_subsample_still_recovers():
    mesh, rest, _, target, kw, pk, _ = _setup()
    got = tfit_rig(rest, mesh.points, target, ridge=1e-8, subsample=500, device="cpu")
    refit = _apply_port(rest, got.deformed_ctrl, mesh.points, kw, pk)
    assert float(np.abs(refit - target).max()) < SUBSAMPLE_TOL
    # the draw is the seed's: the same seed gives the same rig
    again = tfit_rig(rest, mesh.points, target, ridge=1e-8, subsample=500, device="cpu")
    assert torch.equal(again.deformed_ctrl, got.deformed_ctrl)


@pytest.mark.parametrize("case", ["too_many_markers", "krylov_gradient_path"])
def test_dense_route_guard_matches_jax(case):
    mesh = uv_sphere(6, 6)
    if case == "too_many_markers":
        rest = fibonacci_points(8193)
        kw = {}
    else:
        rest = fibonacci_points(30)
        kw = dict(model=1, layers=2, solver="krylov")
    with pytest.raises(ValueError) as want:
        jfit_rig(jnp.asarray(rest), mesh.points, mesh.points, jcfg.DeformConfig(**kw))
    with pytest.raises(ValueError) as got:
        tfit_rig(rest, mesh.points, mesh.points, tcfg.DeformConfig(**kw), device="cpu")
    assert str(got.value) == str(want.value)
