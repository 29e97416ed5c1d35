"""PyTorch port: fit_frames' shared-factorization route keeps the lo words
of growing kernels, so it gives the per-pose route's model bit for bit,
held to the float64 oracle (tests/oracle.py) and to the JAX package's
per-pose route."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
from facedeform_tpu.geometry.primitives import fibonacci_points
from facedeform_tpu.ops import fit as jfit
from facedeform_tpu.ops import precise_eval as jprecise
from facedeform_tpu.parallel import batched as jbatched
from facedeform_tpu_torch import convert
from facedeform_tpu_torch.ops import cuda_eval
from facedeform_tpu_torch.ops import fit as tfit
from facedeform_tpu_torch.ops import precise_eval as tprecise
from facedeform_tpu_torch.parallel import batched as tbatched
from facedeform_tpu_torch.utils import errors

import oracle

K = jcfg.RBFKernel
TERM = jcfg.PolyTerm.LINEAR
PARAMS = jcfg.DeformParams(radius=1.0, lam=0.01)
BUDGET = 5e-5      # max displacement error vs the float64 oracle (BASELINE.md)
# port vs the JAX package's per-pose route, precise fields of each pose: the
# shot tests' bound (tests/test_torch_precise.py)
JAX_TOL = 5e-5
FIELDS = ("ctrl", "w_rbf", "w_poly", "eps", "w_rbf_lo", "w_poly_lo")


def _shot(n, n_frames, seed):
    rng = np.random.default_rng(seed)
    rest = fibonacci_points(n)
    return rest, np.stack([rest + 0.05 * rng.standard_normal((n, 3)).astype(np.float32)
                           for _ in range(n_frames)])


@pytest.mark.parametrize("kernel", [K.CUBIC, K.THIN_PLATE], ids=["CUBIC", "THIN_PLATE"])
def test_shared_route_keeps_lo_words(kernel, monkeypatch):
    n, f = 300, 3
    rest, frames = _shot(n, f, seed=int(kernel))
    jc = jcfg.DeformConfig(model=jcfg.RBFModelType.KERNEL, kernel=kernel, solver="direct")
    tc = convert.config_from_fields(dataclasses.asdict(jc))
    tp = convert.params_from_fields(PARAMS._asdict())
    per_pose, per_pose_r = tbatched.fit_frames(rest, frames, tc, tp, device="cpu")
    # the shared factorization forced: fit_frames routes past the budget
    monkeypatch.setattr(tbatched, "vmap_fit_hbm_budget", 0.0)
    shared, shared_r = tbatched.fit_frames(rest, frames, tc, tp, device="cpu")
    direct, _, _ = tfit.fit_frames_dense(torch.as_tensor(rest), torch.as_tensor(frames), tc, tp)
    assert tuple(shared.w_rbf_lo.shape) == (f, 1, n, 3)
    assert tuple(shared.w_poly_lo.shape) == (f, 4, 3)
    assert bool(shared.w_rbf_lo.abs().max() > 0)
    for name in FIELDS:
        assert torch.equal(getattr(shared, name), getattr(per_pose, name)), name
        assert torch.equal(getattr(direct, name), getattr(per_pose, name)), name
    errors.check_frames(shared_r, rest, frames)
    errors.check_frames(per_pose_r, rest, frames)

    pts = (np.random.default_rng(9).standard_normal((200, 3)) * 0.7).astype(np.float32)
    jm, _ = jbatched.fit_frames(jnp.asarray(rest), jnp.asarray(frames), jc, PARAMS)
    assert jm.w_rbf_lo is not None          # JAX's per-pose route keeps them too
    for i in range(f):
        got = tprecise.evaluate_precise(cuda_eval.frame_model(shared, i), torch.as_tensor(pts),
                                        kernel, TERM).numpy()
        ctrl, w, wp, eps = oracle.fit(rest, frames[i], jc, PARAMS)
        want = oracle.evaluate(ctrl, w, wp, eps, pts, kernel, TERM)
        assert np.abs(got - want).max() <= BUDGET
        jframe = jfit.RBFModel(ctrl=jm.ctrl, w_rbf=jm.w_rbf[i], w_poly=jm.w_poly[i], eps=jm.eps,
                               w_rbf_lo=jm.w_rbf_lo[i], w_poly_lo=jm.w_poly_lo[i])
        jwant = np.asarray(jprecise.evaluate_precise(jframe, jnp.asarray(pts), kernel, TERM))
        assert np.abs(got - jwant).max() <= JAX_TOL


def test_shared_route_drops_lo_words_of_decaying_kernels(monkeypatch):
    """Decaying kernels keep the JAX package's shared route: no lo words."""
    rest, frames = _shot(120, 2, seed=3)
    jc = jcfg.DeformConfig()
    tc = convert.config_from_fields(dataclasses.asdict(jc))
    tp = convert.params_from_fields(PARAMS._asdict())
    monkeypatch.setattr(tbatched, "vmap_fit_hbm_budget", 0.0)
    model, _ = tbatched.fit_frames(rest, frames, tc, tp, device="cpu")
    assert model.w_rbf_lo is None and model.w_poly_lo is None
