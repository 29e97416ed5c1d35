"""PyTorch port: the blendshape bake against the JAX package and a float64
SVD oracle (CPU tensors), at the JAX tests' tolerances
(tests/test_blendshapes.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedeform_tpu.ops import blendshapes as jbs
from facedeform_tpu.ops import dbse as jdbse
from facedeform_tpu_torch import convert
from facedeform_tpu_torch.geometry.primitives import uv_sphere
from facedeform_tpu_torch.ops import blendshapes as bs
from facedeform_tpu_torch.ops import dbse


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One torch intra-op thread, as the other JAX-parity tests run (see
    tests/test_torch_eval.py); never raised again."""
    torch.set_num_threads(1)


def _shot(seed, f_n=6, v=200, modes=3):
    rng = np.random.default_rng(seed)
    rest = rng.standard_normal((v, 3)).astype(np.float32)
    basis = rng.standard_normal((modes, v, 3)).astype(np.float32)
    curves = rng.standard_normal((f_n, modes)).astype(np.float32)
    return rest, (rest[None] + np.einsum("fk,kvi->fvi", curves, basis)).astype(np.float32)


@pytest.mark.parametrize("rank", [1, 2, 4])
def test_singular_values_and_rmse_match_f64_and_jax(rank):
    rest, frames = _shot(0, f_n=8, v=120, modes=6)
    centered = (frames - rest[None]).reshape(8, -1).astype(np.float64)
    centered -= centered.mean(axis=0)
    s_oracle = np.linalg.svd(centered, compute_uv=False)
    model, report = bs.fit_blendshapes(rest, frames, rank=rank, device="cpu")
    _, jrep = jbs.fit_blendshapes(rest, frames, rank=rank)
    assert model.n_targets == rank + 1
    np.testing.assert_allclose(report.singular_values[:rank], s_oracle[:rank], rtol=1e-4)
    np.testing.assert_allclose(report.singular_values[:rank], jrep.singular_values[:rank],
                               rtol=1e-4)
    rmse_oracle = np.sqrt(np.sum(s_oracle[rank:] ** 2) / (8 * 120))
    assert report.rmse == pytest.approx(rmse_oracle, rel=1e-3, abs=1e-6)
    assert report.rmse == pytest.approx(jrep.rmse, rel=1e-3, abs=1e-6)
    assert report.energy == pytest.approx(jrep.energy, rel=1e-5)


@pytest.mark.parametrize("center", [True, False])
def test_full_rank_reconstructs_and_basis_matches_jax_up_to_sign(center):
    rest, frames = _shot(1, f_n=5, v=150, modes=5)
    # the full rank of 5 frames: 4 once the mean is split off (a fifth
    # centered mode would sit at roundoff, kept or dropped by rounding)
    rank = 4 if center else 5
    model, report = bs.fit_blendshapes(rest, frames, rank=rank, center=center, device="cpu")
    jmodel, _ = jbs.fit_blendshapes(rest, frames, rank=rank, center=center)
    scale = np.abs(frames - rest[None]).max()
    recon = bs.apply_blendshapes(model).numpy()
    assert np.abs(recon - frames).max() <= 2e-5 * max(scale, 1.0)
    assert report.max_err <= 2e-5 * max(scale, 1.0)
    jt, jw = np.asarray(jmodel.targets), np.asarray(jmodel.weights)
    assert model.n_targets == jt.shape[0]
    assert model.target_names() == jmodel.target_names()
    for k in range(model.n_targets):
        t, w = model.targets[k].numpy(), model.weights[:, k].numpy()
        sign = 1.0 if np.sum(t * jt[k]) >= 0 else -1.0
        tscale = max(np.abs(jt[k]).max(), 1e-6)
        # separated singular values: each target and curve up to sign
        assert np.abs(sign * t - jt[k]).max() <= 1e-3 * tscale
        assert np.abs(sign * w - jw[:, k]).max() <= 1e-3


def test_dead_mode_guard_and_explicit_weights():
    rng = np.random.default_rng(2)
    rest = rng.standard_normal((50, 3)).astype(np.float32)
    frame = rest + rng.standard_normal((50, 3)).astype(np.float32)
    model, _ = bs.fit_blendshapes(rest, np.repeat(frame[None], 4, axis=0), rank=3, device="cpu")
    assert torch.isfinite(model.targets).all() and torch.isfinite(model.weights).all()
    assert np.abs(bs.apply_blendshapes(model).numpy() - frame[None]).max() <= 1e-5
    rest, frames = _shot(3, f_n=6, v=70, modes=3)
    model, _ = bs.fit_blendshapes(rest, frames, rank=3, device="cpu")
    one = bs.apply_blendshapes(model, model.weights[2]).numpy()
    assert one.shape == (1, 70, 3)
    np.testing.assert_allclose(one[0], frames[2], atol=1e-4)
    with pytest.raises(ValueError):
        bs.apply_blendshapes(model, np.zeros((2, model.n_targets + 1)))
    with pytest.raises(ValueError):
        bs.fit_blendshapes(rest, frames[:, :30], rank=2, device="cpu")
    with pytest.raises(ValueError):
        bs.fit_blendshapes(rest, frames[0], rank=2, device="cpu")
    with pytest.raises(NotImplementedError, match="slice H"):
        bs.fit_blendshapes(rest, frames, rank=2, mesh=object(), device="cpu")


def test_blendshape_meshes_round_trip_through_dbse():
    """Baked targets materialize as blendshape meshes (the reference's
    inputs 3+); dbse.build_model over them and weights_lstsq of each
    frame give back the bake's weight curves, as in JAX."""
    mesh = uv_sphere(12, 12)
    v = mesh.num_points
    frames = mesh.points[None] + 0.1 * np.random.default_rng(7).standard_normal(
        (5, v, 3)).astype(np.float32)
    model, _ = bs.fit_blendshapes(mesh.points, frames, rank=2, device="cpu")
    shapes = bs.blendshape_meshes(model, mesh)
    assert len(shapes) == model.n_targets
    for k, m in enumerate(shapes):
        assert m.num_points == v and np.array_equal(m.faces, mesh.faces)
        np.testing.assert_allclose(m.points, mesh.points + model.targets[k].numpy(), atol=1e-6)
    with pytest.raises(ValueError):
        bs.blendshape_meshes(model, uv_sphere(5, 5))
    dm = dbse.build_model(mesh.points, [m.points for m in shapes], device="cpu")
    recon = bs.apply_blendshapes(model).numpy()
    w, _ = dbse.weights_lstsq_batched(dm, recon, mesh.points)
    np.testing.assert_allclose(w.numpy(), model.weights.numpy(), atol=1e-4)
    # the same round trip in JAX from the carried-over model
    jmodel = jbs.BlendshapeModel(rest=jnp.asarray(model.rest.numpy()),
                                 targets=jnp.asarray(model.targets.numpy()),
                                 weights=jnp.asarray(model.weights.numpy()))
    jdm = jdbse.build_model(mesh.points, [mesh.points + np.asarray(t) for t in jmodel.targets])
    jw, _ = jdbse.weights_lstsq_batched(jdm, jnp.asarray(recon), jnp.asarray(mesh.points))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-5)
    carried = convert.blendshape_model_from_numpy(
        {f: np.asarray(getattr(jmodel, f)) for f in jmodel._fields}, device="cpu")
    np.testing.assert_array_equal(bs.apply_blendshapes(carried).numpy(),
                                  bs.apply_blendshapes(model).numpy())
