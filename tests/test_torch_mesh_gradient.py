"""PyTorch port: the mesh field gradient of ops/jacobian.py
(field_gradient_plan, apply_field_gradient, mesh_field_gradient) against
the JAX package's on the same seeded meshes and fields, CPU tensors.

The plan's normalized 3x3 Gram carries a 3e-7 relative ridge, so pole
rings of a uv-sphere solve systems of condition ~1e6: any two f32
evaluations differ there by ~1e-5 of the coefficients' scale.  Plans are
held to PLAN_RTOL of their largest entry, the apply (one gather and one
contraction) on a shared plan to APPLY_RTOL.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedeform_tpu.geometry.primitives import grid, uv_sphere
from facedeform_tpu.geometry.topology import padded_neighbors, unique_edges
from facedeform_tpu.ops import jacobian as jj
from facedeform_tpu_torch.geometry import topology as ttopo
from facedeform_tpu_torch.ops import jacobian as tj

PLAN_RTOL = 1e-4
APPLY_RTOL = 1e-6
AFFINE_TOL = 1e-4     # tangential action of an affine field (tests/test_jacobian.py)

MESHES = {
    "sphere24": lambda: uv_sphere(24, 24),     # poles of degree 24 > the cap
    "sphere40": lambda: uv_sphere(40, 40),
    "grid": lambda: grid(30, 20, size=2.0),
    "sphere_anisotropic": lambda: uv_sphere(16, 160),   # ~20:1 cells
}


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One torch intra-op thread, as the other JAX-parity tests run (see
    tests/test_torch_eval.py); never raised again."""
    torch.set_num_threads(1)


def _table(mesh):
    nbr, _ = padded_neighbors(mesh.num_points, unique_edges(mesh.faces),
                              max_degree=jj.TRANSPORT_MAX_DEGREE)
    return nbr


def _field(pts, seed):
    rng = np.random.default_rng(seed)
    return (0.05 * np.sin(3.0 * pts[:, [1, 2, 0]])
            + 1e-3 * rng.standard_normal(pts.shape)).astype(np.float32)


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def test_degree_cap_and_table_match_jax():
    assert tj.TRANSPORT_MAX_DEGREE == jj.TRANSPORT_MAX_DEGREE == 16
    mesh = uv_sphere(24, 24)
    want = _table(mesh)
    got, _ = ttopo.padded_neighbors(mesh.num_points, ttopo.unique_edges(mesh.faces),
                                    max_degree=tj.TRANSPORT_MAX_DEGREE)
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] <= 16


@pytest.mark.parametrize("name", list(MESHES))
def test_plan_matches_jax(name):
    mesh = MESHES[name]()
    nbr = _table(mesh)
    want = np.asarray(jj.field_gradient_plan(jnp.asarray(mesh.points), jnp.asarray(nbr)))
    got = tj.field_gradient_plan(torch.as_tensor(mesh.points), torch.as_tensor(nbr))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= PLAN_RTOL
    # padded self-slots stay inert
    pad = nbr == np.arange(mesh.num_points)[:, None]
    assert np.all(got.numpy()[pad] == 0.0)


@pytest.mark.parametrize("name", list(MESHES))
def test_apply_and_one_shot_match_jax(name):
    mesh = MESHES[name]()
    nbr = _table(mesh)
    vals = _field(mesh.points, seed=3)
    jplan = jj.field_gradient_plan(jnp.asarray(mesh.points), jnp.asarray(nbr))
    want = np.asarray(jj.apply_field_gradient(jnp.asarray(vals), jnp.asarray(nbr), jplan))
    # the apply on the JAX plan: one gather and one contraction
    got = tj.apply_field_gradient(torch.as_tensor(vals), torch.as_tensor(nbr),
                                  torch.as_tensor(np.array(jplan)))
    assert _rel(got.numpy(), want) <= APPLY_RTOL
    # the one-shot form on its own plan
    one = tj.mesh_field_gradient(torch.as_tensor(mesh.points), torch.as_tensor(vals),
                                 torch.as_tensor(nbr))
    assert _rel(one.numpy(), want) <= PLAN_RTOL


@pytest.mark.parametrize("name", list(MESHES))
def test_affine_field_exact_on_capped_rings(name):
    """The 1-ring LSQ gradient is exact for affine fields through the
    degree-capped table, pole rings and anisotropic cells included (a
    1e-4 ridge zeroed the azimuthal gradient there)."""
    mesh = MESHES[name]()
    pts = mesh.points.astype(np.float32)
    a_mat = np.asarray([[0.02, 0.015, 0.0], [-0.01, -0.03, 0.005], [0.0, 0.02, 0.01]],
                       np.float32)
    nbr = _table(mesh)
    g = tj.mesh_field_gradient(torch.as_tensor(pts), torch.as_tensor(pts @ a_mat.T),
                               torch.as_tensor(nbr)).numpy()
    e = pts[nbr] - pts[:, None, :]
    want = np.einsum("ab,vdb->vda", a_mat, e)
    got = np.einsum("vab,vdb->vda", g, e)
    assert np.abs(got - want).max() < AFFINE_TOL * max(1.0, float(np.abs(e).max()))
