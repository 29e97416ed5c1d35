"""PyTorch port: kernel zoo, distances, assembly, Morton codes and the
procedural primitives against the JAX package on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedeform_tpu.config import PolyTerm, RBFKernel
from facedeform_tpu.geometry import primitives as jprim
from facedeform_tpu.ops import assemble as jasm
from facedeform_tpu.ops import kernels as jk
from facedeform_tpu.ops import morton as jmorton
from facedeform_tpu_torch.geometry import primitives as tprim
from facedeform_tpu_torch.ops import assemble as tasm
from facedeform_tpu_torch.ops import kernels as tk
from facedeform_tpu_torch.ops import morton as tmorton

ALL_KERNELS = list(RBFKernel)


def _rtol(kernel):
    # TPS: the JAX side uses its ~2-ulp software precise_log, the port
    # torch.log; near s = 1 the product s*log(s) cancels to a small value,
    # so the relative gap there is a few ulp of log's magnitude, not of phi
    return 1e-4 if kernel == RBFKernel.THIN_PLATE else 1e-5


@pytest.mark.parametrize("kernel", ALL_KERNELS)
def test_apply_kernel_matches_jax(kernel):
    rng = np.random.default_rng(int(kernel))
    d2 = rng.uniform(0.0, 4.0, (64, 50)).astype(np.float32)
    d2[0, :5] = 0.0                                   # r = 0 on a control
    d2[1, :5] = -1e-7                                 # clamped negatives
    eps = rng.uniform(0.3, 1.5, 50).astype(np.float32)
    want = np.asarray(jk.apply_kernel(kernel, jnp.asarray(d2), jnp.asarray(eps)))
    got = tk.apply_kernel(kernel, torch.as_tensor(d2), torch.as_tensor(eps)).numpy()
    np.testing.assert_allclose(got, want, rtol=_rtol(kernel), atol=1e-6)
    # (L, 1, N) layered radii broadcast the same way
    eps_l = rng.uniform(0.3, 1.5, (3, 1, 50)).astype(np.float32)
    want = np.asarray(jk.apply_kernel(kernel, jnp.asarray(d2)[None], jnp.asarray(eps_l)))
    got = tk.apply_kernel(kernel, torch.as_tensor(d2)[None], torch.as_tensor(eps_l)).numpy()
    np.testing.assert_allclose(got, want, rtol=_rtol(kernel), atol=1e-6)


@pytest.mark.parametrize("kernel", ALL_KERNELS)
def test_phi_prime_s_matches_jax(kernel):
    s = np.concatenate([[0.0, 1e-8], np.linspace(0.01, 6.0, 200)]).astype(np.float32)
    want = np.asarray(jk.phi_prime_s(kernel, jnp.asarray(s)))
    got = tk.phi_prime_s(kernel, torch.as_tensor(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=_rtol(kernel), atol=1e-6)
    assert tk.kernel_is_pd(kernel) == jk.kernel_is_pd(kernel)
    assert tk.kernel_is_compact(kernel) == jk.kernel_is_compact(kernel)


def test_pairwise_sqdist_and_nearest_neighbor_match_jax(rng):
    x = (rng.standard_normal((70, 3)) * 3 + 50).astype(np.float32)  # off-origin
    y = (rng.standard_normal((40, 3)) * 3 + 50).astype(np.float32)
    np.testing.assert_array_equal(
        tk.pairwise_sqdist(torch.as_tensor(x), torch.as_tensor(y)).numpy(),
        np.asarray(jk.pairwise_sqdist(jnp.asarray(x), jnp.asarray(y))),
    )
    np.testing.assert_allclose(
        tk.nearest_neighbor_dist(torch.as_tensor(x)).numpy(),
        np.asarray(jk.nearest_neighbor_dist(jnp.asarray(x))), rtol=1e-6,
    )
    one = x[:1]
    assert tk.nearest_neighbor_dist(torch.as_tensor(one)).tolist() == [1.0]
    with pytest.raises(ValueError, match="3-D"):
        tk.pairwise_sqdist(torch.zeros(4, 5), torch.zeros(3, 5))


@pytest.mark.parametrize("kernel", ALL_KERNELS)
@pytest.mark.parametrize("term", list(PolyTerm))
def test_assemble_system_matches_jax(kernel, term):
    rng = np.random.default_rng(7 * int(kernel) + int(term))
    ctrl = rng.standard_normal((60, 3)).astype(np.float32)
    eps = rng.uniform(0.5, 1.5, 60).astype(np.float32)
    lam_vec = rng.uniform(0.01, 0.1, 60).astype(np.float32)
    for lam in (np.float32(0.05), lam_vec):
        want = np.asarray(jasm.assemble_system(
            jnp.asarray(ctrl), kernel, term, jnp.asarray(eps), jnp.asarray(lam)))
        got = tasm.assemble_system(
            torch.as_tensor(ctrl), kernel, term, torch.as_tensor(eps),
            torch.as_tensor(lam)).numpy()
        np.testing.assert_allclose(got, want, rtol=_rtol(kernel), atol=1e-6)
    delta = rng.standard_normal((60, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tasm.assemble_rhs(torch.as_tensor(delta), term).numpy(),
        np.asarray(jasm.assemble_rhs(jnp.asarray(delta), term)),
    )
    np.testing.assert_array_equal(
        tasm.poly_basis(torch.as_tensor(ctrl), term).numpy(),
        np.asarray(jasm.poly_basis(jnp.asarray(ctrl), term)),
    )


@pytest.mark.parametrize("scale", [1.0, 1e-3, 250.0])
def test_morton_codes_bit_for_bit(rng, scale):
    pts = (rng.standard_normal((3000, 3)) * scale).astype(np.float32)
    pts[:50] = pts[50:100]                             # ties keep stable order
    want = np.asarray(jmorton.morton_codes(jnp.asarray(pts))).astype(np.int64)
    got = tmorton.morton_codes(torch.as_tensor(pts)).numpy()
    np.testing.assert_array_equal(got, want)
    perm, inv = tmorton.spatial_order(torch.as_tensor(pts))
    jperm, jinv = jmorton.spatial_order(jnp.asarray(pts))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))


@pytest.mark.parametrize("size", [(7, 5), (40, 33)])
def test_primitives_match_jax(size):
    a, b = jprim.uv_sphere(*size), tprim.uv_sphere(*size)
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.faces, b.faces)
    assert a.faces.dtype == b.faces.dtype and a.num_points == b.num_points
    a, b = jprim.grid(*size), tprim.grid(*size)
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.faces, b.faces)
    np.testing.assert_array_equal(
        jprim.fibonacci_points(size[1]), tprim.fibonacci_points(size[1])
    )
