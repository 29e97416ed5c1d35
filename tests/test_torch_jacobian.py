"""PyTorch port: displacement Jacobians and attribute transport
(ops/jacobian, ops/cuda_jacobian's plain twins, Deformer.jacobian and
transform_attrs, batched.transport_frames) against the JAX package, with
Pallas in interpret mode, and the Jacobian against the float64
central-difference oracle (tests/oracle.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
import facedeform_tpu.deformer as jdef
from facedeform_tpu.geometry.primitives import fibonacci_points
from facedeform_tpu.ops import fit as jfit
from facedeform_tpu.ops import jacobian as jjac
from facedeform_tpu.ops import pallas_jacobian
from facedeform_tpu.parallel import batched as jbatched
from facedeform_tpu_torch import convert
from facedeform_tpu_torch.deformer import Deformer
from facedeform_tpu_torch.ops import cuda_eval, cuda_jacobian
from facedeform_tpu_torch.ops import jacobian as tjac
from facedeform_tpu_torch.ops.tangent import tangent_projection_matrix
from facedeform_tpu_torch.parallel import batched as tbatched
from facedeform_tpu_torch.utils import profiling

import oracle

K = jcfg.RBFKernel
PT = jcfg.PolyTerm
JAC_TOL = 1e-6     # rtol = atol, tests/test_pallas_jacobian.py
TRANSPORT_TOL = 1e-5


GROWING = (K.THIN_PLATE, K.MULTIQUADRIC, K.LINEAR, K.CUBIC)


def _arrays(rng, n, layers=1, n_frames=None, kernel=K.GAUSSIAN):
    """A seeded model in numpy at a fitted model's scale: Fibonacci
    controls on the unit sphere, radii by basis, weights 0.05 / sqrt(N)
    (layer 0 summing to zero, the tail constraint) and small tails;
    n_frames stacks per-frame weights and tails."""
    lead = () if n_frames is None else (n_frames,)
    lo, hi = (1.0, 2.0) if kernel in GROWING else (0.3, 0.6)
    w = rng.standard_normal(lead + (layers, n, 3)) * (0.05 / np.sqrt(n))
    w[..., 0, :, :] -= w[..., 0, :, :].mean(axis=-2, keepdims=True)
    return dict(
        ctrl=fibonacci_points(n),
        w_rbf=w.astype(np.float32),
        eps=rng.uniform(lo, hi, (layers, n)).astype(np.float32),
        w_poly=(rng.standard_normal(lead + (4, 3)) * 0.01).astype(np.float32),
    )


def _points(rng, v):
    """Vertices 0.05-0.15 off the control sphere: the LINEAR basis' J is
    singular at a control, where f32 sums taken in different orders cancel
    differently (test_jacobian_vertex_on_control covers r = 0 itself)."""
    pts = rng.standard_normal((v, 3))
    pts *= rng.uniform(1.05, 1.15, (v, 1)) / np.linalg.norm(pts, axis=1, keepdims=True)
    return pts.astype(np.float32)


def _jax(arrays):
    return jfit.RBFModel(**{k: jnp.asarray(v) for k, v in arrays.items()})


@pytest.mark.parametrize("n_layers", [1, 3])
@pytest.mark.parametrize("kernel", list(K), ids=[k.name for k in K])
def test_jacobian_matches_pallas_and_xla(kernel, n_layers):
    rng = np.random.default_rng(int(kernel) + 10 * n_layers)
    arrays = _arrays(rng, 120, n_layers, kernel=kernel)
    pts = _points(rng, 300)
    got = cuda_jacobian.jacobian_cuda(convert.model_from_numpy(arrays, device="cpu"), torch.as_tensor(pts),
                                      kernel, PT.LINEAR).numpy()
    want_pallas = pallas_jacobian.jacobian_pallas(_jax(arrays), jnp.asarray(pts), kernel,
                                                  PT.LINEAR, tile_v=128, interpret=True)
    want_xla = jjac.displacement_jacobian(_jax(arrays), jnp.asarray(pts), kernel, PT.LINEAR)
    np.testing.assert_allclose(got, np.asarray(want_pallas), rtol=JAC_TOL, atol=JAC_TOL)
    np.testing.assert_allclose(got, np.asarray(want_xla), rtol=JAC_TOL, atol=JAC_TOL)


@pytest.mark.parametrize("n_frames", [1, 3, 5])
@pytest.mark.parametrize("kernel", [K.GAUSSIAN, K.THIN_PLATE, K.WENDLAND_C2],
                         ids=["GAUSSIAN", "THIN_PLATE", "WENDLAND_C2"])
def test_jacobian_frames_matches_pallas(kernel, n_frames):
    rng = np.random.default_rng(int(kernel) + n_frames)
    arrays = _arrays(rng, 100, 2, n_frames=n_frames, kernel=kernel)
    pts = _points(rng, 200)
    got = cuda_jacobian.jacobian_cuda_frames(convert.model_from_numpy(arrays, device="cpu"),
                                             torch.as_tensor(pts), kernel, PT.LINEAR)
    want = pallas_jacobian.jacobian_pallas_frames(_jax(arrays), jnp.asarray(pts), kernel,
                                                  PT.LINEAR, tile_v=128, interpret=True)
    assert tuple(got.shape) == (n_frames, 200, 3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=JAC_TOL, atol=JAC_TOL)


@pytest.mark.parametrize("term", list(PT), ids=[t.name for t in PT])
def test_jacobian_tail(term):
    """LINEAR adds the constant w_poly[1:4].T, CONSTANT and ZERO add
    nothing; the frames entry adds each frame's own."""
    rng = np.random.default_rng(int(term))
    rows = {PT.LINEAR: 4, PT.CONSTANT: 1, PT.ZERO: 0}[term]
    arrays = _arrays(rng, 40, n_frames=2)
    arrays["w_poly"] = arrays["w_poly"][:, :rows]
    pts = _points(rng, 64)
    got = cuda_jacobian.jacobian_cuda_frames(convert.model_from_numpy(arrays, device="cpu"),
                                             torch.as_tensor(pts), K.GAUSSIAN, term).numpy()
    want = pallas_jacobian.jacobian_pallas_frames(_jax(arrays), jnp.asarray(pts), K.GAUSSIAN,
                                                  term, tile_v=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=JAC_TOL, atol=JAC_TOL)
    bare = dict(arrays, w_poly=np.zeros((2, 0, 3), np.float32))
    no_tail = cuda_jacobian.jacobian_cuda_frames(convert.model_from_numpy(bare, device="cpu"),
                                                 torch.as_tensor(pts), K.GAUSSIAN, term).numpy()
    tail = got - no_tail
    if term == PT.LINEAR:
        want_tail = np.transpose(arrays["w_poly"][:, 1:4], (0, 2, 1))[:, None]
        np.testing.assert_allclose(tail, np.broadcast_to(want_tail, tail.shape), atol=1e-6)
    else:
        assert not tail.any()


@pytest.mark.parametrize("kernel", [K.LINEAR, K.CUBIC, K.WENDLAND_C2, K.THIN_PLATE],
                         ids=["LINEAR", "CUBIC", "WENDLAND_C2", "THIN_PLATE"])
def test_jacobian_vertex_on_control_is_finite(kernel):
    rng = np.random.default_rng(7)
    arrays = _arrays(rng, 40, kernel=kernel)
    pts = np.concatenate([arrays["ctrl"][:4], _points(rng, 12)])
    got = cuda_jacobian.jacobian_cuda(convert.model_from_numpy(arrays, device="cpu"), torch.as_tensor(pts),
                                      kernel, PT.LINEAR).numpy()
    assert np.isfinite(got).all()
    want = jjac.displacement_jacobian(_jax(arrays), jnp.asarray(pts), kernel, PT.LINEAR)
    np.testing.assert_allclose(got, np.asarray(want), rtol=JAC_TOL, atol=JAC_TOL)


def test_jacobian_chunked_sweep_matches_block():
    rng = np.random.default_rng(3)
    model = convert.model_from_numpy(_arrays(rng, 30, 2), device="cpu")
    pts = torch.as_tensor(_points(rng, 1000))
    whole = tjac.jacobian_block(model, pts, K.GAUSSIAN, PT.LINEAR)
    chunked = tjac.displacement_jacobian(model, pts, K.GAUSSIAN, PT.LINEAR, chunk=128)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=0, atol=1e-7)


@pytest.mark.parametrize("kernel", [K.GAUSSIAN, K.INVERSE_MULTIQUADRIC, K.WENDLAND_C2],
                         ids=["GAUSSIAN", "INVERSE_MULTIQUADRIC", "WENDLAND_C2"])
def test_jacobian_matches_float64_central_difference(kernel):
    rng = np.random.default_rng(11)
    arrays = _arrays(rng, 40, 2, kernel=kernel)
    pts = _points(rng, 100)
    got = cuda_jacobian.jacobian_cuda(convert.model_from_numpy(arrays, device="cpu"), torch.as_tensor(pts),
                                      kernel, PT.LINEAR).numpy()
    want = oracle.jacobian_fd(*(arrays[k].astype(np.float64)
                                for k in ("ctrl", "w_rbf", "w_poly", "eps")),
                              pts, kernel, PT.LINEAR)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() / scale < 1e-5


def test_jacobian_wrappers_on_cpu_run_the_plain_version():
    rng = np.random.default_rng(5)
    arrays = _arrays(rng, 20, n_frames=3)
    model = convert.model_from_numpy(arrays, device="cpu")
    pts = torch.as_tensor(_points(rng, 50))
    got = cuda_jacobian.jacobian_cuda_frames(model, pts, K.GAUSSIAN, PT.LINEAR)
    assert torch.equal(got, cuda_jacobian.jacobian_frames_reference(model, pts, K.GAUSSIAN,
                                                                    PT.LINEAR))
    one = cuda_eval.frame_model(model, 1)
    assert torch.equal(cuda_jacobian.jacobian_cuda(one, pts, K.GAUSSIAN, PT.LINEAR),
                       tjac.displacement_jacobian(one, pts, K.GAUSSIAN, PT.LINEAR))
    assert profiling.counter("launches.jacobian_cuda") == 0
    assert profiling.counter("launches.jacobian_cuda_frames") == 0 and cuda_eval._lib is None


def _gradients(rng, v=300):
    """Deformation gradients around the identity, a few collapsed rows,
    unit normals, vectors and unit quaternions."""
    f = np.eye(3, dtype=np.float32) + 0.3 * rng.standard_normal((v, 3, 3)).astype(np.float32)
    f[:3] = 0.0                                       # collapsed: no rotation defined
    normals = rng.standard_normal((v, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    vectors = rng.standard_normal((v, 3)).astype(np.float32)
    quats = rng.standard_normal((v, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    return f, normals, vectors, quats


def _close_up_to_sign(got, want, atol):
    err = np.minimum(np.abs(got - want).max(-1), np.abs(got + want).max(-1))
    assert err.max() <= atol, err.max()


def test_transport_rules_match_jax():
    f, normals, vectors, quats = _gradients(np.random.default_rng(0))
    tf, jf = torch.as_tensor(f), jnp.asarray(f)
    np.testing.assert_allclose(tjac.transform_normals(torch.as_tensor(normals), tf).numpy(),
                               np.asarray(jjac.transform_normals(jnp.asarray(normals), jf)),
                               atol=TRANSPORT_TOL)
    np.testing.assert_allclose(tjac.transform_vectors(torch.as_tensor(vectors), tf).numpy(),
                               np.asarray(jjac.transform_vectors(jnp.asarray(vectors), jf)),
                               atol=TRANSPORT_TOL)
    np.testing.assert_allclose(tjac.polar_rotation(tf).numpy(),
                               np.asarray(jjac.polar_rotation(jf)), atol=TRANSPORT_TOL)
    _close_up_to_sign(tjac.transform_quaternions(torch.as_tensor(quats), tf).numpy(),
                      np.asarray(jjac.transform_quaternions(jnp.asarray(quats), jf)),
                      TRANSPORT_TOL)
    np.testing.assert_allclose(tjac.principal_stretches(tf).numpy(),
                               np.asarray(jjac.principal_stretches(jf)), atol=TRANSPORT_TOL)
    a, b = quats[:50], quats[50:100]
    np.testing.assert_allclose(
        tjac.quaternion_multiply(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(jjac.quaternion_multiply(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)


def test_polar_rotation_and_quaternions_are_rotations():
    f, *_ = _gradients(np.random.default_rng(1))
    r = tjac.polar_rotation(torch.as_tensor(f)).double()
    eye = torch.eye(3, dtype=torch.float64)
    assert float((r.transpose(1, 2) @ r - eye).abs().max()) < 1e-5
    assert torch.equal(r[:3], eye.expand(3, 3, 3))     # collapsed rows -> identity
    q = tjac.quaternion_from_rotation(r.float())
    np.testing.assert_allclose(torch.linalg.norm(q, dim=-1).numpy(), 1.0, atol=1e-6)
    assert bool((q[:, 3] >= 0).all())
    np.testing.assert_allclose(
        q.numpy(), np.asarray(jjac.quaternion_from_rotation(jnp.asarray(r.float().numpy()))),
        atol=TRANSPORT_TOL)


def test_principal_stretches_match_svd():
    rng = np.random.default_rng(2)
    f = rng.standard_normal((64, 3, 3)).astype(np.float32) + 2.0 * np.eye(3, dtype=np.float32)
    got = tjac.principal_stretches(torch.as_tensor(f)).numpy()
    want = np.linalg.svd(f.astype(np.float64), compute_uv=False)
    assert got.dtype == np.float32 and np.abs(got - want).max() < 1e-5
    iso = torch.as_tensor(1.7 * np.eye(3, dtype=np.float32))[None]
    np.testing.assert_allclose(tjac.principal_stretches(iso).numpy(), 1.7, atol=1e-5)


def test_tangent_projection_matrix_matches_jax_and_projection():
    from facedeform_tpu.ops.tangent import tangent_projection_matrix as jmatrix
    from facedeform_tpu_torch.ops.tangent import project_to_tangents

    rng = np.random.default_rng(4)
    u, v, n, d = (rng.standard_normal((100, 3)).astype(np.float32) for _ in range(4))
    got = tangent_projection_matrix(*map(torch.as_tensor, (u, v, n)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jmatrix(*map(jnp.asarray, (u, v, n)))),
                               atol=1e-6)
    proj = project_to_tangents(*map(torch.as_tensor, (u, v, n, d)))
    np.testing.assert_allclose(torch.einsum("vab,vb->va", got, torch.as_tensor(d)).numpy(),
                               proj.numpy(), atol=1e-6)


@pytest.mark.parametrize("name,typeinfo,width", [
    ("N", None, 3), ("normal", None, 3), ("N_rest", None, 3), ("v", None, 3),
    ("orient", None, 4), ("Cd", None, 1), ("uv", None, 2), ("Cd", "color", 3),
    ("N", "vector", 3), ("rot", "quaternion", 4), ("rgba", "quaternion", 3),
    ("up", "normal", 3),
])
def test_infer_attr_kind_matches_jax(name, typeinfo, width):
    values = np.zeros((5, width) if width > 1 else (5,), np.float32)
    assert (tjac.infer_attr_kind(name, torch.as_tensor(values), typeinfo)
            == jjac.infer_attr_kind(name, values, typeinfo))


def _scene(cfg_kw, n=60, v=300, seed=0):
    rng = np.random.default_rng(seed)
    rest = fibonacci_points(n)
    deformed = rest + 0.05 * rng.standard_normal((n, 3)).astype(np.float32)
    pts = rng.standard_normal((v, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    dist2 = np.abs(0.3 * rng.standard_normal(v)).astype(np.float32)
    frame = tuple(rng.standard_normal((v, 3)).astype(np.float32) for _ in range(3))
    jc = jcfg.DeformConfig(**cfg_kw)
    params = jcfg.DeformParams(radius=0.5, lam=0.01)
    jd = jdef.Deformer.fit(rest, deformed, jc, params)
    td = Deformer.fit(rest, deformed, convert.config_from_fields(dataclasses.asdict(jc)),
                      convert.params_from_fields(params._asdict()), device="cpu")
    _, w = td.apply(pts, dist2=dist2, frame=frame)
    attrs = {
        "N": pts.copy(),
        "v": rng.standard_normal((v, 3)).astype(np.float32),
        "orient": np.tile(np.float32([0.0, 0.0, 0.0, 1.0]), (v, 1)),
    }
    return jd, td, pts, w.numpy(), frame, attrs


@pytest.mark.parametrize("cfg_kw", [dict(), dict(tangent=True)], ids=["plain", "tangent"])
def test_deformer_transform_attrs_matches_jax(cfg_kw):
    jd, td, pts, w, frame, attrs = _scene(cfg_kw)
    np.testing.assert_allclose(td.jacobian(pts).numpy(), np.asarray(jd.jacobian(pts)),
                               rtol=JAC_TOL, atol=JAC_TOL)
    want, want_s = jd.transform_attrs(pts, attrs, w, frame=frame, want_stretch=True)
    got, got_s = td.transform_attrs(pts, attrs, w, frame=frame, want_stretch=True)
    assert list(got) == list(want)
    for name in ("N", "v"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=TRANSPORT_TOL)
    _close_up_to_sign(got["orient"].numpy(), np.asarray(want["orient"]), TRANSPORT_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=TRANSPORT_TOL)
    np.testing.assert_allclose(td.deformed_normals(pts, attrs["N"], w, frame).numpy(),
                               np.asarray(jd.deformed_normals(pts, attrs["N"], w, frame)),
                               atol=TRANSPORT_TOL)
    np.testing.assert_allclose(td.principal_stretches(pts, w, frame).numpy(),
                               np.asarray(jd.principal_stretches(pts, w, frame)),
                               atol=TRANSPORT_TOL)
    # f_map post-composes F, as in the JAX package
    half = lambda f: 0.5 * f  # noqa: E731
    np.testing.assert_allclose(
        td.principal_stretches(pts, w, frame, f_map=half).numpy(),
        np.asarray(jd.principal_stretches(pts, w, frame, f_map=half)), atol=TRANSPORT_TOL)


def test_transport_attrs_rejects_unknown_kind():
    _, td, pts, w, _, _ = _scene({}, v=20)
    with pytest.raises(ValueError, match="no transport rule"):
        td.transform_attrs(pts, {"Cd": np.zeros((20, 2), np.float32)}, w)


@pytest.mark.parametrize("cfg_kw", [dict(), dict(tangent=True)], ids=["plain", "tangent"])
def test_transport_frames_matches_jax(cfg_kw):
    """Per-frame transport of a shot, frames chunked through the Jacobian
    twin: normals, vectors, stretches 1e-5, quaternions up to sign."""
    jc = jcfg.DeformConfig(**cfg_kw)
    params = jcfg.DeformParams(radius=0.5, lam=0.01)
    rng = np.random.default_rng(9)
    rest = fibonacci_points(60)
    frames = np.stack([rest + 0.05 * rng.standard_normal((60, 3)).astype(np.float32)
                       for _ in range(10)])                  # crosses the 8-frame chunk
    jm, _ = jbatched.fit_frames(jnp.asarray(rest), jnp.asarray(frames), jc, params)
    _, _, pts, w, frame, attrs = _scene(cfg_kw)
    values = (attrs["N"], attrs["v"], attrs["orient"])
    kinds = ("normal", "vector", "quaternion")
    want = jbatched.transport_frames(jm, jnp.asarray(pts), values, jnp.asarray(w), jc, kinds,
                                     frame=tuple(map(jnp.asarray, frame)), want_stretch=True)
    tm = convert.model_from_numpy({f: np.asarray(getattr(jm, f)) for f in jm._fields}, device="cpu")
    got = tbatched.transport_frames(tm, pts, values, w,
                                    convert.config_from_fields(dataclasses.asdict(jc)),
                                    kinds, frame=frame, want_stretch=True)
    assert len(got) == 4 and all(tuple(g.shape[:2]) == (10, 300) for g in got)
    for i in (0, 1, 3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), atol=TRANSPORT_TOL)
    _close_up_to_sign(got[2].numpy(), np.asarray(want[2]), TRANSPORT_TOL)
    with pytest.raises(ValueError, match="no transport rule"):
        tbatched.transport_frames(tm, pts, values, w, convert.config_from_fields(
            dataclasses.asdict(jc)), ("normal", "color", "vector"))
