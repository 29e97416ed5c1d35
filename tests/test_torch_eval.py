"""PyTorch port: the eval kernels' plain twin against the JAX package's
Pallas kernels (interpret mode), on JAX-fitted models carried across with
convert.model_from_numpy."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
from facedeform_tpu.geometry.primitives import fibonacci_points
from facedeform_tpu.ops import fit as jfit
from facedeform_tpu.ops import pallas_eval
from facedeform_tpu.ops.evaluate import _center_phi as j_center_phi
from facedeform_tpu_torch import convert
from facedeform_tpu_torch.ops import cuda_eval
from facedeform_tpu_torch.ops.evaluate import _center_phi, evaluate
from facedeform_tpu_torch.ops.kernels import apply_kernel
from facedeform_tpu_torch.utils import profiling
from facedeform_tpu.ops.morton import spatial_order

K = jcfg.RBFKernel
TERM = jcfg.PolyTerm.LINEAR


@pytest.fixture
def one_intra_op_thread():
    """Run the test on one torch intra-op thread.  In a process that has
    started JAX, torch's first intra-op parallel region can return exp
    values far more than an ulp off on some of its chunks, in some fresh
    processes on some hosts, and the fitted models' cancellation turns
    that into position errors past the JAX-parity tolerances.  On one
    thread the twin is deterministic.  The count is not raised again
    afterwards, so later tests of the same process run on one thread too:
    with torch's oneMKL build, raising it once MKL has run makes later
    LAPACK calls (lu_factor_ex) spin without end or fail."""
    torch.set_num_threads(1)


RADIUS, RATE = 1.2, 1.5
V = 1000
GROWING = (K.THIN_PLATE, K.MULTIQUADRIC, K.LINEAR, K.CUBIC)


@functools.lru_cache(maxsize=None)
def _jax_model(kernel, n_layers):
    """A JAX fit of 200 Fibonacci controls under `kernel` (QNN for the
    gaussian); L = 3 stacks the fitted layer at halving radii."""
    rng = np.random.default_rng(int(kernel))
    rest = fibonacci_points(200)
    deformed = rest + 0.05 * rng.standard_normal((200, 3)).astype(np.float32)
    if kernel == K.GAUSSIAN:
        cfg = jcfg.DeformConfig()
    else:
        cfg = jcfg.DeformConfig(model=jcfg.RBFModelType.KERNEL, kernel=kernel)
    model, _ = jfit.fit(jnp.asarray(rest), jnp.asarray(deformed), cfg,
                        jcfg.DeformParams(radius=0.8, lam=0.01))
    if n_layers == 3:
        # growing kernels keep the radius: at eps / 4 their phi grows 16-64x
        # and the field would be dominated by cancellation
        w_scale = jnp.asarray([1.0, 0.5, 0.25])
        eps_scale = w_scale if kernel not in GROWING else jnp.ones(3)
        model = model._replace(
            w_rbf=model.w_rbf * w_scale[:, None, None],
            eps=model.eps * eps_scale[:, None],
            w_rbf_lo=model.w_rbf_lo * w_scale[:, None, None],
        )
    return model


def _to_port(model):
    return convert.model_from_numpy(
        {f: np.asarray(getattr(model, f)) for f in model._fields
         if getattr(model, f) is not None}, device="cpu")


def _inputs(seed=0):
    """Points in Z-order with whole 128-tiles inactive: tiles 0-1 beyond
    the capture radius, tile 4 gated off; a few d2 = -1 sentinels for the
    strict_parity quirk."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((V, 3)).astype(np.float32)
    pts *= (1.0 + 0.1 * rng.standard_normal((V, 1))) / np.linalg.norm(pts, axis=1, keepdims=True)
    pts = pts[np.asarray(spatial_order(jnp.asarray(pts))[0])]
    dist2 = rng.uniform(0.0, 0.8 * RADIUS**2, V).astype(np.float32)
    dist2[:256] = 2.0 * RADIUS**2
    dist2[700:1000:37] = -1.0
    gate = np.ones(V, np.float32)
    gate[512:640] = 0.0
    gate[900:] = rng.uniform(size=100) > 0.5
    frame = tuple(rng.standard_normal((V, 3)).astype(np.float32) for _ in range(3))
    return pts, dist2, gate, frame


def _run_both(kernel, n_layers, with_frame, strict, culled=False):
    jm = _jax_model(kernel, n_layers)
    pts, dist2, gate, frame = _inputs()
    jfn = pallas_eval.evaluate_pallas_culled if culled else pallas_eval.evaluate_pallas
    want = jfn(
        jm, jnp.asarray(pts), jnp.asarray(dist2), jnp.asarray(gate),
        jnp.float32(RADIUS), jnp.float32(RATE), kernel, TERM,
        strict_parity=strict, tile_v=128, interpret=True,
        frame=tuple(jnp.asarray(f) for f in frame) if with_frame else None,
    )
    got = cuda_eval.evaluate_reference(
        _to_port(jm), torch.as_tensor(pts), torch.as_tensor(dist2),
        torch.as_tensor(gate), RADIUS, RATE, kernel, TERM, strict_parity=strict,
        frame=tuple(torch.as_tensor(f) for f in frame) if with_frame else None,
    )
    return [np.asarray(w) for w in want], [g.numpy() for g in got], jm


def _pos_atol(kernel, jm):
    if kernel in (K.GAUSSIAN, K.WENDLAND_C2):
        return 5e-6
    # globally supported kernels carry |w| >> |disp|, so the f32
    # contraction error scales with sum |w| |phi| (the bound of
    # tests/test_pallas.py); growing kernels also center phi by different
    # per-vertex constants on the two sides (the Pallas kernel divides by
    # its padded N), both exact under sum(w) = 0 but rounding differently
    return 2e-5 + 3e-7 * float(np.abs(np.asarray(jm.w_rbf)).sum())


@pytest.mark.parametrize("strict", [False, True], ids=["clamped", "strict"])
@pytest.mark.parametrize("with_frame", [False, True], ids=["noframe", "frame"])
@pytest.mark.parametrize("n_layers", [1, 3])
@pytest.mark.parametrize("kernel", list(K), ids=[k.name for k in K])
@pytest.mark.usefixtures("one_intra_op_thread")
def test_reference_matches_pallas_dense(kernel, n_layers, with_frame, strict):
    (want_p, want_w), (got_p, got_w), jm = _run_both(kernel, n_layers, with_frame, strict)
    np.testing.assert_allclose(got_p, want_p, atol=_pos_atol(kernel, jm))
    np.testing.assert_allclose(got_w, want_w, atol=1e-6)
    # inactive tiles and gated vertices are returned in place
    pts = _inputs()[0]
    np.testing.assert_array_equal(got_p[:256], pts[:256])
    np.testing.assert_array_equal(got_p[512:640], pts[512:640])
    assert not got_w[:256].any() and not got_w[512:640].any()


@pytest.mark.parametrize("strict", [False, True], ids=["clamped", "strict"])
@pytest.mark.parametrize("with_frame", [False, True], ids=["noframe", "frame"])
@pytest.mark.parametrize("n_layers", [1, 3])
@pytest.mark.parametrize("kernel", [K.GAUSSIAN, K.WENDLAND_C2], ids=["GAUSSIAN", "WENDLAND_C2"])
@pytest.mark.usefixtures("one_intra_op_thread")
def test_reference_matches_pallas_culled(kernel, n_layers, with_frame, strict):
    (want_p, want_w), (got_p, got_w), _ = _run_both(
        kernel, n_layers, with_frame, strict, culled=True)
    # the bound of tests/test_culled.py: 1e-12 phi truncation + f32 ordering
    np.testing.assert_allclose(got_p, want_p, atol=5e-6)
    np.testing.assert_allclose(got_w, want_w, atol=1e-6)


@pytest.mark.parametrize("kernel", list(K), ids=[k.name for k in K])
def test_centering_path(kernel):
    """Growing kernels center layer-0 phi (the same rule as the JAX
    package); the centered field equals the float64 uncentered one."""
    for term in jcfg.PolyTerm:
        assert _center_phi(kernel, term) == j_center_phi(kernel, term)
    if not _center_phi(kernel, TERM):
        return
    jm = _jax_model(kernel, 1)
    m = _to_port(jm)
    pts = torch.as_tensor(_inputs()[0])
    got = evaluate(m, pts, kernel, TERM).double()
    m64 = convert.model_from_numpy(
        {f: np.asarray(getattr(jm, f)) for f in ("ctrl", "w_rbf", "w_poly", "eps")}, device="cpu")
    d2 = ((pts.double()[:, None] - m64.ctrl.double()[None]) ** 2).sum(-1)
    phi = apply_kernel(kernel, d2, m64.eps.double()[0])
    ones = torch.ones(V, 1, dtype=torch.float64)
    want = phi @ m64.w_rbf.double()[0] + torch.cat([ones, pts.double()], 1) @ m64.w_poly.double()
    assert float((got - want).abs().max()) < _pos_atol(kernel, jm)


def test_wrappers_on_cpu_run_the_plain_version():
    jm = _jax_model(K.GAUSSIAN, 3)
    m = _to_port(jm)
    pts, dist2, gate, _ = _inputs()
    args = (m, torch.as_tensor(pts), torch.as_tensor(dist2), torch.as_tensor(gate),
            RADIUS, RATE, K.GAUSSIAN, TERM)
    before = (profiling.counter("launches.evaluate_cuda"),
              profiling.counter("launches.evaluate_cuda_culled"))
    ref = cuda_eval.evaluate_reference(*args)
    for fn in (cuda_eval.evaluate_cuda, cuda_eval.evaluate_cuda_culled):
        out = fn(*args)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert (profiling.counter("launches.evaluate_cuda"),
            profiling.counter("launches.evaluate_cuda_culled")) == before == (0, 0)
    assert cuda_eval._lib is None


@pytest.mark.parametrize("kernel", [K.MULTIQUADRIC, K.INVERSE_MULTIQUADRIC, K.THIN_PLATE])
def test_culled_rejects_non_decaying(kernel):
    m = _to_port(_jax_model(kernel, 1))
    pts = torch.zeros(8, 3)
    with pytest.raises(ValueError, match="decaying"):
        cuda_eval.evaluate_cuda_culled(m, pts, torch.zeros(8), torch.ones(8),
                                       RADIUS, RATE, kernel, TERM)
    assert cuda_eval.kernel_is_cullable(kernel) == pallas_eval.kernel_is_cullable(kernel)


@pytest.mark.parametrize("kernel", [K.GAUSSIAN, K.WENDLAND_C2])
def test_culled_slabs(kernel):
    """Sorted, slab-padded controls hold every control once with its
    weights; each slab's bbox bounds its controls; cutoff^2 is
    max eps^2 x s_cut, as pallas_eval builds it."""
    m = _to_port(_jax_model(kernel, 3))
    ctrl, w_rbf, inv_eps2, bbox = cuda_eval.culled_slabs(m, kernel)
    n = m.ctrl.shape[0]
    assert ctrl.shape[0] % 128 == 0 and bbox.shape == (ctrl.shape[0] // 128, 8)
    order = torch.argsort(cuda_eval.morton_codes(m.ctrl), stable=True)
    assert torch.equal(ctrl[:n], m.ctrl[order]) and torch.equal(w_rbf[:, :n], m.w_rbf[:, order])
    assert not w_rbf[:, n:].any() and (ctrl[n:] == ctrl[n - 1]).all()
    assert (inv_eps2[:, n:] == 1.0).all()
    slabs = ctrl.reshape(-1, 128, 3)
    assert torch.equal(bbox[:, :3], slabs.amin(1)) and torch.equal(bbox[:, 3:6], slabs.amax(1))
    s_cut = {K.GAUSSIAN: 27.7, K.WENDLAND_C2: 1.0}[kernel]
    eps = torch.nn.functional.pad(m.eps[:, order], (0, ctrl.shape[0] - n), value=1e-6)
    want = eps.reshape(3, -1, 128).amax(dim=(0, 2)) ** 2 * s_cut
    torch.testing.assert_close(bbox[:, 6], want, rtol=1e-6, atol=0)
