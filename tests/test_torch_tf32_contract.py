"""PyTorch port: the 3xTF32 contraction the PU tile kernel and the Jacobian
kernel run on the tensor cores (ops/tf32.py): the operand split, the
fragment layout the wrappers pack, and a plain emulation of the three
passes held against the kernels' plain twins and the JAX package's Pallas
kernels (interpret mode) on fitted small rigs."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
from facedeform_tpu.geometry.primitives import fibonacci_points
from facedeform_tpu.ops import pallas_jacobian
from facedeform_tpu.ops import pallas_pu as jpallas
from facedeform_tpu.ops import pu as jpu
from facedeform_tpu.parallel import batched as jbatched
from facedeform_tpu_torch import convert
from facedeform_tpu_torch.ops import cuda_jacobian, cuda_pu, pu, tf32
from facedeform_tpu_torch.ops.kernels import phi_prime_s

K = jcfg.RBFKernel
T = jcfg.PolyTerm
PU_TOL = 1e-5         # relative to max|disp| (chip_smoke.py: PU kernel vs twin)
JAC_TOL = 1e-5        # relative to max(1, max|J|) (chip_smoke.py: JAC_TOL_DECAYING)
# the twin vs Pallas in interpret mode, absolute: JAX's bound for Mosaic vs
# XLA (tests/test_torch_pu.py, test_tiles_twin_matches_pallas_interpret)
PU_PALLAS_TOL = 1e-5


# ------------------------------------------------------------- the split
def _sweep(rng, n=20000):
    """Finite float32 values, log-uniform in magnitude over the whole range
    (subnormals included), both signs, and zeros."""
    mag = 2.0 ** rng.uniform(-149, 127.9, n)
    x = (mag * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    x[:8] = 0.0
    x[8:16] = np.float32(2.0 ** -149) * np.arange(1, 9)     # the smallest subnormals
    return torch.as_tensor(x)


def test_split_tf32_words():
    x = _sweep(np.random.default_rng(0))
    assert bool(torch.isfinite(x).all()) and bool((x == 0).any())
    assert bool(((x != 0) & (x.abs() < 2.0 ** -126)).any())          # subnormals
    hi, lo = tf32.split_tf32(x)
    hi_bits = hi.view(torch.int32)
    assert not bool((hi_bits & 0x1FFF).any())                        # <= 10 mantissa bits
    x64, hi64, lo64 = x.double(), hi.double(), lo.double()
    assert bool(((hi64 + lo64 - x64).abs() <= 2.0 ** -21 * x64.abs()).all())
    # hi within half a tf32 ulp of a normal x
    normal = x.abs() >= 2.0 ** -126
    assert bool((lo64.abs() <= 2.0 ** -11 * x64.abs())[normal].all())
    # the two tf32 words the mma reads carry x to 2^-22 while lo is normal
    normal = x.abs() >= 2.0 ** -100
    lo_t = tf32.round_tf32(lo)
    assert not bool((lo_t.view(torch.int32) & 0x1FFF).any())
    read = hi64 + lo_t.double()
    assert bool(((read - x64).abs()[normal] <= 2.0 ** -22 * x64.abs()[normal]).all())


def test_split_tf32_rounds_ties_away_from_zero():
    one = torch.tensor([1.0], dtype=torch.float32).view(torch.int32)
    tie = (one + 0x1000).view(torch.float32)                   # 1 + half a tf32 ulp
    hi, lo = tf32.split_tf32(torch.cat([tie, -tie]))
    np.testing.assert_array_equal(hi.numpy(), np.float32([1 + 2.0 ** -10, -(1 + 2.0 ** -10)]))
    np.testing.assert_array_equal(lo.numpy(), np.float32([-(2.0 ** -11), 2.0 ** -11]))


def test_mma_fragments_follow_the_ptx_layout():
    """Reading the packed fragments back with mma.m16n8k8's B layout (lane
    4g + t holds rows t and t + 4 of column g) gives the split operand."""
    rng = np.random.default_rng(1)
    b = torch.as_tensor(rng.standard_normal((2, 24, 16)).astype(np.float32))
    frags = tf32.mma_fragments(b)                               # (2, 3, 2, 32, 4)
    assert tuple(frags.shape) == (2, 3, 2, 32, 4)
    hi, lo = tf32.split_tf32(b)
    lo = tf32.round_tf32(lo)
    for s in range(3):
        for j in range(2):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                got = frags[:, s, j, lane]
                for h, row in enumerate((8 * s + t, 8 * s + t + 4)):
                    assert torch.equal(got[:, h], hi[:, row, 8 * j + g])
                    assert torch.equal(got[:, 2 + h], lo[:, row, 8 * j + g])


def test_matmul_3xtf32_is_near_f32():
    """The three passes keep ~22 bits of each operand: on random operands
    within a few f32 ulps of the float64 product's scale, where one tf32
    pass is off by ~1e-3."""
    rng = np.random.default_rng(2)
    a = torch.as_tensor(rng.standard_normal((64, 96)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((96, 24)).astype(np.float32))
    exact = a.double() @ b.double()
    scale = (a.double().abs() @ b.double().abs()).max()
    err3 = float((tf32.matmul_3xtf32(a, b).double() - exact).abs().max() / scale)
    one = tf32.split_tf32(a)[0].double() @ tf32.split_tf32(b)[0].double()
    err1 = float((one - exact).abs().max() / scale)
    assert err3 < 2e-7 and err1 > 1e-4


# ----------------------------------------------------- the weight columns
@pytest.mark.parametrize("n_frames,n_layers", [(1, 1), (3, 2)])
def test_pack_columns_equals_jax(n_frames, n_layers):
    """weight_columns: frame f's columns 3f .. 3f + 2 are -2 / eps^2 times
    the w_a columns 12f .. 12f + 2 of JAX's _pack_columns, bit for bit."""
    rng = np.random.default_rng(n_frames + n_layers)
    w = rng.standard_normal((n_frames, n_layers, 50, 3)).astype(np.float32)
    ie = rng.uniform(1, 40, (n_layers, 50)).astype(np.float32)
    ctrl = fibonacci_points(50)
    got = cuda_jacobian.weight_columns(torch.as_tensor(w), torch.as_tensor(ie)).numpy()
    packed = np.asarray(pallas_jacobian._pack_columns(jnp.asarray(w), jnp.asarray(ctrl)))
    assert got.shape == (n_layers, 50, 3 * n_frames)
    for f in range(n_frames):
        want = packed[:, :, 12 * f:12 * f + 3] * (np.float32(-2.0) * ie)[..., None]
        np.testing.assert_array_equal(got[:, :, 3 * f:3 * f + 3], want)


@pytest.mark.parametrize("nf", [1, 2, 3, 5, 8])
def test_jacobian_launch_stream_layout(nf):
    """_pack_launch: per group of 8 controls (x, y, z, 0), L x 8 1/eps^2
    (1 on the padded controls), then per layer the fragments of this
    launch's weight columns, padded to NT n8 tiles."""
    rng = np.random.default_rng(nf)
    n, n_layers, f = 19, 2, 9
    ctrl = torch.as_tensor(fibonacci_points(n))
    u = torch.as_tensor(rng.standard_normal((n_layers, n, 3 * f)).astype(np.float32))
    ie = torch.as_tensor(rng.uniform(1, 4, (n_layers, n)).astype(np.float32))
    stream, nt = cuda_jacobian._pack_launch(ctrl, u, ie, 1, nf)
    assert nt == -(-3 * nf // 8) and nt in cuda_jacobian.JAC_TILES
    t = 3
    assert tuple(stream.shape) == (t, 32 + 8 * n_layers + 128 * n_layers * nt)
    c4 = stream[:, :32].reshape(24, 4)
    np.testing.assert_array_equal(c4[:n, :3].numpy(), ctrl.numpy())
    assert not c4[:, 3].any() and not c4[n:].any()
    ies = stream[:, 32:32 + 8 * n_layers].reshape(t, n_layers, 8).transpose(0, 1).reshape(
        n_layers, 24)
    np.testing.assert_array_equal(ies[:, :n].numpy(), ie.numpy())
    assert bool((ies[:, n:] == 1).all())
    frags = stream[:, 32 + 8 * n_layers:].reshape(t, n_layers, nt, 32, 4).transpose(0, 1)
    want = torch.zeros((n_layers, 24, 8 * nt))
    want[:, :n, :3 * nf] = u[:, :, 3:3 * (1 + nf)]
    assert torch.equal(frags, tf32.mma_fragments(want))


@pytest.mark.parametrize("nf", [1, 2, 3, 8, 11, 16])
def test_pu_launch_stream_layout(nf):
    """_pack_launch: per k-step the 8 centered controls (lc, valid), then
    the fragments of this launch's weight columns padded to NT n8 tiles, or
    for one frame (NT = 0) its f32 weights (x, y, z, 0); tails padded to
    8 NT columns (8 for one frame)."""
    rng = np.random.default_rng(nf)
    k_, p_, f = 3, 13, 16
    ctrl = torch.as_tensor(rng.standard_normal((k_, p_, 3)).astype(np.float32))
    cvalid = torch.as_tensor((rng.uniform(size=(k_, p_)) > 0.2).astype(np.float32))
    geom = torch.as_tensor(rng.standard_normal((k_, 8)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((k_, p_, 3 * f)).astype(np.float32))
    poly = torch.as_tensor(rng.standard_normal((k_, 4, 3 * f)).astype(np.float32))
    lc4 = cuda_pu._centered_controls(ctrl, cvalid, geom)
    stream, pc, nt = cuda_pu._pack_launch(lc4, w, poly, f - nf, nf)
    # the fewest instantiated n8 tiles that hold 3nf columns; none for one pose
    assert nt == cuda_pu.launch_tiles(nf) == {1: 0, 2: 1, 3: 2, 8: 3, 11: 6, 16: 6}[nf]
    cp = 8 * max(nt, 1)
    assert tuple(stream.shape) == (k_, 2, 64 if nf == 1 else 32 + 128 * nt)
    lc = stream[:, :, :32].reshape(k_, 16, 4)
    np.testing.assert_array_equal(lc[:, :p_, :3].numpy(),
                                  ((ctrl - geom[:, None, :3]) * cvalid[..., None]).numpy())
    np.testing.assert_array_equal(lc[:, :p_, 3].numpy(), cvalid.numpy())
    assert not lc[:, p_:].any()
    want = torch.zeros((k_, 16, 4 if nf == 1 else cp))
    want[:, :p_, :3 * nf] = w[:, :, 3 * (f - nf):]
    if nf == 1:
        assert torch.equal(stream[:, :, 32:].reshape(k_, 16, 4), want)
    else:
        assert torch.equal(stream[:, :, 32:].reshape(k_, 2, nt, 32, 4),
                           tf32.mma_fragments(want))
    np.testing.assert_array_equal(pc[:, :, :3 * nf].numpy(), poly[:, :, 3 * (f - nf):].numpy())
    assert not pc[:, :, 3 * nf:].any()


# ------------------------------------------- the emulation vs the twins
def _smooth_rig(n):
    rest = fibonacci_points(n)
    disp = (0.1 * np.exp(-3 * np.sum((rest - [0, 1, 0]) ** 2, -1, keepdims=True))
            ).astype(np.float32) * np.float32([0, 1, 0])
    return rest, disp


@functools.lru_cache(maxsize=None)
def _pu_fit(kernel):
    rest, disp = _smooth_rig(900)
    patches = jpu.build_patches(rest, patch_size=64)
    model, _ = jpu.fit_pu(rest, rest + disp, kernel, T.LINEAR, eps="auto", lam=1e-5,
                          patches=patches)
    return patches, model


@pytest.mark.parametrize("kernel", [K.THIN_PLATE, K.GAUSSIAN], ids=["THIN_PLATE", "GAUSSIAN"])
def test_pu_3xtf32_emulation_holds_twin_and_pallas(kernel):
    patches, jm = _pu_fit(kernel)
    rng = np.random.default_rng(3)
    q = (fibonacci_points(400) * rng.uniform(0.97, 1.03, (400, 1))).astype(np.float32)
    ray = np.float32([0.6, 0.8, 0.0])
    shell = (patches.centers[:3] + ray * patches.radii[:3, None] * 0.99995).astype(np.float32)
    q = np.concatenate([q, shell, np.float32([[0, 0, -3]])])    # + one forced fallback
    model = convert.pu_model_from_numpy({f: np.asarray(getattr(jm, f)) for f in jm._fields}, device="cpu")
    frames = [model._replace(w_hi=model.w_hi * s, w_lo=model.w_lo * s,
                             poly_hi=model.poly_hi * s, poly_lo=model.poly_lo * s)
              for s in (1.0, -0.5)]
    pplan = cuda_pu.plan_eval_tiles(pu.PUPatches(*patches), q)
    args = (torch.as_tensor(q), pplan, kernel)
    twin = cuda_pu.evaluate_pu_tiles_reference(frames, *args)
    emu = cuda_pu.evaluate_pu_tiles_reference(frames, *args, contract=tf32.matmul_3xtf32)
    scale = float(twin.abs().max())
    assert float((emu - twin).abs().max()) <= PU_TOL * scale
    tplan = jpallas.plan_eval_tiles(patches, q)
    jframes = tuple(jm._replace(w_hi=jm.w_hi * s, w_lo=jm.w_lo * s, poly_hi=jm.poly_hi * s,
                                poly_lo=jm.poly_lo * s) for s in (1.0, -0.5))
    want = np.asarray(jpallas.evaluate_pu_tiles_frames(
        jframes, jnp.asarray(q), *tplan.device_arrays(), kernel, T.LINEAR, tplan.num_points,
        tplan.tile_v, interpret=True))
    assert np.abs(emu.numpy() - want).max() <= PU_PALLAS_TOL


@functools.lru_cache(maxsize=None)
def _jac_fit(kernel):
    rng = np.random.default_rng(int(kernel))
    rest = fibonacci_points(150)
    frames = np.stack([rest + 0.05 * rng.standard_normal((150, 3)).astype(np.float32)
                       for _ in range(3)])
    jc = (jcfg.DeformConfig() if kernel == K.GAUSSIAN
          else jcfg.DeformConfig(model=jcfg.RBFModelType.KERNEL, kernel=kernel))
    params = jcfg.DeformParams(radius=1.0, lam=0.01)
    jm, _ = jbatched.fit_frames(jnp.asarray(rest), jnp.asarray(frames), jc, params)
    return jc, jm


@pytest.mark.parametrize("kernel", [K.GAUSSIAN, K.THIN_PLATE], ids=["GAUSSIAN", "THIN_PLATE"])
def test_jacobian_3xtf32_emulation_holds_twin_and_pallas(kernel):
    jc, jm = _jac_fit(kernel)
    arrays = {f: np.asarray(getattr(jm, f)) for f in ("ctrl", "w_rbf", "w_poly", "eps")}
    model = convert.model_from_numpy(arrays, device="cpu")
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((300, 3))
    pts *= rng.uniform(1.02, 1.15, (300, 1)) / np.linalg.norm(pts, axis=1, keepdims=True)
    pts = torch.as_tensor(pts.astype(np.float32))
    twin = cuda_jacobian.jacobian_frames_reference(model, pts, kernel, T.LINEAR)
    emu = cuda_jacobian.jacobian_packed_reference(model, pts, kernel, T.LINEAR,
                                                  contract=tf32.matmul_3xtf32)
    plain = cuda_jacobian.jacobian_packed_reference(model, pts, kernel, T.LINEAR)
    scale = max(1.0, float(twin.abs().max()))
    assert float((plain - twin).abs().max()) <= JAC_TOL * scale
    assert float((emu - twin).abs().max()) <= JAC_TOL * scale
    jmodel = type(jm)(**{f: jnp.asarray(a) for f, a in arrays.items()})
    want = np.asarray(pallas_jacobian.jacobian_pallas_frames(
        jmodel, jnp.asarray(pts.numpy()), kernel, T.LINEAR, tile_v=128, interpret=True))
    assert np.abs(emu.numpy() - want).max() <= JAC_TOL * scale
    single = type(jm)(ctrl=jmodel.ctrl, w_rbf=jmodel.w_rbf[0], w_poly=jmodel.w_poly[0],
                      eps=jmodel.eps)
    want1 = np.asarray(pallas_jacobian.jacobian_pallas(
        single, jnp.asarray(pts.numpy()), kernel, T.LINEAR, tile_v=128, interpret=True))
    assert np.abs(emu[0].numpy() - want1).max() <= JAC_TOL * scale


def _jacobian64(model, pts, kernel):
    """Float64 Jacobian written out: sum g w_a (x - c)_b plus the tail."""
    c, w, eps, x = model.ctrl.double(), model.w_rbf.double(), model.eps.double(), pts.double()
    d = x[:, None] - c[None]
    ie = 1.0 / (eps[0] * eps[0])
    g = 2.0 * phi_prime_s(kernel, (d * d).sum(-1) * ie) * ie
    jac = torch.einsum("vn,fna,vnb->fvab", g, w[:, 0], d)
    return jac + model.w_poly.double()[:, 1:4].transpose(1, 2)[:, None]


@pytest.mark.parametrize("kernel", [K.GAUSSIAN, K.THIN_PLATE], ids=["GAUSSIAN", "THIN_PLATE"])
def test_recentered_form_avoids_the_moments_cancellation(kernel):
    """Under 3xTF32 the TPU kernel's moment form J = A x - T cancels (|T| ~
    |A| |c|); the port's re-centered form, D_b = phi' (c_b - x_b) against
    U = -2 w_a / eps^2, does not.  On the fitted rig moved 4 units from the
    origin (J does not change) the emulated kernel is as close to a float64
    Jacobian as the same form in plain f32 (within 1.5x; a growing basis's
    weights cancel on their own), within the chip's tolerance, and at least
    2x closer than the moment form emulated the same way (gaussian ~30x,
    thin plate ~3x)."""
    _, jm = _jac_fit(kernel)
    off = np.float32([4.0, 0.0, 0.0])
    arrays = {f: np.asarray(getattr(jm, f)) for f in ("ctrl", "w_rbf", "w_poly", "eps")}
    arrays["ctrl"] = arrays["ctrl"] + off
    model = convert.model_from_numpy(arrays, device="cpu")
    rng = np.random.default_rng(5)
    pts = rng.standard_normal((300, 3))
    pts *= rng.uniform(1.02, 1.15, (300, 1)) / np.linalg.norm(pts, axis=1, keepdims=True)
    pts = torch.as_tensor((pts + off).astype(np.float32))
    want = _jacobian64(model, pts, kernel)
    scale = max(1.0, float(want.abs().max()))

    def err_of(jac):
        return float((jac.double() - want).abs().max()) / scale

    err = err_of(cuda_jacobian.jacobian_packed_reference(model, pts, kernel, T.LINEAR,
                                                         contract=tf32.matmul_3xtf32))
    err_f32 = err_of(cuda_jacobian.jacobian_packed_reference(model, pts, kernel, T.LINEAR))
    # the moment form: g = 2 phi' / eps^2 against JAX's packed [w_a, w_a c_b]
    u = torch.as_tensor(np.array(pallas_jacobian._pack_columns(
        jnp.asarray(arrays["w_rbf"]), jnp.asarray(arrays["ctrl"]))))[0]
    d = model.ctrl[None] - pts[:, None]
    ie = 1.0 / (model.eps[0] * model.eps[0])
    g = 2.0 * phi_prime_s(kernel, (d * d).sum(-1) * ie) * ie
    m = tf32.matmul_3xtf32(g, u).reshape(-1, 3, 12).transpose(0, 1)          # (F, V, 12)
    err_moments = err_of(m[..., :3, None] * pts[None, :, None, :]
                         - m[..., 3:].reshape(3, -1, 3, 3)
                         + model.w_poly[:, 1:4].transpose(1, 2)[:, None])
    tol = JAC_TOL if kernel == K.GAUSSIAN else 10 * JAC_TOL
    assert err <= 1.5 * err_f32 and err <= tol and err_moments >= 2 * err, (
        err, err_f32, err_moments)
