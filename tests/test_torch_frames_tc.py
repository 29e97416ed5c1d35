"""PyTorch port: the frames eval kernel's launch plan, its operand stream
(csrc/frames.cu, packed by ops/cuda_eval.frames_stream), and a plain
emulation of its contraction (_emulate_frames: the phi tile against the
packed weight columns through tf32.matmul_3xtf32, as the tensor cores run
it) held against the plain twin and the JAX package's Pallas kernel
(interpret mode) on fitted small rigs."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
from facedeform_tpu.geometry.primitives import fibonacci_points
from facedeform_tpu.ops import fit as jfit
from facedeform_tpu.ops import pallas_eval
from facedeform_tpu.parallel import batched as jbatched
from facedeform_tpu_torch import DeformConfig, DeformParams, convert
from facedeform_tpu_torch.geometry.primitives import uv_sphere
from facedeform_tpu_torch.ops import cuda_eval, temporal, tf32
from facedeform_tpu_torch.ops.fit import RBFModel
from facedeform_tpu_torch.ops.falloff import falloff_weight
from facedeform_tpu_torch.ops.kernels import apply_kernel
from facedeform_tpu_torch.ops.tangent import project_to_tangents
from facedeform_tpu_torch.parallel import batched
from facedeform_tpu_torch.utils import profiling

K = jcfg.RBFKernel
M = jcfg.RBFModelType
TERM = jcfg.PolyTerm.LINEAR
GROWING = (K.THIN_PLATE, K.MULTIQUADRIC, K.LINEAR, K.CUBIC)
# chip_smoke.py's tolerances: the kernel against its plain twin (positions,
# absolute), and a shot's frame against the single-pose kernel path
POS_TOL_DECAYING = 5e-6
POS_TOL_GROWING = 5e-5
FRAME_VS_SINGLE_TOL = 5e-6
# On fitted rigs the weights (|w| up to ~15 on 120 controls) cancel to
# displacements of ~0.1, and any two f32 contractions differ by about an
# ulp of the per-vertex sum |w phi| (up to ~240 here: the plain twin itself
# sits up to 1.04 such ulps from Pallas): the emulation is held to the
# larger of the chip's tolerance and F32_NOISE ulps of that sum.
F32_NOISE = 4


@pytest.fixture
def one_intra_op_thread():
    """Run the test on one torch intra-op thread: in a process that has
    started JAX, torch's first intra-op parallel region can return exp
    values far more than an ulp off on some of its chunks
    (tests/test_torch_eval.py, same fixture).  The count is never raised
    again: with torch's oneMKL build, raising it once MKL has run makes
    later LAPACK calls spin or fail."""
    torch.set_num_threads(1)


# ------------------------------------------------------------ launch plan
@pytest.mark.parametrize("n_frames,sizes", [
    (1, [1]), (16, [16]), (17, [17]), (32, [32]), (33, [17, 16]), (65, [22, 22, 21])])
def test_launch_plan_balanced_chunks(n_frames, sizes):
    """The fewest launches of at most FRAMES_PER_LAUNCH frames, sizes within
    one of each other, the larger first, contiguous; NT from tf32.n_tiles
    for each launch's 3 nf columns."""
    plan = cuda_eval.frames_launch_plan(n_frames)
    assert [nf for _, nf, _ in plan] == sizes
    assert len(plan) == -(-n_frames // cuda_eval.FRAMES_PER_LAUNCH)
    assert [f0 for f0, _, _ in plan] == list(np.cumsum([0] + sizes[:-1]))
    for _, nf, nt in plan:
        assert nt == cuda_eval.frames_launch_tiles(nf)
        assert nt == tf32.n_tiles(3 * nf, cuda_eval.FRAMES_TILES) and 8 * nt >= 3 * nf


def test_launch_tiles_are_the_fewest_instantiated():
    for nf in range(1, cuda_eval.FRAMES_PER_LAUNCH + 1):
        nt = cuda_eval.frames_launch_tiles(nf)
        assert nt in cuda_eval.FRAMES_TILES and 8 * nt >= 3 * nf
        assert all(8 * t < 3 * nf for t in cuda_eval.FRAMES_TILES if t < nt)
    assert [cuda_eval.frames_launch_tiles(nf) for nf in (1, 2, 3, 8, 9, 16, 17, 19, 32)] == [
        1, 1, 2, 3, 4, 6, 7, 8, 12]
    for bad in (0, cuda_eval.FRAMES_PER_LAUNCH + 1):
        with pytest.raises(ValueError, match="frames launch"):
            cuda_eval.frames_launch_tiles(bad)


# ------------------------------------------------------- operand stream
def _model(n, n_layers, n_frames, seed, m=4):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    return RBFModel(ctrl=t(fibonacci_points(n)), w_rbf=t(rng.standard_normal((n_frames, n_layers, n, 3))),
                    w_poly=t(rng.standard_normal((n_frames, m, 3))),
                    eps=t(rng.uniform(0.3, 0.6, (n_layers, n))))


@pytest.mark.parametrize("nf", [1, 3, 8, 11, 32])
def test_frames_stream_layout(nf):
    """Per k-step of 8 controls (N = 37: the last one padded): the records
    (x, y, z, 1/eps_0^2), the 1/eps^2 of layers 1 .. L - 1 (padding
    controls (0, 0, 0) and 1), then per layer the fragments of this launch's
    weight columns (pack_frames) zero-padded to NT n8 tiles
    (tf32.mma_fragments); the tails' 3 nf columns zero-padded to 8 NT."""
    n, n_layers, n_frames, f0 = 37, 2, 33, 33 - nf
    nt = cuda_eval.frames_launch_tiles(nf)
    model = _model(n, n_layers, n_frames, seed=nf, m=3)
    stream, tails = cuda_eval.frames_stream_reference(model, f0, nf, nt)
    t = 5
    assert tuple(stream.shape) == (t, cuda_eval.frames_step_floats(nt, n_layers))
    rec = stream[:, :32].reshape(40, 4)
    ie = cuda_eval._inv_eps2(model.eps)
    np.testing.assert_array_equal(rec[:n, :3].numpy(), model.ctrl.numpy())
    np.testing.assert_array_equal(rec[:n, 3].numpy(), ie[0].numpy())
    assert not rec[n:, :3].any() and bool((rec[n:, 3] == 1).all())
    ies = stream[:, 32:24 + 8 * n_layers].reshape(t, n_layers - 1, 8).transpose(0, 1)
    np.testing.assert_array_equal(ies.reshape(n_layers - 1, 40)[:, :n].numpy(), ie[1:].numpy())
    assert bool((ies.reshape(n_layers - 1, 40)[:, n:] == 1).all())
    want = torch.zeros((n_layers, 40, 8 * nt))
    want[:, :n, :3 * nf] = cuda_eval.pack_frames(model.w_rbf[f0:])        # (L, N, 3 nf)
    got = stream[:, 24 + 8 * n_layers:].reshape(t, n_layers, nt, 32, 4).transpose(0, 1)
    assert torch.equal(got, tf32.mma_fragments(want))
    assert tuple(tails.shape) == (4, 8 * nt)
    np.testing.assert_array_equal(
        tails[:3, :3 * nf].numpy(), model.w_poly[f0:].permute(1, 0, 2).reshape(3, 3 * nf).numpy())
    assert not tails[3].any() and not tails[:, 3 * nf:].any()


@pytest.mark.parametrize("n_layers", [1, 3])
def test_stream_width_is_the_step_floats(n_layers):
    """For every NT the kernel is instantiated for, the twin's stream holds
    frames_step_floats(NT, L) floats a k-step (the width the wrapper
    allocates on the card) and its tails 8 NT columns."""
    for nt in cuda_eval.FRAMES_TILES:
        nf = min(cuda_eval.FRAMES_PER_LAUNCH, 8 * nt // 3)
        assert cuda_eval.frames_launch_tiles(nf) == nt
        stream, tails = cuda_eval.frames_stream_reference(_model(13, n_layers, nf, seed=nt),
                                                          0, nf, nt)
        assert tuple(stream.shape) == (2, cuda_eval.frames_step_floats(nt, n_layers))
        assert tuple(tails.shape) == (4, 8 * nt)
    assert 8 * max(cuda_eval.FRAMES_TILES) >= 3 * cuda_eval.FRAMES_PER_LAUNCH


def test_frames_stream_on_cpu_is_the_twin():
    model = _model(20, 1, 4, seed=3)
    got = cuda_eval.frames_stream(model, 1, 3, cuda_eval.frames_launch_tiles(3))
    want = cuda_eval.frames_stream_reference(model, 1, 3, cuda_eval.frames_launch_tiles(3))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert profiling.counter("launches.frames_stream") == 0 and cuda_eval._lib is None


# ------------------------------------------- the emulation vs the twins
def _emulate_frames(model, points, dist2, gate, radius, falloffrate, kernel, term,
                    frame=None, plan=None):
    """The frames kernel's function, plain: evaluate_frames_reference's
    arguments and returns, launch by launch of `plan` ((f0, nf, NT) triples,
    by default frames_launch_plan).  Per launch the phi tile (V, T L 8),
    columns in the kernel's k order (k-step, layer, control; layer 0 minus
    the per-vertex mean over the real controls for the growing bases),
    goes through tf32.matmul_3xtf32 against the launch's weight columns,
    zero-padded as frames_stream packs them; then the tail, the tangent
    projection and p + d w."""
    plan = plan or cuda_eval.frames_launch_plan(model.w_rbf.shape[0])
    n_layers, n = model.eps.shape
    t = -(-n // 8)
    inv_eps2 = torch.nn.functional.pad(cuda_eval._inv_eps2(model.eps), (0, 8 * t - n), value=1.0)
    ctrl = torch.nn.functional.pad(model.ctrl, (0, 0, 0, 8 * t - n))
    w, _ = falloff_weight(dist2, radius, falloffrate)
    w = w * gate
    out = torch.empty((model.w_rbf.shape[0],) + tuple(points.shape))
    basis = torch.cat([torch.ones_like(points[:, :1]), points], dim=1)      # [1, x, y, z]
    d = ctrl[None] - points[:, None]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    phi = apply_kernel(kernel, d2[None] * inv_eps2[:, None], 1.0)           # (L, V, 8T)
    if cuda_eval._center_phi(kernel, term):
        phi[0] -= phi[0, :, :n].mean(dim=1, keepdim=True)
    a = phi.reshape(n_layers, -1, t, 8).permute(1, 2, 0, 3).reshape(points.shape[0], -1)
    for f0, nf, nt in plan:
        b = cuda_eval._frame_columns(model, f0, nf, 8 * t, 8 * nt)
        b = b.reshape(n_layers, t, 8, 8 * nt).transpose(0, 1).reshape(-1, 8 * nt)
        disp = tf32.matmul_3xtf32(a, b)[:, :3 * nf]
        disp = disp.reshape(-1, nf, 3).transpose(0, 1)                         # (nf, V, 3)
        tails = model.w_poly.new_zeros((nf, 4, 3))
        tails[:, :model.w_poly.shape[1]] = model.w_poly[f0:f0 + nf]
        for k in range(4):
            disp = disp + basis[:, k, None] * tails[:, k, None, :]
        if frame is not None:
            disp = project_to_tangents(*frame, disp)
        out[f0:f0 + nf] = points + disp * w[:, None]
    return out, w


def _mesh(v=300, seed=1):
    """Points near the unit sphere, a folded weight (apply_frames' gate:
    some vertices outside the capture) and a tangent frame."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((v, 3)).astype(np.float32)
    pts *= (1.0 + 0.1 * rng.standard_normal((v, 1))) / np.linalg.norm(pts, axis=1, keepdims=True)
    fold = np.clip(1.0 - np.abs(0.6 * rng.standard_normal(v)), 0.0, None).astype(np.float32)
    frame = tuple(rng.standard_normal((v, 3)).astype(np.float32) for _ in range(3))
    return pts, fold, frame


RIGS = {
    "gaussian-L1": dict(),
    "gaussian-L3": dict(model=M.MULTILAYER, layers=3),
    "imq": dict(model=M.KERNEL, kernel=K.INVERSE_MULTIQUADRIC),
    "wendland": dict(model=M.KERNEL, kernel=K.WENDLAND_C2),
    "tps": dict(model=M.KERNEL, kernel=K.THIN_PLATE),
}


@functools.lru_cache(maxsize=None)
def _fitted(rig):
    """A fitted 8-pose shot of a 120-control rig (the JAX package's
    batched fit), as numpy arrays."""
    jc = jcfg.DeformConfig(**RIGS[rig])
    rng = np.random.default_rng(len(rig))
    rest = fibonacci_points(120)
    frames = np.stack([rest + 0.05 * rng.standard_normal((120, 3)).astype(np.float32)
                       for _ in range(8)])
    params = jcfg.DeformParams(radius=1.0, lam=0.01)
    jm, _ = jbatched.fit_frames(jnp.asarray(rest), jnp.asarray(frames), jc, params)
    return jfit.effective_kernel(jc), {f: np.asarray(getattr(jm, f))
                                       for f in ("ctrl", "w_rbf", "w_poly", "eps")}


def _f32_noise(model, pts, fold, kernel) -> float:
    """max over vertices, frames and components of fold * sum_lj |w phi|
    (layer-0 phi centered where the kernel centers it), in float64: the
    scale of an f32 contraction's rounding."""
    c, eps, p = model.ctrl.double(), model.eps.double(), torch.as_tensor(pts).double()
    d2 = ((p[:, None] - c[None]) ** 2).sum(-1)
    phi = torch.stack([apply_kernel(kernel, d2, eps[layer]) for layer in range(eps.shape[0])])
    if cuda_eval._center_phi(kernel, TERM):
        phi[0] -= phi[0].mean(dim=1, keepdim=True)
    noise = torch.einsum("lvn,flnc->fvc", phi.abs(), model.w_rbf.double().abs())
    return float((noise * torch.as_tensor(fold).double()[None, :, None]).max())


@pytest.mark.parametrize("n_frames", [1, 3, 8])
@pytest.mark.parametrize("rig", list(RIGS))
@pytest.mark.usefixtures("one_intra_op_thread")
def test_3xtf32_emulation_holds_twin_and_pallas(rig, n_frames):
    """The kernel's contraction emulated (phi tile x packed columns through
    tf32.matmul_3xtf32, then the epilogue) against the plain twin and
    evaluate_pallas_frames in interpret mode, on fitted rigs with a tangent
    frame (TPS centered, with a LINEAR tail): within the chip's tolerance,
    or F32_NOISE f32 ulps of sum |w phi| where that is larger."""
    kernel, arrays = _fitted(rig)
    arrays = dict(arrays, w_rbf=arrays["w_rbf"][:n_frames], w_poly=arrays["w_poly"][:n_frames])
    assert rig != "tps" or cuda_eval._center_phi(kernel, TERM)
    model = convert.model_from_numpy(arrays, device="cpu")
    pts, fold, frame = _mesh()
    v = pts.shape[0]
    args = (model, torch.as_tensor(pts), torch.zeros(v), torch.as_tensor(fold), 1.0, 1.0,
            kernel, TERM)
    tframe = tuple(map(torch.as_tensor, frame))
    emu, emu_w = _emulate_frames(*args, frame=tframe)
    twin, twin_w = cuda_eval.evaluate_frames_reference(*args, frame=tframe)
    tol = max(POS_TOL_GROWING if kernel in GROWING else POS_TOL_DECAYING,
              F32_NOISE * 2.0 ** -24 * _f32_noise(model, pts, fold, kernel))
    assert tuple(emu.shape) == (n_frames, v, 3)
    assert float((emu - twin).abs().max()) <= tol
    assert torch.equal(emu_w, twin_w) and torch.equal(emu_w, torch.as_tensor(fold))
    want, _ = pallas_eval.evaluate_pallas_frames(
        jfit.RBFModel(**{k: jnp.asarray(a) for k, a in arrays.items()}), jnp.asarray(pts),
        jnp.zeros(v, jnp.float32), jnp.asarray(fold), jnp.float32(1.0), jnp.float32(1.0),
        kernel, TERM, tile_v=128, interpret=True, frame=tuple(map(jnp.asarray, frame)))
    assert np.abs(emu.numpy() - np.asarray(want)).max() <= tol


@pytest.mark.parametrize("rig", ["gaussian-L3", "tps"])
@pytest.mark.usefixtures("one_intra_op_thread")
def test_emulated_frames_bit_equal_across_launch_splits(rig):
    """A column depends only on its A row and its B column in a fixed k
    order, so frame f comes out the same whichever launch holds it: 11
    frames in one launch (NT = 6) equal 8 + 3 (NT = 3, 2) bit for bit."""
    kernel, arrays = _fitted(rig)
    w = np.concatenate([arrays["w_rbf"], -0.5 * arrays["w_rbf"][:3]])
    tails = np.concatenate([arrays["w_poly"], -0.5 * arrays["w_poly"][:3]])
    model = convert.model_from_numpy(dict(arrays, w_rbf=w, w_poly=tails), device="cpu")
    pts, fold, frame = _mesh(v=200, seed=2)
    args = (model, torch.as_tensor(pts), torch.zeros(200), torch.as_tensor(fold), 1.0, 1.0,
            kernel, TERM)
    emu = functools.partial(_emulate_frames, *args, frame=tuple(map(torch.as_tensor, frame)))
    one = emu(plan=[(0, 11, 6)])[0]
    split = emu(plan=[(0, 8, 3), (8, 3, 2)])[0]
    assert cuda_eval.frames_launch_plan(11) == [(0, 11, 6)]
    assert torch.equal(one, split)


@pytest.mark.usefixtures("one_intra_op_thread")
def test_frame_vs_single_margin_on_the_fitted_shot():
    """chip_smoke.py phase 5's shot (1000 Fibonacci controls, 8 smoothed
    poses, default gaussian config) at 4096 vertices of its 1M-vertex
    sphere: the emulated tensor-core frames against the f32 single-pose
    evaluation of each pose within FRAME_VS_SINGLE_TOL / 2."""
    rng = np.random.default_rng(0)
    rest = fibonacci_points(1000)
    raw = np.stack([rest + 0.05 * rng.standard_normal((1000, 3)).astype(np.float32)
                    for _ in range(8)])
    cfg = DeformConfig(tangent=True)
    model, _ = batched.fit_frames(rest, temporal.smooth_frames(raw, window=5), cfg,
                                  DeformParams(), device="cpu")
    sphere = uv_sphere(1000, 1000).points
    pts = torch.as_tensor(sphere[np.linspace(0, sphere.shape[0] - 1, 4096).astype(np.int64)])
    cap_d2 = torch.sum((pts - torch.tensor([0.0, 1.0, 0.0])) ** 2, -1)
    args = (pts, cap_d2, torch.ones(4096), 1.0, 1.0, K.GAUSSIAN, TERM)
    emu, _ = _emulate_frames(model, *args)
    assert cuda_eval.frames_launch_plan(8) == [(0, 8, 3)]
    margin = max(float((emu[f] - cuda_eval.evaluate_reference(
        cuda_eval.frame_model(model, f), *args)[0]).abs().max()) for f in range(8))
    print(f"emulated frames vs single-pose f32: max |d| {margin:.3e}")
    assert 0.0 < margin <= FRAME_VS_SINGLE_TOL / 2
