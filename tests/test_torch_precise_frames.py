"""PyTorch port: the growing-kernel shot's frames launch of the float64
precise kernel (ops/cuda_precise.evaluate_cuda_precise_frames) and the
kernel's table-driven thin-plate log, on the CPU.

The frames twin is held against the JAX package's apply_frames (its
double-float evaluate_precise per frame on XLA:CPU), against a float64
composition of the same weights, and against the single-pose twin; the
numpy model of the device log (the host table plus the kernel's reduction
and polynomial) against np.log under the log's accuracy contract."""

import dataclasses
import itertools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
from facedeform_tpu.geometry.primitives import fibonacci_points
from facedeform_tpu.ops import fit as jfit
from facedeform_tpu.parallel import batched as jbatched
from facedeform_tpu_torch import convert
from facedeform_tpu_torch.ops import cuda_eval, cuda_precise
from facedeform_tpu_torch.ops import fit as tfit
from facedeform_tpu_torch.ops import precise_eval as tprecise
from facedeform_tpu_torch.ops.assemble import poly_basis
from facedeform_tpu_torch.ops.kernels import apply_kernel, pairwise_sqdist
from facedeform_tpu_torch.parallel import batched as tbatched
from facedeform_tpu_torch.utils import profiling

import oracle

K = jcfg.RBFKernel
TERM = jcfg.PolyTerm.LINEAR
GROWING = [K.THIN_PLATE, K.MULTIQUADRIC, K.LINEAR, K.CUBIC]
PARAMS = jcfg.DeformParams(radius=1.0, lam=0.01)
SOURCE = Path(__file__).resolve().parent.parent / "facedeform_tpu_torch" / "csrc" / "precise.cu"
# Positions vs JAX's apply_frames (its double-float evaluate_precise on
# XLA:CPU, ~1 ulp lost per error-free transform) and vs the float64
# composition, x max(1, max|position|): both sides round the displacement
# to f32 and then form f32 positions, so they differ by a few f32 ulps of
# the positions (measured <= 2 ulps: 9.5e-7 at |position| 6.3, cubic)
EVAL_TOL = 1e-6    # tests/test_torch_precise.py's bound
F64_RTOL = 1e-12   # float64 displacement vs the numpy composition, x sum |w phi|


def _shot_model(n, n_layers, n_frames, with_lo, seed):
    """Seeded frames-stacked arrays: Fibonacci controls, radii 0.8-1.5 per
    (layer, control), weights ~N(0, 0.01) (layer 0 summing to zero per
    frame), tails, and lo words below half an f32 ulp when with_lo."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n_frames, n_layers, n, 3)) * 0.01).astype(np.float32)
    w[:, 0] -= w[:, 0].mean(axis=1, keepdims=True)
    arrays = {
        "ctrl": fibonacci_points(n),
        "w_rbf": w,
        "w_poly": (rng.standard_normal((n_frames, 4, 3)) * 0.01).astype(np.float32),
        "eps": rng.uniform(0.8, 1.5, (n_layers, n)).astype(np.float32),
    }
    if with_lo:
        for name in ("w_rbf", "w_poly"):
            u = rng.uniform(-1.0, 1.0, arrays[name].shape)
            arrays[f"{name}_lo"] = (arrays[name] * u * 2.0 ** -25).astype(np.float32)
    return arrays


def _port(jc):
    return (convert.config_from_fields(dataclasses.asdict(jc)),
            convert.params_from_fields(PARAMS._asdict()))


def _mesh(v, seed):
    """Points inside the rig's reach, capture d2 (some beyond radius 1), a
    group gate and a tangent frame."""
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((v, 3)) * 0.7).astype(np.float32)
    dist2 = np.abs(0.7 * rng.standard_normal(v)).astype(np.float32)
    gate = (rng.uniform(size=v) > 0.2).astype(np.float32)
    frame = tuple(rng.standard_normal((v, 3)).astype(np.float32) for _ in range(3))
    return pts, dist2, gate, frame


def _field64(arrays, f, pts, kernel):
    """Frame f's float64 field of w_hi + w_lo (numpy, tests/oracle.py)."""
    lo = arrays.get("w_rbf_lo")
    plo = arrays.get("w_poly_lo")
    w = arrays["w_rbf"][f].astype(np.float64) + (0.0 if lo is None else lo[f])
    wp = arrays["w_poly"][f].astype(np.float64) + (0.0 if plo is None else plo[f])
    eps = arrays["eps"].astype(np.float64)
    disp = oracle.evaluate(arrays["ctrl"].astype(np.float64), w, wp, eps, pts, kernel, TERM)
    d2 = oracle.pairwise_sqdist(np.asarray(pts, np.float64), arrays["ctrl"].astype(np.float64))
    scale = sum(np.abs(oracle.apply_kernel(kernel, d2, eps[l])) @ np.abs(w[l]).sum(1)
                for l in range(w.shape[0]))
    return disp, max(1.0, float(scale.max()))


def _twin_field64(model, pts, kernel):
    """The single-pose twin's float64 field before its one f32 rounding:
    its weights_64 and inv_eps2_64 through the port's kernel functions,
    as ops/precise_eval.evaluate_precise composes them."""
    p = torch.as_tensor(pts).double()
    w, wp = tprecise.weights_64(model)
    inv_eps2 = tprecise.inv_eps2_64(model.eps)
    d2 = pairwise_sqdist(p, model.ctrl.double())
    disp = sum(apply_kernel(kernel, d2 * inv_eps2[l], 1.0) @ w[l] for l in range(w.shape[0]))
    return disp + poly_basis(p, TERM) @ wp


FRAMES_CASES = list(itertools.product(GROWING, (1, 3), (1, 3), (True, False)))


@pytest.mark.parametrize(
    "kernel,n_frames,n_layers,with_lo", FRAMES_CASES,
    ids=[f"{k.name}-F{f}-L{l}-{'lo' if lo else 'nolo'}" for k, f, l, lo in FRAMES_CASES])
def test_frames_twin_matches_jax_and_float64(kernel, n_frames, n_layers, with_lo):
    """apply_frames of a growing-kernel shot on CPU tensors (the frames
    twin, with a capture d2, a group gate and a tangent frame) against the
    JAX package's apply_frames, against a float64 composition of each
    frame (its float64 field at 1e-12 of sum |w phi|, its positions at
    1e-6) and against the single-pose twin of each frame, bit for bit."""
    seed = 10 * n_frames + n_layers + (100 if with_lo else 0)
    arrays = _shot_model(48, n_layers, n_frames, with_lo, seed)
    pts, dist2, gate, frame = _mesh(160, seed + 1)
    jc = jcfg.DeformConfig(model=jcfg.RBFModelType.KERNEL, kernel=kernel, tangent=True)
    want, want_w = jbatched.apply_frames(
        jfit.RBFModel(**{k: jnp.asarray(v) for k, v in arrays.items()}), jnp.asarray(pts),
        jnp.asarray(dist2), jnp.asarray(gate), jc, PARAMS, frame=tuple(map(jnp.asarray, frame)))
    model = convert.model_from_numpy(arrays, device="cpu")
    assert (model.w_rbf_lo is not None) == with_lo
    tc, tp = _port(jc)
    before = (profiling.counter("launches.evaluate_cuda_precise_frames"),
              profiling.counter("launches.evaluate_cuda_precise"))
    got, got_w = tbatched.apply_frames(model, pts, dist2, gate, tc, tp, frame=frame)
    assert (profiling.counter("launches.evaluate_cuda_precise_frames"),
            profiling.counter("launches.evaluate_cuda_precise")) == before
    assert tuple(got.shape) == (n_frames, 160, 3)
    scale_pos = max(1.0, float(np.abs(np.asarray(want)).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=EVAL_TOL * scale_pos)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=0, atol=1e-6)
    fall, _ = oracle.falloff_weight(dist2, 1.0, PARAMS.falloffrate)
    weight = fall * gate
    probes = torch.as_tensor(pts)
    for f in range(n_frames):
        one = cuda_eval.frame_model(model, f)
        ref, scale = _field64(arrays, f, pts, kernel)
        disp64 = _twin_field64(one, pts, kernel)
        assert np.abs(disp64.numpy() - ref).max() <= F64_RTOL * scale
        ref_pos = pts + oracle.project_to_tangents(*frame, ref) * weight[:, None]
        np.testing.assert_allclose(got[f].numpy(), ref_pos, rtol=0, atol=EVAL_TOL * scale_pos)
        single, single_w = cuda_precise.evaluate_precise_reference(
            one, probes, torch.zeros(160), got_w, 1.0, 1.0, kernel, TERM,
            frame=tuple(map(torch.as_tensor, frame)))
        assert torch.equal(got[f], single) and torch.equal(got_w, single_w)


def test_frames_wrapper_on_cpu_runs_the_plain_version():
    """evaluate_cuda_precise_frames on CPU tensors is its twin, launches
    nothing and builds nothing; a meta tensor is refused; frame_model
    carries each frame's lo words (None when the model has none)."""
    arrays = _shot_model(40, 2, 3, True, seed=5)
    model = convert.model_from_numpy(arrays, device="cpu")
    pts, dist2, gate, frame = _mesh(90, seed=6)
    args = (model, torch.as_tensor(pts), torch.as_tensor(dist2), torch.as_tensor(gate), 1.0,
            1.5, K.CUBIC, TERM)
    kw = dict(strict_parity=True, frame=tuple(map(torch.as_tensor, frame)))
    got = cuda_precise.evaluate_cuda_precise_frames(*args, **kw)
    want = cuda_precise.evaluate_precise_frames_reference(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert profiling.counter("launches.evaluate_cuda_precise_frames") == 0
    assert cuda_eval._lib is None
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_precise.evaluate_cuda_precise_frames(model, args[1].to("meta"), *args[2:])
    one = cuda_eval.frame_model(model, 2)
    assert torch.equal(one.w_rbf_lo, model.w_rbf_lo[2])
    assert torch.equal(one.w_poly_lo, model.w_poly_lo[2])
    bare = tfit.RBFModel(ctrl=model.ctrl, w_rbf=model.w_rbf, w_poly=model.w_poly,
                         eps=model.eps)
    assert cuda_eval.frame_model(bare, 1).w_rbf_lo is None


def test_apply_frames_on_cpu_launches_nothing():
    """The shot's eval on CPU tensors (deform_frames: fit_frames then
    apply_frames) leaves every precise launch counter at 0 and equals the
    per-frame single-pose twin."""
    rng = np.random.default_rng(9)
    rest = fibonacci_points(64)
    frames = rest + 0.05 * rng.standard_normal((2, 64, 3)).astype(np.float32)
    pts, dist2, gate, _ = _mesh(120, seed=10)
    tc, tp = _port(jcfg.DeformConfig(model=jcfg.RBFModelType.KERNEL, kernel=K.THIN_PLATE,
                                      solver="direct"))
    out, w = tbatched.deform_frames(rest, frames, pts, dist2, gate, tc, tp, device="cpu")
    assert profiling.counter("launches.evaluate_cuda_precise_frames") == 0
    assert profiling.counter("launches.evaluate_cuda_precise") == 0
    model, _ = tbatched.fit_frames(rest, frames, tc, tp, device="cpu")
    for f in range(2):
        single, _ = cuda_precise.evaluate_precise_reference(
            cuda_eval.frame_model(model, f), torch.as_tensor(pts), torch.zeros(120), w,
            1.0, 1.0, K.THIN_PLATE, TERM)
        assert torch.equal(out[f], single)


# ------------------------------------------------------------ device log
def _ulp_errors(s):
    """(errors in ulps of log s where |log s| >= 1, absolute errors in
    units of 2^-52 elsewhere) of the numpy model against np.log."""
    got = cuda_precise.device_log_model(s)
    ref = np.log(s)
    err = np.abs(got - ref)
    big = np.abs(ref) >= 1.0
    return err[big] / np.spacing(np.abs(ref[big])), err[~big] / 2.0 ** -52


def _edge_cases():
    """Powers of two over the whole exponent range, s = 1 +- a few ulp,
    subnormals, the table's range edges and the reduction's boundaries."""
    pow2 = 2.0 ** np.arange(-1074, 1024, dtype=np.float64)
    near1 = 1.0 + np.arange(-64, 65) * 2.0 ** -53
    sub = np.nextafter(0.0, 1.0) * np.concatenate([np.arange(1, 4096), 2.0 ** np.arange(12, 52)])
    j = np.arange(256)
    edges = np.concatenate([1.0 + (j - 0.5) / 256, 0.5 + (j - 0.5) / 512,
                            [0.75 - 2.0 ** -10, 1.5 - 2.0 ** -9, 1.0 - 2.0 ** -10,
                             1.0 + 2.0 ** -9]])
    edges = np.concatenate([edges, np.nextafter(edges, 0), np.nextafter(edges, 2)])
    return np.concatenate([pow2, near1, sub, edges, edges * 2.0 ** 40, edges * 2.0 ** -70])


@pytest.mark.parametrize("name", ["sweep", "edges"])
def test_device_log_model_meets_its_contract(name):
    """The device log (numpy model of csrc/precise.cu's log_dev) within 4
    ulp of np.log where |log s| >= 1 and 4 * 2^-52 absolute elsewhere, over
    a log-spaced sweep of [1e-30, 1e8] and the edge cases."""
    if name == "sweep":
        s = np.concatenate([np.logspace(-30, 8, 400_001),
                            np.random.default_rng(0).uniform(0.7, 1.6, 200_000)])
    else:
        s = _edge_cases()
    rel, absolute = _ulp_errors(s)
    assert rel.size and absolute.size
    assert rel.max() <= 4.0, rel.max()
    assert absolute.max() <= 4.0, absolute.max()
    assert np.isfinite(cuda_precise.device_log_model(s)).all()


def test_log_table_and_constants_match_the_kernel():
    """The host table: 256 rows (1/c_j, log c_j) with c_0 = 1 exactly and
    log c_j = -log(1/c_j); every range the kernel's index picks holds its
    c_j within 2^-9; the constants and the table and frames limits are the
    ones csrc/precise.cu declares; device_log on a CPU tensor is the
    model."""
    tab = cuda_precise.log_table_np()
    assert tab.shape == (cuda_precise.LOG_TABLE_SIZE, 2) and tab.dtype == np.float64
    assert tuple(tab[0]) == (1.0, 0.0)
    np.testing.assert_array_equal(tab[:, 1], -np.log(tab[:, 0]))
    # the index of s = m for m sweeping [0.749, 1.498): r = m / c_j - 1 small
    m = np.linspace(1.0 - 2.0 ** -10, 1.5 - 2.0 ** -9, 100_001)[:-1]
    hi = (m.view(np.int64) >> 32).astype(np.int32)
    r = m * tab[((hi + 0x800) >> 12) & 0xFF, 0] - 1.0
    assert np.abs(r).max() <= 2.0 ** -9 * (1 + 1e-12)
    src = SOURCE.read_text()

    def const(name):
        return float.fromhex(re.search(rf"{name} = (-?0x[0-9a-fp.+-]+);", src).group(1))

    assert const("kLn2Hi") == cuda_precise.LN2_HI and const("kLn2Lo") == cuda_precise.LN2_LO
    assert tuple(const(f"kLog1pC{i}") for i in range(2, 6)) == cuda_precise.LOG1P_COEFFS
    assert int(re.search(r"kLogTableSize = (\d+);", src).group(1)) == cuda_precise.LOG_TABLE_SIZE
    assert (int(re.search(r"kMaxFrames = (\d+);", src).group(1))
            == cuda_precise.PRECISE_FRAMES_PER_LAUNCH)
    s = torch.tensor([1e-300, 0.5, 1.0, 3.0, 1e8], dtype=torch.float64)
    np.testing.assert_array_equal(cuda_precise.device_log(s).numpy(),
                                  cuda_precise.device_log_model(s.numpy()))
    assert profiling.counter("launches.device_log") == 0
