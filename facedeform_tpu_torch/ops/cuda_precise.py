"""Float64 growing-kernel deform step on the GPU: the wrappers of the
hand-written CUDA kernel in csrc/precise.cu, their plain PyTorch twins,
and the host side of the kernel's thin-plate log.

Counterpart of facedeform_tpu/ops/pallas_precise.py:
  evaluate_cuda_precise              <- evaluate_pallas_precise (_precise_kernel)
  evaluate_cuda_precise_frames       <- apply_frames' per-frame evaluate_precise
                                        for growing kernels (parallel/batched.py)
  evaluate_precise_reference         <- precise_eval.evaluate_precise composed
                                        with the tangent projection and falloff
  evaluate_precise_frames_reference  <- per-frame evaluate_precise_reference

The JAX kernel computes in double-float because the TPU has no float64;
the H100 has native fp64, so the kernel computes in double (see
ops/precise_eval.py).  One kernel serves both wrappers: a shot's frames
share d2, s and phi and take one launch per PRECISE_FRAMES_PER_LAUNCH
frames; one pose is the same kernel at one frame.  The wrappers run the
plain twins only for tensors on the CPU; for CUDA tensors they launch the
kernel or raise.  Each counts its launches in the counter launches.<wrapper>
(utils/profiling.py).
The kernel is built with the others by ops.cuda_eval.build().

The thin-plate basis takes the kernel's own log (Tang's table method, see
csrc/precise.cu): log_table() builds its 256-entry table here in numpy
float64, the kernel reads it by pointer, and device_log_model() is the
same reduction, table and polynomial in numpy, so the CPU tests hold the
device's arithmetic to np.log.  device_log() runs the device function
itself on a CUDA tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from facedeform_tpu_torch.config import PolyTerm, RBFKernel
from facedeform_tpu_torch.ops import cuda_eval
from facedeform_tpu_torch.ops.falloff import falloff_weight
from facedeform_tpu_torch.ops.precise_eval import evaluate_precise, inv_eps2_64, weights_64
from facedeform_tpu_torch.ops.tangent import project_to_tangents
from facedeform_tpu_torch.utils import profiling

for _name in ("device_log", "evaluate_cuda_precise", "evaluate_cuda_precise_frames"):
    profiling.count(f"launches.{_name}", 0)

# Frames per launch (kMaxFrames in csrc/precise.cu): each thread holds
# 3 FB double accumulators for each of its two vertices.
PRECISE_FRAMES_PER_LAUNCH = 8

# The device log's constants (kLn2Hi ... kLog1pC5 in csrc/precise.cu):
# ln 2 split so that k * LN2_HI is exact for |k| < 2^21, and the Taylor
# coefficients c2..c5 of log1p(r) = r + r^2 (c2 + r (c3 + r (c4 + r c5))).
LOG_TABLE_SIZE = 256
LN2_HI = float.fromhex("0x1.62e42fee00000p-1")
LN2_LO = float.fromhex("0x1.a39ef35793c76p-33")
LOG1P_COEFFS = (-0.5, 1.0 / 3.0, -0.25, 0.2)

_tables: dict = {}


def log_table_np() -> np.ndarray:
    """(LOG_TABLE_SIZE, 2) float64 rows (1/c_j, log c_j).

    The kernel reduces s = 2^k m with m in [1 - 2^-10, 1.5 - 2^-9) and
    picks j from bits 12..19 of s's high word, rounded: j in 1..127 covers
    m in 1 + [j - 1/2, j + 1/2) / 256, j in 128..255 covers
    m in 1/2 + [j - 1/2, j + 1/2) / 512, and j = 0 covers
    [1 - 2^-10, 1 + 2^-9), where c = 1 exactly, so near s = 1 the log is
    log1p(m - 1) with no table term.  c_j is each range's midpoint; log c_j
    is -log(1/c_j) of the stored reciprocal, so m / c_j - 1 and log c_j
    describe the same c."""
    j = np.arange(LOG_TABLE_SIZE, dtype=np.float64)
    c = np.where(j < 128, 1.0 + j / 256.0, 0.5 + j / 512.0)
    c[0] = 1.0
    inv = 1.0 / c
    return np.stack([inv, -np.log(inv)], axis=1)


def log_table(device) -> torch.Tensor:
    """log_table_np() on `device`, built once per device."""
    dev = torch.device(device)
    if dev not in _tables:
        _tables[dev] = profiling.to_device(log_table_np(), dev).contiguous()
    return _tables[dev]


def _split(a):
    """Veltkamp split of float64 a into two 26-bit halves."""
    t = 134217729.0 * a
    hi = t - (t - a)
    return hi, a - hi


def _fma_minus_one(a, b):
    """a * b - 1 rounded once (the kernel's fma(m, 1/c, -1)): the exact
    product's error term added to p - 1, which is exact for p in [1/2, 2]."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return (p - 1.0) + err


def device_log_model(s) -> np.ndarray:
    """The kernel's log_dev in numpy float64, for finite positive s: the
    same bit-level reduction, table and polynomial (the polynomial's and
    the k ln 2 terms' FMAs as a product and a sum)."""
    s = np.asarray(s, dtype=np.float64)
    sub = s < np.finfo(np.float64).tiny
    with np.errstate(over="ignore"):
        s = np.where(sub, s * 2.0 ** 54, s)
    k_adj = np.where(sub, -54, 0)
    bits = s.view(np.int64)
    hi = (bits >> 32).astype(np.int32)
    k = (hi - np.int32(0x3FE7F800)) >> 20
    m = (((hi - (k << 20)).astype(np.int64) << 32) | (bits & 0xFFFFFFFF)).view(np.float64)
    tab = log_table_np()[((hi + 0x800) >> 12) & (LOG_TABLE_SIZE - 1)]
    r = _fma_minus_one(m, tab[..., 0])
    c2, c3, c4, c5 = LOG1P_COEFFS
    q = ((c5 * r + c4) * r + c3) * r + c2
    poly = (r * r) * q + r
    kd = (k + k_adj).astype(np.float64)
    return (kd * LN2_HI + tab[..., 1]) + (kd * LN2_LO + poly)


def device_log(s: torch.Tensor) -> torch.Tensor:
    """The thin-plate basis's log of a float64 tensor of finite positive
    values: the kernel's device function on a CUDA tensor (one probe
    launch), device_log_model on a CPU tensor."""
    if s.device.type == "cpu":
        return torch.from_numpy(device_log_model(s.numpy()))
    if s.device.type != "cuda" or s.dtype != torch.float64:
        raise ValueError(f"device_log takes float64 CPU or CUDA tensors, got {s.dtype} "
                         f"on {s.device}")
    s = s.contiguous()
    out = torch.empty_like(s)
    cuda_eval.build()
    with torch.cuda.device(s.device):
        err = cuda_eval._lib.fd_log_probe(
            s.data_ptr(), out.data_ptr(), log_table(s.device).data_ptr(), s.numel(),
            torch.cuda.current_stream(s.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fd_log_probe launch failed: CUDA error {err}")
    profiling.count("launches.device_log")
    return out


def evaluate_precise_reference(
    model, points, dist2, gate, radius, falloffrate, kernel, term,
    strict_parity=False, frame=None,
):
    """Plain PyTorch twin of the precise kernel: (new_points (V, 3),
    falloff (V,)); the float64 displacement rounded to f32, then the f32
    tangent projection and falloff of the f32 path."""
    disp = evaluate_precise(model, points, kernel, term)
    if frame is not None:
        disp = project_to_tangents(*frame, disp)
    w, _ = falloff_weight(dist2, radius, falloffrate, strict_parity=strict_parity)
    w = w * gate
    return points + disp * w[:, None], w


def evaluate_precise_frames_reference(
    model, points, dist2, gate, radius, falloffrate, kernel, term,
    strict_parity=False, frame=None,
):
    """Plain PyTorch twin of the frames launch: evaluate_precise_reference
    per frame of a frames-stacked model (w_rbf (F, L, N, 3), w_poly
    (F, m, 3), lo words stacked the same way or None); returns ((F, V, 3)
    positions, (V,) falloff)."""
    outs = [evaluate_precise_reference(cuda_eval.frame_model(model, f), points, dist2, gate,
                                       radius, falloffrate, kernel, term, strict_parity, frame)
            for f in range(model.w_rbf.shape[0])]
    if not outs:
        raise ValueError("the model has no frames")
    return torch.stack([p for p, _ in outs]), outs[0][1]


def _launch(model, w_pack, w_poly, points, dist2, gate, radius, falloffrate, kernel,
            strict_parity, frame, counter) -> tuple[torch.Tensor, torch.Tensor]:
    """One kernel launch per PRECISE_FRAMES_PER_LAUNCH frames of the packed
    float64 weights (L, N, 3F) and tails (4, 3F); counts into the counter
    named `counter`."""
    v, n = points.shape[0], model.ctrl.shape[0]
    n_layers, n_frames = w_pack.shape[0], w_pack.shape[2] // 3
    out = torch.empty((n_frames, v, 3), dtype=torch.float32, device=points.device)
    falloff = torch.empty_like(dist2)
    if v == 0:
        return out, falloff
    cuda_eval.build()
    inv_eps2 = inv_eps2_64(model.eps).contiguous()
    table = log_table(points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    with torch.cuda.device(points.device):
        for f0 in range(0, n_frames, PRECISE_FRAMES_PER_LAUNCH):
            nf = min(PRECISE_FRAMES_PER_LAUNCH, n_frames - f0)
            err = cuda_eval._lib.fd_eval_precise(
                points.data_ptr(), dist2.data_ptr(), gate.data_ptr(),
                model.ctrl.data_ptr(), w_pack.data_ptr(), inv_eps2.data_ptr(),
                w_poly.data_ptr(), *cuda_eval._frame_ptrs(frame), out.data_ptr(),
                falloff.data_ptr(), table.data_ptr(), v, n, n_layers, n_frames, f0, nf,
                int(RBFKernel(kernel)), int(strict_parity), cuda_eval._r2(radius),
                float(falloffrate), stream,
            )
            if err != 0:
                raise RuntimeError(f"fd_eval_precise launch failed: CUDA error {err}")
            profiling.count(counter)
    return out, falloff


def _check_lo(model, dev) -> None:
    for name in ("w_rbf", "w_poly"):
        lo = getattr(model, f"{name}_lo")
        if lo is not None:
            cuda_eval._need(f"model.{name}_lo", lo, tuple(getattr(model, name).shape), dev)


def evaluate_cuda_precise(
    model, points, dist2, gate, radius, falloffrate,
    kernel: RBFKernel, term: PolyTerm, strict_parity: bool = False, frame=None,
):
    """Fused float64 deform step: (new_points (V, 3), falloff (V,)).

    Same arguments and returns as pallas_precise.evaluate_pallas_precise
    minus tile_v/interpret; model.w_rbf_lo / w_poly_lo (None on Krylov-
    route fits) are added to the weights in float64.  Every f32 tensor
    must be contiguous and on the points' device."""
    if points.device.type == "cpu":
        return evaluate_precise_reference(model, points, dist2, gate, radius, falloffrate,
                                          kernel, term, strict_parity, frame)
    if points.device.type != "cuda":
        raise ValueError(
            f"evaluate_cuda_precise takes CPU or CUDA tensors, got {points.device}")
    cuda_eval._check_inputs(model, points, dist2, gate, frame)
    _check_lo(model, points.device)
    w, wp = weights_64(model)                                 # (L, N, 3), (m, 3)
    w_poly = torch.zeros((4, 3), dtype=torch.float64, device=points.device)
    w_poly[: wp.shape[0]] = wp
    out, falloff = _launch(model, w.contiguous(), w_poly, points, dist2, gate, radius,
                           falloffrate, kernel, strict_parity, frame,
                           "launches.evaluate_cuda_precise")
    return out[0], falloff


def evaluate_cuda_precise_frames(
    batched_model, points, dist2, gate, radius, falloffrate,
    kernel: RBFKernel, term: PolyTerm, strict_parity: bool = False, frame=None,
):
    """All-frames fused float64 deform step: ((F, V, 3) positions, (V,)
    falloff).

    evaluate_cuda_frames' arguments for growing kernels: w_rbf (F, L, N, 3)
    and w_poly (F, m, 3) carry a leading frame axis, their lo words (or
    None) likewise, ctrl and eps are shared.  d2, s and phi are computed
    once per (vertex, control) for up to PRECISE_FRAMES_PER_LAUNCH frames;
    longer shots take one launch per chunk.  Frame f equals
    evaluate_cuda_precise of cuda_eval.frame_model(batched_model, f) bit for
    bit."""
    if points.device.type == "cpu":
        return evaluate_precise_frames_reference(batched_model, points, dist2, gate, radius,
                                                 falloffrate, kernel, term, strict_parity,
                                                 frame)
    if points.device.type != "cuda":
        raise ValueError(
            f"evaluate_cuda_precise_frames takes CPU or CUDA tensors, got {points.device}")
    cuda_eval._check_inputs(batched_model, points, dist2, gate, frame, frames=True)
    _check_lo(batched_model, points.device)
    w, wp = weights_64(batched_model)                          # (F, L, N, 3), (F, m, 3)
    n_frames = w.shape[0]
    w_poly = torch.zeros((n_frames, 4, 3), dtype=torch.float64, device=points.device)
    w_poly[:, : wp.shape[1]] = wp
    w_poly = w_poly.permute(1, 0, 2).reshape(4, 3 * n_frames).contiguous()
    return _launch(batched_model, cuda_eval.pack_frames(w), w_poly, points, dist2, gate,
                   radius, falloffrate, kernel, strict_parity, frame,
                   "launches.evaluate_cuda_precise_frames")
