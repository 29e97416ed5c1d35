"""Float64 growing-kernel deform step on the GPU: the wrapper of the
hand-written CUDA kernel in csrc/precise.cu and its plain PyTorch twin.

Counterpart of facedeform_tpu/ops/pallas_precise.py:
  evaluate_cuda_precise       <- evaluate_pallas_precise (_precise_kernel)
  evaluate_precise_reference  <- precise_eval.evaluate_precise composed
                                 with the tangent projection and falloff

The JAX kernel computes in double-float because the TPU has no float64;
the H100 has native fp64, so the kernel computes in double (see
ops/precise_eval.py).  The wrapper runs the plain twin only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.  It counts its
launches in evaluate_cuda_precise.launches.  The kernel is built with the
others by ops.cuda_eval.build().
"""

from __future__ import annotations

import torch

from facedeform_tpu_torch.config import PolyTerm, RBFKernel
from facedeform_tpu_torch.ops import cuda_eval
from facedeform_tpu_torch.ops.falloff import falloff_weight
from facedeform_tpu_torch.ops.precise_eval import evaluate_precise, inv_eps2_64, weights_64
from facedeform_tpu_torch.ops.tangent import project_to_tangents


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
    dev = points.device
    if model.w_rbf_lo is not None:
        cuda_eval._need("model.w_rbf_lo", model.w_rbf_lo, tuple(model.w_rbf.shape), dev)
    if model.w_poly_lo is not None:
        cuda_eval._need("model.w_poly_lo", model.w_poly_lo, tuple(model.w_poly.shape), dev)
    kernel = RBFKernel(kernel)
    v, n = points.shape[0], model.ctrl.shape[0]
    out = torch.empty_like(points)
    falloff = torch.empty_like(dist2)
    if v == 0:
        return out, falloff
    cuda_eval.build()
    w, wp = weights_64(model)
    w_poly = torch.zeros((4, 3), dtype=torch.float64, device=dev)
    w_poly[: wp.shape[0]] = wp
    inv_eps2 = inv_eps2_64(model.eps).contiguous()
    w = w.contiguous()
    with torch.cuda.device(dev):
        err = cuda_eval._lib.fd_eval_precise(
            points.data_ptr(), dist2.data_ptr(), gate.data_ptr(),
            model.ctrl.data_ptr(), w.data_ptr(), inv_eps2.data_ptr(),
            w_poly.data_ptr(), *cuda_eval._frame_ptrs(frame), out.data_ptr(),
            falloff.data_ptr(), v, n, model.w_rbf.shape[0], int(kernel),
            int(strict_parity), cuda_eval._r2(radius), float(falloffrate),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fd_eval_precise launch failed: CUDA error {err}")
    evaluate_cuda_precise.launches += 1
    return out, falloff


evaluate_cuda_precise.launches = 0
