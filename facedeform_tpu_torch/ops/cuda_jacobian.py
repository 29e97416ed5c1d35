"""Displacement-field Jacobian on the GPU: wrappers of the hand-written
CUDA kernel in csrc/jacobian.cu and its plain PyTorch twin.

Counterpart of facedeform_tpu/ops/pallas_jacobian.py:
  jacobian_cuda               <- jacobian_pallas          (_jac_kernel)
  jacobian_cuda_frames        <- jacobian_pallas_frames   (_jac_kernel)
  jacobian_frames_reference   <- per-frame displacement_jacobian
(the single-pose twin is ops.jacobian.displacement_jacobian itself).

A wrapper runs the plain version only for tensors on the CPU.  For CUDA
tensors it launches the kernel or raises; it never falls back.  Each
wrapper counts its launches in its `launches` attribute.  The kernel is
built with the eval kernels (ops.cuda_eval.build) at first use.
"""

from __future__ import annotations

import torch

from facedeform_tpu_torch.config import PolyTerm, RBFKernel
from facedeform_tpu_torch.ops import cuda_eval
from facedeform_tpu_torch.ops.jacobian import displacement_jacobian

# Frames per launch (kMaxJacFrames in csrc/jacobian.cu): 12 moments per
# frame live in registers, so the wrapper loops over chunks.  8 holds
# without spills (128 registers) and ran F = 8 in 7.34 ms against 8.85 ms
# as two 4-frame launches (1M x 1k, H100).
JAC_FRAMES_PER_LAUNCH = 8


def jacobian_frames_reference(model, points, kernel: RBFKernel, term: PolyTerm) -> torch.Tensor:
    """Plain twin of the frames entry: (F, V, 3, 3), one
    displacement_jacobian per frame of a frames-stacked model."""
    return torch.stack([
        displacement_jacobian(cuda_eval.frame_model(model, f), points, kernel, term)
        for f in range(model.w_rbf.shape[0])
    ])


def _launch(ctrl, w_rbf, eps, w_poly, points, kernel, term, counter) -> torch.Tensor:
    """w_rbf (F, L, N, 3), w_poly (F, m, 3) -> (F, V, 3, 3) on the card;
    one launch per JAC_FRAMES_PER_LAUNCH frames, each counted on
    `counter.launches`."""
    dev = points.device
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (V, 3), got {tuple(points.shape)}")
    if w_rbf.ndim != 4 or w_poly.ndim != 3:
        raise ValueError(f"weights have shapes {tuple(w_rbf.shape)}, {tuple(w_poly.shape)}")
    n_frames, n_layers, n, _ = w_rbf.shape
    v = points.shape[0]
    cuda_eval._need("points", points, (v, 3), dev)
    cuda_eval._need("model.ctrl", ctrl, (n, 3), dev)
    cuda_eval._need("model.eps", eps, (n_layers, n), dev)
    cuda_eval._need("model.w_rbf", w_rbf, (n_frames, n_layers, n, 3), dev)
    cuda_eval._need("model.w_poly", w_poly, (n_frames, w_poly.shape[1], 3), dev)
    if n == 0 or n_layers == 0 or n_frames == 0:
        raise ValueError("the model has no controls or no frames")
    out = torch.empty((n_frames, v, 3, 3), dtype=torch.float32, device=dev)
    if v == 0:
        return out
    cuda_eval.build()
    w_pack = cuda_eval.pack_frames(w_rbf)
    inv_eps2 = cuda_eval._inv_eps2(eps)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for f0 in range(0, n_frames, JAC_FRAMES_PER_LAUNCH):
            nf = min(JAC_FRAMES_PER_LAUNCH, n_frames - f0)
            err = cuda_eval._lib.fd_jacobian(
                points.data_ptr(), ctrl.data_ptr(), w_pack.data_ptr(),
                inv_eps2.data_ptr(), out.data_ptr(), v, n, n_layers, n_frames,
                f0, nf, int(RBFKernel(kernel)), stream,
            )
            if err != 0:
                raise RuntimeError(f"fd_jacobian launch failed: CUDA error {err}")
            counter.launches += 1
    if PolyTerm(term) == PolyTerm.LINEAR and w_poly.shape[1] >= 4:
        # poly_basis [1, x, y, z]: d(P c)_a / d x_b = w_poly[1 + b, a]
        out += w_poly[:, 1:4].transpose(1, 2)[:, None]
    return out


def _on_card(points, name) -> bool:
    if points.device.type == "cpu":
        return False
    if points.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {points.device}")
    return True


def jacobian_cuda(model, points, kernel: RBFKernel, term: PolyTerm) -> torch.Tensor:
    """Fused displacement Jacobian at points; (V, 3, 3).  Drop-in for
    ops.jacobian.displacement_jacobian (f32 summation order apart)."""
    if not _on_card(points, "jacobian_cuda"):
        return displacement_jacobian(model, points, kernel, term)
    return _launch(model.ctrl, model.w_rbf[None], model.eps, model.w_poly[None],
                   points, kernel, term, jacobian_cuda)[0]


jacobian_cuda.launches = 0


def jacobian_cuda_frames(model, points, kernel: RBFKernel, term: PolyTerm) -> torch.Tensor:
    """All-frames fused Jacobian: model.w_rbf (F, L, N, 3), model.w_poly
    (F, m, 3); returns (F, V, 3, 3).  Distances and phi' are computed once
    per (vertex, control) for up to JAC_FRAMES_PER_LAUNCH frames."""
    if not _on_card(points, "jacobian_cuda_frames"):
        return jacobian_frames_reference(model, points, kernel, term)
    return _launch(model.ctrl, model.w_rbf, model.eps, model.w_poly,
                   points, kernel, term, jacobian_cuda_frames)


jacobian_cuda_frames.launches = 0
