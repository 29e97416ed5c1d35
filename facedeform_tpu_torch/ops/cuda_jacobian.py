"""Displacement-field Jacobian on the GPU: wrappers of the hand-written
CUDA kernel in csrc/jacobian.cu and its plain PyTorch twin.

Counterpart of facedeform_tpu/ops/pallas_jacobian.py:
  jacobian_cuda               <- jacobian_pallas          (_jac_kernel)
  jacobian_cuda_frames        <- jacobian_pallas_frames   (_jac_kernel)
  jacobian_frames_reference   <- per-frame displacement_jacobian
  jacobian_packed_reference   <- the kernel's function, plain: J from
                                 the weight columns
(the single-pose twin is ops.jacobian.displacement_jacobian itself).

The TPU kernel contracts g = 2 phi'(s) / eps^2 with packed moment columns
[w_a, w_a c_b] and forms J = A x - T.  Under the tensor cores' 3xTF32
(ops/tf32.py) that difference cancels past the kernel's tolerance, so this
kernel re-centers on each vertex: it contracts D_b = phi'(s) (c_b - x_b),
which it computes, with the weight columns U = -2 w_a / eps^2 (L, N, 3F),
frame f's in columns 3f .. 3f + 2 (weight_columns).  The wrapper hands it U
pre-split into fragments, with the controls and 1/eps^2, per group of 8
controls (_pack_launch).

A wrapper runs the plain version only for tensors on the CPU.  For CUDA
tensors it launches the kernel or raises; it never falls back.  Each
wrapper counts its launches in the counter launches.<wrapper>
(utils/profiling.py).  The kernel is
built with the eval kernels (ops.cuda_eval.build) at first use.
"""

from __future__ import annotations

import torch

from facedeform_tpu_torch.config import PolyTerm, RBFKernel
from facedeform_tpu_torch.ops import cuda_eval, tf32
from facedeform_tpu_torch.ops.jacobian import displacement_jacobian
from facedeform_tpu_torch.ops.kernels import phi_prime_s
from facedeform_tpu_torch.utils import profiling
from facedeform_tpu_torch.utils.precision import highest_precision

for _name in ("jacobian_cuda", "jacobian_cuda_frames"):
    profiling.count(f"launches.{_name}", 0)

# Frames per launch: 3 weight columns a frame in at most 3 n8 tiles of the
# mma (kMaxJacTiles in csrc/jacobian.cu); the wrapper loops over chunks.
JAC_FRAMES_PER_LAUNCH = 8
# n8 tiles of weight columns the kernel is instantiated for (NT).
JAC_TILES = (1, 2, 3)


def jacobian_frames_reference(model, points, kernel: RBFKernel, term: PolyTerm) -> torch.Tensor:
    """Plain twin of the frames entry: (F, V, 3, 3), one
    displacement_jacobian per frame of a frames-stacked model."""
    return torch.stack([
        displacement_jacobian(cuda_eval.frame_model(model, f), points, kernel, term)
        for f in range(model.w_rbf.shape[0])
    ])


def weight_columns(w_rbf: torch.Tensor, inv_eps2: torch.Tensor) -> torch.Tensor:
    """(F, L, N, 3) weights + (L, N) 1/eps^2 -> (L, N, 3F) columns U =
    -2 w_a / eps^2, frame f's in columns 3f .. 3f + 2."""
    f, n_layers, n, _ = w_rbf.shape
    u = w_rbf * (-2.0 * inv_eps2)[None, :, :, None]
    return u.permute(1, 2, 0, 3).reshape(n_layers, n, 3 * f)


def _matmul(a, b) -> torch.Tensor:
    with highest_precision():
        return a @ b


def _tail(jac, w_poly, term) -> torch.Tensor:
    if PolyTerm(term) == PolyTerm.LINEAR and w_poly.shape[1] >= 4:
        # poly_basis [1, x, y, z]: d(P c)_a / d x_b = w_poly[1 + b, a]
        jac = jac + w_poly[:, 1:4].transpose(1, 2)[:, None]
    return jac


def jacobian_packed_reference(model, points, kernel: RBFKernel, term: PolyTerm,
                              contract=None, chunk: int = 16384) -> torch.Tensor:
    """The kernel's function, plain: a frames-stacked model (w_rbf (F, L,
    N, 3), w_poly (F, m, 3)) -> (F, V, 3, 3).  Per layer and b the tile
    D_b = phi'(s) (c_b - x_b), s = |c - x|^2 / eps^2, contracted with the
    weight columns U_l, J[a][b] = sum_l D_b U_l, plus the tail.
    contract(D, U) forms the contraction: by default an f32 matmul at full
    precision; tf32.matmul_3xtf32 models the kernel's tensor-core passes."""
    contract = contract or _matmul
    inv_eps2 = cuda_eval._inv_eps2(model.eps)
    u = weight_columns(model.w_rbf, inv_eps2)
    f_n = model.w_rbf.shape[0]
    outs = []
    for pts in torch.split(points.float(), chunk):
        d = model.ctrl[None] - pts[:, None]                              # (v, N, 3)
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        acc = [0.0, 0.0, 0.0]
        for layer in range(u.shape[0]):
            q = phi_prime_s(kernel, d2 * inv_eps2[layer])
            acc = [acc[b] + contract(q * d[..., b], u[layer]) for b in range(3)]
        jac = torch.stack(acc, dim=-1)                                   # (v, 3F, 3)
        outs.append(jac.reshape(-1, f_n, 3, 3).transpose(0, 1))
    return _tail(torch.cat(outs, dim=1), model.w_poly, term)


def _pack_launch(ctrl, u, inv_eps2, f0: int, nf: int):
    """Operands of the launch of frames [f0, f0 + nf): the stream (T, 32 +
    8 L + 128 L NT), per group of 8 controls (x, y, z, 0) each, the L x 8
    1/eps^2 (1 past N: finite phi' on zero columns), then per layer the
    weight columns 3 f0 .. 3 (f0 + nf) zero-padded to NT n8 tiles, split
    into tf32 words in mma fragment order; and NT."""
    n_layers, n, _ = u.shape
    nt = tf32.n_tiles(3 * nf, JAC_TILES)
    npad = -(-n // 8) * 8
    c4 = ctrl.new_zeros((npad, 4))
    c4[:n, :3] = ctrl
    ie = ctrl.new_ones((n_layers, npad))
    ie[:, :n] = inv_eps2
    uc = u.new_zeros((n_layers, npad, 8 * nt))
    uc[:, :n, :3 * nf] = u[:, :, 3 * f0:3 * (f0 + nf)]
    frags = tf32.mma_fragments(uc)                           # (L, T, NT, 32, 4)
    t = npad // 8
    stream = torch.cat([c4.reshape(t, 32),
                        ie.reshape(n_layers, t, 8).transpose(0, 1).reshape(t, 8 * n_layers),
                        frags.transpose(0, 1).reshape(t, -1)], dim=1)
    return stream.contiguous(), nt


def _launch(ctrl, w_rbf, eps, w_poly, points, kernel, term, counter) -> torch.Tensor:
    """w_rbf (F, L, N, 3), w_poly (F, m, 3) -> (F, V, 3, 3) on the card;
    one launch per JAC_FRAMES_PER_LAUNCH frames, each counted on
    the counter named `counter`."""
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
    inv_eps2 = cuda_eval._inv_eps2(eps)
    u = weight_columns(w_rbf, inv_eps2)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for f0 in range(0, n_frames, JAC_FRAMES_PER_LAUNCH):
            nf = min(JAC_FRAMES_PER_LAUNCH, n_frames - f0)
            stream_t, nt = _pack_launch(ctrl, u, inv_eps2, f0, nf)
            err = cuda_eval._lib.fd_jacobian(
                points.data_ptr(), stream_t.data_ptr(), out.data_ptr(), v,
                stream_t.shape[0], n_layers, n_frames, f0, nf, nt,
                int(RBFKernel(kernel)), stream,
            )
            if err != 0:
                raise RuntimeError(f"fd_jacobian launch failed: CUDA error {err}")
            profiling.count(counter)
    return _tail(out, w_poly, term)


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
                   points, kernel, term, "launches.jacobian_cuda")[0]


def jacobian_cuda_frames(model, points, kernel: RBFKernel, term: PolyTerm) -> torch.Tensor:
    """All-frames fused Jacobian: model.w_rbf (F, L, N, 3), model.w_poly
    (F, m, 3); returns (F, V, 3, 3).  Distances and phi' are computed once
    per (vertex, control) for up to JAC_FRAMES_PER_LAUNCH frames."""
    if not _on_card(points, "jacobian_cuda_frames"):
        return jacobian_frames_reference(model, points, kernel, term)
    return _launch(model.ctrl, model.w_rbf, model.eps, model.w_poly,
                   points, kernel, term, "launches.jacobian_cuda_frames")
