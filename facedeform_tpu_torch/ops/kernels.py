"""Radial basis kernel zoo (port of facedeform_tpu/ops/kernels.py).

Kernels are functions of the squared distance, normalized by the radius
eps; eps broadcasts against the trailing control axis of d2.  The
thin-plate log is torch.log: the JAX package's precise_log exists only
because the TPU's hardware log is loose, which CPU and CUDA logs are not.
"""

from __future__ import annotations

import torch

from facedeform_tpu_torch.config import RBFKernel

# Floor on squared distances inside logs/square-roots.
_TINY = 1e-30


def apply_kernel(kernel: RBFKernel, d2: torch.Tensor, eps) -> torch.Tensor:
    """phi(r/eps) from squared distances d2 (..., N); eps is a scalar, (N,)
    or (L, 1, N).  d2 is clamped to >= 0."""
    kernel = RBFKernel(kernel)
    d2 = torch.clamp(d2, min=0.0)
    s = d2 / (eps * eps)  # (r/eps)^2
    if kernel == RBFKernel.GAUSSIAN:
        return torch.exp(-s)
    if kernel == RBFKernel.THIN_PLATE:
        # (r/eps)^2 log(r/eps) = 0.5 s log s; phi(0) = 0 by limit
        return torch.where(
            s > _TINY, 0.5 * s * torch.log(torch.clamp(s, min=_TINY)),
            torch.zeros_like(s),
        )
    if kernel == RBFKernel.MULTIQUADRIC:
        return torch.sqrt(1.0 + s)
    if kernel == RBFKernel.INVERSE_MULTIQUADRIC:
        return torch.rsqrt(1.0 + s)
    if kernel == RBFKernel.LINEAR:
        return torch.sqrt(s)
    if kernel == RBFKernel.CUBIC:
        return s * torch.sqrt(s)
    if kernel == RBFKernel.WENDLAND_C2:
        t = torch.sqrt(s)
        base = torch.clamp(1.0 - t, min=0.0)
        b2 = base * base
        return b2 * b2 * (4.0 * t + 1.0)
    raise ValueError(f"unknown kernel {kernel!r}")


def phi_prime_s(kernel: RBFKernel, s: torch.Tensor) -> torch.Tensor:
    """d phi / d s with s = (r/eps)^2, finite everywhere (incl. s = 0); the
    closed forms take the r -> 0 limits (see the JAX package's note)."""
    kernel = RBFKernel(kernel)
    s = torch.clamp(s, min=0.0)
    zero = torch.zeros_like(s)
    if kernel == RBFKernel.GAUSSIAN:
        return -torch.exp(-s)
    if kernel == RBFKernel.THIN_PLATE:
        return torch.where(
            s > _TINY, 0.5 * (torch.log(torch.clamp(s, min=_TINY)) + 1.0), zero
        )
    if kernel == RBFKernel.MULTIQUADRIC:
        return 0.5 * torch.rsqrt(1.0 + s)
    if kernel == RBFKernel.INVERSE_MULTIQUADRIC:
        q = torch.rsqrt(1.0 + s)
        return -0.5 * q / (1.0 + s)
    if kernel == RBFKernel.LINEAR:
        return torch.where(
            s > _TINY, 0.5 * torch.rsqrt(torch.clamp(s, min=_TINY)), zero
        )
    if kernel == RBFKernel.CUBIC:
        return 1.5 * torch.sqrt(s)
    if kernel == RBFKernel.WENDLAND_C2:
        base = torch.clamp(1.0 - torch.sqrt(s), min=0.0)
        return -10.0 * base * base * base
    raise ValueError(f"unknown kernel {kernel!r}")


def kernel_is_compact(kernel: RBFKernel) -> bool:
    """True if phi has compact support (vanishes for r > eps)."""
    return RBFKernel(kernel) == RBFKernel.WENDLAND_C2


def kernel_is_pd(kernel: RBFKernel) -> bool:
    """True if the kernel matrix is positive definite for distinct points
    (gaussian/IMQ/wendland); the rest are only conditionally PD."""
    return RBFKernel(kernel) in (
        RBFKernel.GAUSSIAN,
        RBFKernel.INVERSE_MULTIQUADRIC,
        RBFKernel.WENDLAND_C2,
    )


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """All-pairs squared distances (V, 3), (N, 3) -> (V, N) from exact
    per-coordinate differences.  Not the ||x||^2 + ||y||^2 - 2 x.y matmul
    form, which cancels catastrophically in f32 away from the origin."""
    if x.shape[-1] != 3 or y.shape[-1] != 3:
        # 3-D only: the unrolled form would silently drop extra coordinates
        raise ValueError(
            f"pairwise_sqdist is specialized to 3-D points; got trailing "
            f"dims {x.shape[-1]} and {y.shape[-1]}"
        )
    dx = x[:, 0:1] - y[None, :, 0]
    dy = x[:, 1:2] - y[None, :, 1]
    dz = x[:, 2:3] - y[None, :, 2]
    return dx * dx + dy * dy + dz * dz


def nearest_neighbor_dist(pts: torch.Tensor) -> torch.Tensor:
    """Per-point distance to its nearest *other* point; shape (N,).  A
    single-point rig has no neighbor and gets unit distance."""
    n = pts.shape[0]
    if n == 1:
        return torch.ones((1,), dtype=pts.dtype, device=pts.device)
    d2 = pairwise_sqdist(pts, pts)
    d2.fill_diagonal_(float("inf"))  # d2 is a fresh tensor: in place is safe
    return torch.sqrt(torch.min(d2, dim=-1).values)
