"""Tangent-space projection of displacements (port of
facedeform_tpu/ops/tangent.py).

The reference's oblique projection, verbatim: with unit u, v, n and
B = M^T M for rows M = [u; v; n], a1 = normalize(u B), a2 = normalize(v B),
disp' = a1 (disp . a1) + a2 (disp . a2).
"""

from __future__ import annotations

import torch


def _normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return x * torch.rsqrt(torch.clamp(torch.sum(x * x, dim=-1, keepdim=True), min=eps))


def _projection_axes(u: torch.Tensor, v: torch.Tensor, n: torch.Tensor):
    """The reference's (a1, a2) oblique projection axes, (V, 3) each."""
    u, v, n = (_normalize(t.float()) for t in (u, v, n))

    def dot_b(x):
        # x B = (x.u) u + (x.v) v + (x.n) n, without the (V, 3, 3) tensor
        return (
            torch.sum(x * u, -1, keepdim=True) * u
            + torch.sum(x * v, -1, keepdim=True) * v
            + torch.sum(x * n, -1, keepdim=True) * n
        )

    return _normalize(dot_b(u)), _normalize(dot_b(v))


def project_to_tangents(u, v, n, disp: torch.Tensor) -> torch.Tensor:
    """Project (V, 3) displacements onto the per-vertex tangent plane given
    (V, 3) tangent-u, tangent-v and normal attributes."""
    a1, a2 = _projection_axes(u, v, n)
    da1 = torch.sum(disp * a1, -1, keepdim=True)
    da2 = torch.sum(disp * a2, -1, keepdim=True)
    return a1 * da1 + a2 * da2


def tangent_projection_matrix(u, v, n) -> torch.Tensor:
    """Per-vertex matrix T with T @ d == project_to_tangents(u, v, n, d):
    T = a1 a1^T + a2 a2^T, (V, 3, 3).  Composes the projection into the
    displacement Jacobian (ops/jacobian.py), the frame attributes being
    per-vertex data, not fields."""
    a1, a2 = _projection_axes(u, v, n)
    return a1[:, :, None] * a1[:, None, :] + a2[:, :, None] * a2[:, None, :]
