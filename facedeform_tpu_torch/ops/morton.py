"""Morton (Z-order) codes and spatial sort (port of
facedeform_tpu/ops/morton.py).  The culled eval kernel sorts its controls
with them; int64 holds the 30-bit codes, and the sort is stable so ties
keep the JAX package's order."""

from __future__ import annotations

import torch


def _expand_bits10(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x so consecutive bits are 3 apart."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int64) for (V, 3) points, normalized to their bbox."""
    pts = points.float()
    lo = torch.min(pts, dim=0).values
    hi = torch.max(pts, dim=0).values
    span = torch.clamp(hi - lo, min=1e-12)
    # a true division: `1023.0 / span` would run as reciprocal(span) * 1023,
    # one rounding more, and move bbox-maximum points across a cell edge
    scale = torch.full_like(span, 1023.0) / span
    q = torch.clamp((pts - lo) * scale, 0.0, 1023.0).to(torch.int64)
    return (
        _expand_bits10(q[:, 0])
        | (_expand_bits10(q[:, 1]) << 1)
        | (_expand_bits10(q[:, 2]) << 2)
    )


def spatial_order(points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(perm, inv_perm): points[perm] is Z-order sorted; x[inv_perm] undoes it."""
    perm = torch.argsort(morton_codes(points), stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return perm, inv
