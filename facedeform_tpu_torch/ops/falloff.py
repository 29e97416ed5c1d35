"""Capture falloff weighting (port of facedeform_tpu/ops/falloff.py).

Per vertex, as the reference's eval loop: skip if d2 > radius^2, else
falloff = (1 - min(d2 / radius^2, 1)) ^ rate.  Default mode clamps d2 >= 0;
strict_parity keeps the reference's d2 = -1 sentinel, which passes the
skip test and amplifies the displacement.
"""

from __future__ import annotations

import torch

from facedeform_tpu_torch.utils import profiling


def falloff_weight(
    dist2: torch.Tensor,
    radius,
    rate,
    strict_parity: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(weight (V,) f32, 0 where skipped; active (V,) bool)."""
    dist2 = dist2.float()
    r = profiling.to_device(radius, dist2.device, torch.float32)
    rate = profiling.to_device(rate, dist2.device, torch.float32)
    r2 = r * r
    if not strict_parity:
        dist2 = torch.clamp(dist2, min=0.0)
    active = dist2 <= r2
    ratio = torch.clamp(dist2 / r2, max=1.0)
    base = (1.0 - ratio) if strict_parity else torch.clamp(1.0 - ratio, min=0.0)
    w = torch.pow(base, rate)
    return torch.where(active, w, torch.zeros_like(w)), active
