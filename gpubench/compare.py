"""The comparison that decides `correct`, and the measures it is made of.

A loop's `compare` (loops/<loop>.py) reads its numbers with these
measures; `verdict` holds them against the cell's limits
(limits/<cell>.json).  The same `verdict` judges a run of the program and
a control's readings, so a control that reads past a limit comes out not
correct the way a faulty program would.
"""

from __future__ import annotations

import numpy as np
import torch


def as64(x, device) -> torch.Tensor:
    """x (numpy or torch) as float64 on device."""
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).to(
        device=device, dtype=torch.float64)


def p_err(got, want, rest) -> float:
    """max |got - want| over max |want - rest|: the error of deformed
    positions as a share of the largest displacement."""
    scale = float((want - rest).abs().max())
    return float((got - want).abs().max()) / max(scale, 1e-30)


def max_abs(got, want) -> float:
    return float((got - want).abs().max())


def rel_max(got, want) -> float:
    """max |got - want| over max |want|; inf where nothing was produced."""
    if got is None:
        return float("inf")
    return float((got - want).abs().max() / want.abs().max())


def verdict(numbers: dict, limits: dict, failed: int = 0) -> tuple[dict, bool]:
    """({number: {"value", "limit"}}, correct): correct when every request
    came back, every limited number was read, and each is finite and
    within its limit."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    correct = (bool(checks) and failed == 0 and set(numbers) == set(limits)
               and all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    return checks, correct
