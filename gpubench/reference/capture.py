"""Capture and falloff, worked out again (the reference SOP's capture.cpp
semantics as the oracle states them):

* each marker seeds the mesh vertex nearest to it;
* a vertex is captured when it lies within max_edges edge hops of a seed
  (the union over marker classes of per-class floods is the flood from
  every seed);
* a captured vertex's squared distance is the least over the rig's
  points (the rig has no faces); an uncaptured one keeps 0 and so deforms
  fully;
* falloff = (1 - min(d2 / r^2, 1)) ^ rate where d2 <= r^2, else 0.
"""

from __future__ import annotations

import torch

from gpubench.reference.prec import Prec

_ROWS = 1 << 15


def _sqdist_min(x: torch.Tensor, y: torch.Tensor, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(least squared distance from each x to y, its index), by exact
    differences, x in blocks of rows."""
    y = y.to(dtype)
    step = max(1, (1 << 24) // max(1, y.shape[0]))
    vals, idx = [], []
    for lo in range(0, x.shape[0], step):
        d = x[lo:lo + step].to(dtype)[:, None, :] - y[None]
        v, i = (d * d).sum(-1).min(1)
        vals.append(v)
        idx.append(i)
    return torch.cat(vals), torch.cat(idx)


def captured_mask(points: torch.Tensor, faces: torch.Tensor, rest: torch.Tensor,
                  max_edges: int) -> torch.Tensor:
    """(V,) bool: vertices within max_edges edge hops of the vertex nearest
    some marker."""
    _, seeds = _sqdist_min(rest, points, torch.float64)
    k = faces.shape[1]
    src = torch.cat([faces[:, i] for i in range(k)]).long()
    dst = torch.cat([faces[:, (i + 1) % k] for i in range(k)]).long()
    src, dst = torch.cat([src, dst]), torch.cat([dst, src])
    seen = torch.zeros(points.shape[0], dtype=torch.bool, device=points.device)
    seen[seeds] = True
    for _ in range(max(int(max_edges), 1)):
        nxt = seen.clone()
        nxt[dst[seen[src]]] = True
        seen = nxt
    return seen


def capture_dist2(points: torch.Tensor, faces: torch.Tensor, rest: torch.Tensor,
                  max_edges: int, prec: Prec) -> torch.Tensor:
    """(V,) squared capture distances in prec.real: 0 where uncaptured."""
    mask = captured_mask(points, faces, rest, max_edges)
    d2 = torch.zeros(points.shape[0], dtype=prec.real, device=points.device)
    idx = torch.nonzero(mask)[:, 0]
    for lo in range(0, idx.shape[0], _ROWS):
        sub = idx[lo:lo + _ROWS]
        d2[sub] = _sqdist_min(points[sub], rest, prec.real)[0]
    return d2


def falloff(d2: torch.Tensor, radius: float, rate: float, prec: Prec) -> torch.Tensor:
    """Per-vertex falloff weight (strict_parity off: d2 clamped at 0)."""
    r = max(float(radius), 0.01)
    rate = max(float(rate), 0.0)
    if prec.falloff_bf16:
        d2 = d2.to(torch.bfloat16)
    d2 = torch.clamp(d2, min=0.0)
    r2 = r * r
    base = torch.clamp(1.0 - torch.clamp(d2 / r2, max=1.0), min=0.0)
    w = torch.where(d2 <= r2, base ** rate, torch.zeros_like(base))
    return w.to(prec.real)
