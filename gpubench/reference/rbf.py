"""The RBF fit, eval and normal transport, worked out again (the float64
oracle's formulas, tests/oracle.py):

* QNN: a gaussian, eps_i = min(q nn_i, z mean(nn)) with nn_i the distance
  to the nearest other marker (floored at 1e-4 of the largest), no ridge;
  KERNEL: eps = radius, ridge lam on the diagonal;
* the system [[phi + ridge, P], [P^T, -1e-8 I]] [w; c] = [delta; 0] with
  the linear tail P = [1, x, y, z];
* disp(x) = sum_i w_i phi(|x - c_i|^2 / eps_i^2) + c . [1, x, y, z];
* the applied map y = x + f(x) disp(x), f the falloff; normals go
  through F = I + f J, J = d disp / dx, as n' ~ cof(F) n, normalised.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from gpubench.reference.prec import Prec, mm

_PAIRS = 1 << 23          # (vertex, control) pairs a block holds
_TINY = 1e-300


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A basis function of s = |x - c|^2 / eps^2 and its derivative in s.
    `ops`: the operations phi(s) takes (a transcendental one, a multiply
    or add one), which the roofline counts read; `cutoff_s`: for a
    decaying basis, the s past which phi < 1e-12 (the port's exactness
    cutoff; the pairs the eval needs lie within it), None for a growing
    one."""

    name: str
    phi: Callable
    dphi_ds: Callable
    ops: int
    cutoff_s: Optional[float] = None


def _tiny(s: torch.Tensor) -> float:
    return _TINY if s.dtype == torch.float64 else 1e-37


def _tps(s):
    t = _tiny(s)
    return torch.where(s > t, 0.5 * s * torch.log(torch.clamp(s, min=t)), torch.zeros_like(s))


def _tps_ds(s):
    t = _tiny(s)
    return torch.where(s > t, 0.5 * (torch.log(torch.clamp(s, min=t)) + 1.0),
                       torch.zeros_like(s))


#: the bases of the configurations, by the program's RBFKernel names; a
#: reference file of a new family adds its own to a copy of this table
KERNELS = {
    "GAUSSIAN": Kernel("gaussian", lambda s: torch.exp(-s), lambda s: -torch.exp(-s), 2, 27.7),
    "THIN_PLATE": Kernel("thin_plate", _tps, _tps_ds, 5),
}


@dataclasses.dataclass(frozen=True)
class Model:
    ctrl: torch.Tensor     # (N, 3)
    eps: torch.Tensor      # (N,)
    w: torch.Tensor        # (N, 3)
    tail: torch.Tensor     # (4, 3): [1, x, y, z] -> displacement
    kernel: Kernel


def _sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = x[:, None, :] - y[None]
    return (d * d).sum(-1)


def qnn_radii(ctrl: torch.Tensor, q: float, z: float) -> torch.Tensor:
    d2 = _sq(ctrl, ctrl)
    d2.fill_diagonal_(float("inf"))
    nn = torch.sqrt(d2.min(1).values)
    nn = torch.clamp(nn, min=1e-4 * max(float(nn.max()), 1e-6))
    return torch.minimum(q * nn, z * nn.mean())


def fit(rest: torch.Tensor, pose: torch.Tensor, cfg: dict, params: dict, prec: Prec,
        kernels: dict = KERNELS) -> Model:
    """The model of one pose.  cfg: {"model": "QNN"|"KERNEL", "kernel": a
    key of `kernels`}; params: the node's DeformParams fields."""
    ctrl = rest.to(prec.real)
    delta = pose.to(prec.real) - ctrl
    n = ctrl.shape[0]
    if cfg["model"] == "QNN":
        kernel = kernels["GAUSSIAN"]
        eps = qnn_radii(ctrl, max(params["qcoef"], 0.1), max(params["zcoef"], 0.1))
        ridge = 0.0
    elif cfg["model"] == "KERNEL":
        kernel = kernels[cfg["kernel"]]
        eps = torch.full((n,), max(params["radius"], 0.01), dtype=prec.real, device=ctrl.device)
        ridge = max(params["lam"], 0.01)
    else:
        raise ValueError(f"unsupported model {cfg['model']!r}")
    if cfg.get("term", "LINEAR") != "LINEAR":
        raise ValueError("the reference carries the linear tail only")
    phi = kernel.phi(_sq(ctrl, ctrl) / (eps * eps)[None]) + ridge * torch.eye(
        n, dtype=prec.real, device=ctrl.device)
    p = torch.cat([torch.ones(n, 1, dtype=prec.real, device=ctrl.device), ctrl], 1)
    a = torch.cat([torch.cat([phi, p], 1),
                   torch.cat([p.T, -1e-8 * torch.eye(4, dtype=prec.real, device=ctrl.device)],
                             1)], 0)
    b = torch.cat([delta, torch.zeros(4, 3, dtype=prec.real, device=ctrl.device)])
    x = torch.linalg.solve(a, b)
    return Model(ctrl=ctrl, eps=eps, w=x[:n], tail=x[n:], kernel=kernel)


def _rows(n_ctrl: int) -> int:
    return max(256, _PAIRS // max(1, n_ctrl))


def evaluate(models: list, points: torch.Tensor, prec: Prec) -> torch.Tensor:
    """(F, V, 3) displacements of F models that share ctrl and eps (one
    phi block serves every frame)."""
    ctrl, eps, kernel = models[0].ctrl, models[0].eps, models[0].kernel
    w = torch.cat([m.w for m in models], 1)                       # (N, 3F)
    tail = torch.cat([m.tail for m in models], 1)                 # (4, 3F)
    inv = 1.0 / (eps * eps)
    out = []
    for lo in range(0, points.shape[0], _rows(ctrl.shape[0])):
        x = points[lo:lo + _rows(ctrl.shape[0])].to(prec.real)
        phi = kernel.phi(_sq(x, ctrl) * inv[None])
        xt = torch.cat([torch.ones(x.shape[0], 1, dtype=x.dtype, device=x.device), x], 1)
        out.append(mm(phi, w, prec.tf32) + mm(xt, tail, prec.tf32))
    d = torch.cat(out)                                            # (V, 3F)
    return d.reshape(d.shape[0], len(models), 3).permute(1, 0, 2)


def transport_normals(models: list, points: torch.Tensor, normals: torch.Tensor,
                      weight: torch.Tensor, prec: Prec) -> torch.Tensor:
    """(F, V, 3) normals carried through each frame's applied map."""
    ctrl, eps, kernel = models[0].ctrl, models[0].eps, models[0].kernel
    nf = len(models)
    w = torch.cat([m.w for m in models], 1)                       # (N, 3F)
    tail = torch.stack([m.tail[1:] for m in models])              # (F, 3 b, 3 a)
    inv = 1.0 / (eps * eps)
    out = []
    rows = _rows(ctrl.shape[0])
    for lo in range(0, points.shape[0], rows):
        x = points[lo:lo + rows].to(prec.real)
        diff = x[:, None, :] - ctrl[None]                         # (B, N, 3)
        g = 2.0 * kernel.dphi_ds((diff * diff).sum(-1) * inv[None]) * inv[None]
        # J[f, v, a, b] = sum_i g_vi (x - c_i)_b w_i,fa + tail[f, b, a]
        jac = torch.stack([mm(g * diff[..., b], w, prec.tf32) for b in range(3)], -1)
        jac = jac.reshape(x.shape[0], nf, 3, 3).permute(1, 0, 2, 3) + tail.transpose(1, 2)[:, None]
        f = torch.eye(3, dtype=x.dtype, device=x.device) + \
            weight[lo:lo + rows].to(x.dtype)[None, :, None, None] * jac
        c0, c1, c2 = f[..., 0], f[..., 1], f[..., 2]              # columns of F
        n = normals[lo:lo + rows].to(x.dtype)[None]
        m = (n[..., 0:1] * torch.linalg.cross(c1, c2) + n[..., 1:2] * torch.linalg.cross(c2, c0)
             + n[..., 2:3] * torch.linalg.cross(c0, c1))
        out.append(m / torch.linalg.norm(m, dim=-1, keepdim=True))
    return torch.cat(out, 1)
