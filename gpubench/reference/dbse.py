"""DBSE morph, worked out again: least-squares blendshape weights
w = (B^T B + ridge tr(B^T B)/S I)^-1 B^T d for the pose delta d = P - rest,
then P = rest + B w + (P_rbf - rest) falloffradius (the morph-space
residual, with dofalloff on and falloffradius != 0; else rest + B w).
"""

from __future__ import annotations

import torch

from gpubench.reference.prec import Prec, mm

_COLS = 1 << 20


class Blendshapes:
    """The basis B = shapes - rest, built from the benchmark's shapes;
    the Gram is pose-independent and made once."""

    def __init__(self, shapes, rest, prec: Prec, ridge: float = 1e-6):
        dev = rest.device
        dt = torch.float32 if prec.dbse_tf32 else torch.float64
        rest = torch.as_tensor(rest, device=dev).to(torch.float64)
        self.prec, self.dt, self.ridge = prec, dt, ridge
        self.rest = rest
        self.b = torch.stack([(torch.as_tensor(s, device=dev).to(torch.float64) - rest)
                              .reshape(-1).to(dt) for s in shapes])   # (S, 3V)
        s = self.b.shape[0]
        g = torch.zeros(s, s, dtype=dt, device=dev)
        for lo in range(0, self.b.shape[1], _COLS):
            blk = self.b[:, lo:lo + _COLS]
            g += mm(blk, blk.T, prec.dbse_tf32)
        self.gram = g

    def weights(self, p_rbf: torch.Tensor) -> torch.Tensor:
        d = (p_rbf.to(torch.float64) - self.rest).reshape(-1).to(self.dt)
        c = torch.zeros(self.b.shape[0], dtype=self.dt, device=d.device)
        for lo in range(0, d.shape[0], _COLS):
            c += mm(self.b[:, lo:lo + _COLS], d[lo:lo + _COLS, None], self.prec.dbse_tf32)[:, 0]
        s = self.gram.shape[0]
        reg = self.ridge * torch.diagonal(self.gram).sum() / s + 1e-30
        return torch.linalg.solve(self.gram + reg * torch.eye(s, dtype=self.dt, device=d.device),
                                  c)

    def morph(self, p_rbf: torch.Tensor, w: torch.Tensor, dofalloff: bool,
              falloffradius: float) -> torch.Tensor:
        recon = mm(w[None].to(self.dt), self.b, self.prec.dbse_tf32)[0]
        out = self.rest + recon.to(torch.float64).reshape(self.rest.shape)
        if dofalloff and float(falloffradius) != 0.0:
            out = out + (p_rbf.to(torch.float64) - self.rest) * float(falloffradius)
        return out
