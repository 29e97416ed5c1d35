"""The reference family of multilayer gaussian rigs with a tangent-space
projection, capture falloff and a DBSE morph (the configurations'
"reference": "multilayer_dbse"): one run's inputs seen by the reference at
one precision.

  cook(pose, params)   P, fd_falloff and the DBSE weights of a node cook
  work(params, frames) what a roofline count (roofline/<layer>.py) reads

The layer chain, in the published form (deform_config "layers" = L,
"model" MULTILAYER, the gaussian phi(s) = exp(-s), s = |x - c|^2 / eps^2):

* eps_l = radius 0.5^l, l = 0 .. L - 1, every control of a layer alike;
* layer 0 solves [[Phi_0 + lam I, P], [P^T, -1e-8 I]] [w_0; c] = [t_0; 0]
  with the linear tail P = [1, x, y, z]; a layer l >= 1 solves
  (Phi_l + lam I) w_l = t_l, without the tail;
* t_0 = pose - rest, t_{l+1} = t_l - (Phi_l w_l + P c) at the markers, the
  tail term on layer 0 only (the ridge's lam w_l is no part of the field);
* disp(x) = sum_l sum_i w_l,i phi(|x - c_i|^2 / eps_l^2) + c . [1, x, y, z].

With deform_config "tangent" on, the displacement is then projected by the
reference node's oblique rule, verbatim: with unit u, v, n and
B = M^T M for rows M = [u; v; n], a1 = normalize(u B), a2 = normalize(v B),
d' = a1 (d . a1) + a2 (d . a2).  The frame is the UV sphere's own, worked
out here from the mesh points in float64: n radial, u along increasing
longitude, v = n x u.  Then the capture falloff, P = x + f d', and the DBSE
morph.

Departures from ALGLIB's own multilayer (hierarchical) RBF, which the
reference node calls and only parameterises (radius, layers, lambda):
ALGLIB fits each layer by its own iterative least-squares solver with its
own regularisation schedule and handles the linear term apart from the
layers; this family is the port's formulation instead (ops/fit.py): a
dense ridge-regularised solve a layer with lam on the diagonal of every
layer, the tail a saddle block of layer 0 alone, and the residual of the
field without the ridge term.  ALGLIB's layer radii are those of its
hierarchy (base radius halved per layer), which the chain above keeps.

It imports neither JAX, nor facedeform_tpu, nor anything of
facedeform_tpu_torch.  Under JUDGE everything runs in float64, the eval in
blocks of rows that compute |x - c|^2 once for every layer.  The capture
distances are worked out in float64 under every precision: a control
steps down the stage it names and nothing else.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench import reference as ref
from gpubench.reference.prec import mm

#: (vertex, control) pairs a block of the eval holds
_PAIRS = 1 << 23
#: the gaussian's exactness cutoff: exp(-s) < 1e-12 past it
CUTOFF_S = 27.7


def _sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = x[:, None, :] - y[None]
    return (d * d).sum(-1)


def _rows(n_ctrl: int) -> int:
    return max(256, _PAIRS // max(1, n_ctrl))


def sphere_frame(points: torch.Tensor) -> tuple:
    """(u, v, n) of the UV sphere at points: n radial, u along increasing
    longitude, v = n x u."""
    n = points / torch.linalg.norm(points, dim=-1, keepdim=True)
    lon = torch.atan2(points[:, 2], points[:, 0])
    u = torch.stack([-torch.sin(lon), torch.zeros_like(lon), torch.cos(lon)], -1)
    return u, torch.linalg.cross(n, u), n


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


def project_to_tangents(frame: tuple, d: torch.Tensor) -> torch.Tensor:
    """The reference node's oblique projection of (V, 3) displacements."""
    u, v, n = (_normalize(f.to(d.dtype)) for f in frame)
    m = torch.stack([u, v, n], -2)                          # (V, 3 rows, 3)
    b = m.transpose(-1, -2) @ m                             # B = M^T M
    a1 = _normalize((u[:, None, :] @ b)[:, 0])
    a2 = _normalize((v[:, None, :] @ b)[:, 0])
    return a1 * (d * a1).sum(-1, keepdim=True) + a2 * (d * a2).sum(-1, keepdim=True)


class Model:
    """A fitted layer chain: the controls (N, 3), each layer's eps and
    (N, 3) weights, and the tail (4, 3)."""

    def __init__(self, ctrl, eps, w, tail):
        self.ctrl, self.eps, self.w, self.tail = ctrl, eps, w, tail


def fit(rest: torch.Tensor, pose: torch.Tensor, layers: int, radius: float, lam: float,
        prec: ref.Prec) -> Model:
    """The chain of one pose, every layer in prec.real."""
    ctrl = rest.to(prec.real)
    target = pose.to(prec.real) - ctrl
    n = ctrl.shape[0]
    dev = ctrl.device
    eye = torch.eye(n, dtype=prec.real, device=dev)
    p = torch.cat([torch.ones(n, 1, dtype=prec.real, device=dev), ctrl], 1)
    d2 = _sq(ctrl, ctrl)
    eps, ws, tail = [], [], None
    for layer in range(layers):
        e = radius * 0.5 ** layer
        phi = torch.exp(-d2 / (e * e))
        if layer == 0:
            a = torch.cat([torch.cat([phi + lam * eye, p], 1),
                           torch.cat([p.T, -1e-8 * torch.eye(4, dtype=prec.real, device=dev)],
                                     1)], 0)
            b = torch.cat([target, torch.zeros(4, 3, dtype=prec.real, device=dev)])
            x = torch.linalg.solve(a, b)
            w, tail = x[:n], x[n:]
            fitted = mm(phi, w, prec.tf32) + mm(p, tail, prec.tf32)
        else:
            w = torch.linalg.solve(phi + lam * eye, target)
            fitted = mm(phi, w, prec.tf32)
        eps.append(e)
        ws.append(w)
        target = target - fitted
    return Model(ctrl, eps, ws, tail)


def evaluate(model: Model, points: torch.Tensor, prec: ref.Prec) -> torch.Tensor:
    """(V, 3) displacements: the layers' fields and the tail."""
    out = []
    rows = _rows(model.ctrl.shape[0])
    for lo in range(0, points.shape[0], rows):
        x = points[lo:lo + rows].to(prec.real)
        d2 = _sq(x, model.ctrl)
        xt = torch.cat([torch.ones(x.shape[0], 1, dtype=x.dtype, device=x.device), x], 1)
        d = mm(xt, model.tail, prec.tf32)
        for e, w in zip(model.eps, model.w):
            d = d + mm(torch.exp(-d2 / (e * e)), w, prec.tf32)
        out.append(d)
    return torch.cat(out)


class Reference:
    def __init__(self, scene, config: dict, device, prec: ref.Prec):
        self.config, self.prec, self.device = config, prec, device
        dc = config["deform_config"]
        if dc["model"] != "MULTILAYER" or dc.get("term", "LINEAR") != "LINEAR":
            raise ValueError("the multilayer reference carries MULTILAYER rigs with the "
                             "linear tail only")
        self.layers = max(int(dc["layers"]), 1)
        self.points = torch.as_tensor(scene.points, device=device).to(torch.float64)
        self.rest = torch.as_tensor(scene.rest, device=device)
        faces = torch.as_tensor(scene.faces, device=device)
        p = config["deform_params"]
        self.dist2 = ref.capture_dist2(self.points, faces, self.rest.to(torch.float64),
                                       p["maxedges"], ref.JUDGE)
        self.frame = sphere_frame(self.points) if dc["tangent"] else None
        self.shapes = scene.shapes if dc["morphspace"] else None
        self._blend = None
        self._fits = {}

    @property
    def blend(self):
        """The DBSE basis, built on first use."""
        if self._blend is None and self.shapes is not None:
            self._blend = ref.Blendshapes(self.shapes, self.points, self.prec)
        return self._blend

    def falloff(self, params: dict) -> torch.Tensor:
        if not self.config["deform_config"]["dofalloff"]:
            return torch.ones_like(self.dist2, dtype=self.prec.real)
        return ref.falloff(self.dist2, params["radius"], params["falloffrate"], self.prec)

    def fit(self, pose: np.ndarray, params: dict) -> Model:
        """One pose's chain; the last is kept."""
        key = (pose.tobytes(), params["radius"], params["lam"])
        if key not in self._fits:
            self._fits = {key: fit(self.rest, torch.as_tensor(pose, device=self.device),
                                   self.layers, max(params["radius"], 0.01),
                                   max(params["lam"], 0.01), self.prec)}
        return self._fits[key]

    def cook(self, pose: np.ndarray, params: dict):
        """(P (V, 3), falloff (V,), weights (S,) or None) of one cook."""
        f = self.falloff(params)
        disp = evaluate(self.fit(pose, params), self.points, self.prec)
        if self.frame is not None:
            disp = project_to_tangents(self.frame, disp)
        p = self.points.to(self.prec.real) + f[:, None] * disp
        if self.blend is None:
            return p, f, None
        w = self.blend.weights(p)
        return self.blend.morph(p, w, self.config["deform_config"]["dofalloff"],
                                params["falloffradius"]), f, w

    def layer_pairs(self, params: dict) -> list:
        """The (vertex, control) pairs each layer's eval needs: at a vertex
        whose falloff is above 0, within the gaussian's cutoff s <= 27.7 at
        that layer's eps."""
        active = self.falloff(params) > 0
        pts = self.points[active]
        ctrl = self.rest.to(torch.float64)
        radius = max(params["radius"], 0.01)
        cut2 = [CUTOFF_S * (radius * 0.5 ** layer) ** 2 for layer in range(self.layers)]
        pairs = [0] * self.layers
        rows = _rows(ctrl.shape[0])
        for lo in range(0, pts.shape[0], rows):
            d2 = _sq(pts[lo:lo + rows], ctrl)
            for layer, c in enumerate(cut2):
                pairs[layer] += int((d2 <= c).sum())
        return pairs

    def work(self, params: dict, frames: int) -> dict:
        """The sizes a roofline count reads: the mesh, the rig, the shapes,
        the layers, each layer's needed pairs and the vertices the eval
        projects (those whose falloff is above 0, where a frame is on)."""
        c = self.config
        return {"V": len(self.points), "N": len(self.rest),
                "S": 0 if self.shapes is None else len(self.shapes), "F": frames,
                "L": self.layers, "layer_pairs": self.layer_pairs(params),
                "projected": 0 if self.frame is None else int((self.falloff(params) > 0).sum()),
                "precision": c["precision"],
                "real_bytes": 8 if c["precision"] == "float64" else 4}
