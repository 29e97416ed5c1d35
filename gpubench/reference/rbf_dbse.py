"""The reference family of RBF rigs with capture falloff and a DBSE morph
(the configurations' "reference": "rbf_dbse"): one run's inputs seen by
the reference at one precision.

  cook(pose, params)   P, fd_falloff and the DBSE weights of a node cook
  shot(poses, params)  P and the transported normals of every frame
  work(params, frames) what a roofline count (roofline/<layer>.py) reads

The capture distances are worked out in float64 under every precision: a
control steps down the stage it names and nothing else.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench import reference as ref


class Reference:
    kernels = ref.KERNELS

    def __init__(self, scene, config: dict, device, prec: ref.Prec):
        self.config, self.prec, self.device = config, prec, device
        self.points = torch.as_tensor(scene.points, device=device).to(torch.float64)
        self.normals = torch.as_tensor(scene.normals, device=device)
        self.rest = torch.as_tensor(scene.rest, device=device)
        faces = torch.as_tensor(scene.faces, device=device)
        p = config["deform_params"]
        self.dist2 = ref.capture_dist2(self.points, faces, self.rest.to(torch.float64),
                                       p["maxedges"], ref.JUDGE)
        self.shapes = scene.shapes if config["deform_config"]["morphspace"] else None
        self._blend = None
        self._fits = {}

    @property
    def blend(self):
        """The DBSE basis, built on first use (a shot never morphs)."""
        if self._blend is None and self.shapes is not None:
            self._blend = ref.Blendshapes(self.shapes, self.points, self.prec)
        return self._blend

    def falloff(self, params: dict) -> torch.Tensor:
        if not self.config["deform_config"]["dofalloff"]:
            return torch.ones_like(self.dist2, dtype=self.prec.real)
        return ref.falloff(self.dist2, params["radius"], params["falloffrate"], self.prec)

    def _fit(self, pose, params: dict) -> ref.Model:
        return ref.fit(self.rest, torch.as_tensor(pose, device=self.device),
                       self.config["deform_config"], params, self.prec, self.kernels)

    def fit(self, pose: np.ndarray, params: dict) -> ref.Model:
        """One pose's model; the last is kept, since a slider's cooks share it."""
        key = (pose.tobytes(), params["radius"], params["lam"], params["qcoef"], params["zcoef"])
        if key not in self._fits:
            self._fits = {key: self._fit(pose, params)}
        return self._fits[key]

    def cook(self, pose: np.ndarray, params: dict):
        """(P (V, 3), falloff (V,), weights (S,) or None) of one cook."""
        f = self.falloff(params)
        disp = ref.evaluate([self.fit(pose, params)], self.points, self.prec)[0]
        p = self.points.to(self.prec.real) + f[:, None] * disp
        if self.blend is None:
            return p, f, None
        w = self.blend.weights(p)
        return self.blend.morph(p, w, self.config["deform_config"]["dofalloff"],
                                params["falloffradius"]), f, w

    def shot(self, poses: torch.Tensor, params: dict):
        """(P (F, V, 3), N (F, V, 3)) of one shot."""
        f = self.falloff(params)
        models = [self._fit(p, params) for p in poses]
        disp = ref.evaluate(models, self.points, self.prec)
        pos = self.points.to(self.prec.real)[None] + f[None, :, None] * disp
        nrm = ref.transport_normals(models, self.points, self.normals, f, self.prec)
        return pos, nrm

    def needed_pairs(self, params: dict) -> int:
        """The (vertex, control) pairs the eval needs: pairs at a vertex
        whose falloff is above 0 and, for a decaying basis, within the
        basis' cutoff s = |x - c|^2 / eps^2 <= cutoff_s; every pair of such
        a vertex for a growing basis."""
        active = self.falloff(params) > 0
        model = self.fit(self.rest.cpu().numpy(), params)
        if model.kernel.cutoff_s is None:
            return int(active.sum()) * model.ctrl.shape[0]
        cut2 = model.kernel.cutoff_s * model.eps ** 2
        pts = self.points[active]
        pairs = 0
        step = max(1, (1 << 24) // model.ctrl.shape[0])
        for lo in range(0, pts.shape[0], step):
            d = pts[lo:lo + step, None, :] - model.ctrl[None]
            pairs += int(((d * d).sum(-1) <= cut2[None]).sum())
        return pairs

    def work(self, params: dict, frames: int) -> dict:
        """The sizes a roofline count reads."""
        c = self.config
        kernel = self.fit(self.rest.cpu().numpy(), params).kernel
        return {"V": len(self.points), "N": len(self.rest),
                "S": 0 if self.shapes is None else len(self.shapes), "F": frames,
                "pairs": self.needed_pairs(params), "phi_ops": kernel.ops,
                "precision": c["precision"],
                "real_bytes": 8 if c["precision"] == "float64" else 4}
