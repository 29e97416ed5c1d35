"""The reference family of partition-of-unity rigs with capture falloff and
a DBSE morph (the configurations' "reference": "pu_dbse"): one run's
inputs seen by the reference at one precision.

  cook(pose, params)   P, fd_falloff and the DBSE weights of a node cook
  work(params, frames) what a roofline count (roofline/<layer>.py) reads

The configuration's "pu" block gives the method's settings (patch_size,
overlap, eps "auto"); its model is KERNEL with the linear tail, its ridge
the clamped lam.  The capture distances are worked out in float64 under
every precision, and the patch geometry and the blend's terms once a run:
they depend on the rest rig and the mesh alone.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench import reference as ref
from gpubench.reference import pu


class Reference:
    kernels = ref.KERNELS

    def __init__(self, scene, config: dict, device, prec: ref.Prec):
        self.config, self.prec, self.device = config, prec, device
        dc, method = config["deform_config"], config["pu"]
        if dc["model"] != "KERNEL" or dc.get("term", "LINEAR") != "LINEAR":
            raise ValueError("the PU reference carries KERNEL rigs with the linear tail only")
        if method["eps"] != "auto":
            raise ValueError("the PU reference carries eps 'auto' only")
        self.kernel = self.kernels[dc["kernel"]]
        self.points = torch.as_tensor(scene.points, device=device).to(torch.float64)
        self.rest = torch.as_tensor(scene.rest, device=device)
        faces = torch.as_tensor(scene.faces, device=device)
        p = config["deform_params"]
        self.dist2 = ref.capture_dist2(self.points, faces, self.rest.to(torch.float64),
                                       p["maxedges"], ref.JUDGE)
        self.shapes = scene.shapes if dc["morphspace"] else None
        self.geo = pu.patches(scene.rest, method["patch_size"], method["overlap"])
        self.pairs = pu.blend_pairs(self.geo, self.points, prec.real)
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

    def fit(self, pose: np.ndarray, params: dict) -> pu.Model:
        """One pose's patches; the last is kept."""
        key = (pose.tobytes(), params["lam"])
        if key not in self._fits:
            pose_t = torch.as_tensor(pose, device=self.device)
            self._fits = {key: pu.fit(self.geo, self.rest, pose_t, self.kernel,
                                      max(params["lam"], 0.01), self.prec)}
        return self._fits[key]

    def cook(self, pose: np.ndarray, params: dict):
        """(P (V, 3), falloff (V,), weights (S,) or None) of one cook."""
        f = self.falloff(params)
        disp = pu.evaluate(self.fit(pose, params), self.pairs, self.points, self.prec)
        p = self.points.to(self.prec.real) + f[:, None] * disp
        if self.blend is None:
            return p, f, None
        w = self.blend.weights(p)
        return self.blend.morph(p, w, self.config["deform_config"]["dofalloff"],
                                params["falloffradius"]), f, w

    def work(self, params: dict, frames: int) -> dict:
        """The sizes a roofline count reads: the patches' live controls, the
        eval's needed pairs, the mesh and the shapes."""
        live = [len(m) for m in self.geo.members]
        c = self.config
        return {"V": len(self.points), "S": 0 if self.shapes is None else len(self.shapes),
                "K": len(live), "live": sum(live), "systems": sum((n + 4) ** 2 for n in live),
                "pairs": pu.needed_pairs(self.geo, self.points), "precision": c["precision"],
                "real_bytes": 8 if c["precision"] == "float64" else 4}
