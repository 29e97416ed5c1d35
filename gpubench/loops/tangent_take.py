"""Cooks of FaceDeformNode playing tracked takes as a tangent-space pass (a
mix's "loop": "tangent_take"): the take loop (loops/take.py), with the
mesh given its tangent frame once, before the first cook: the attributes
tangentu, tangentv and N that the node projects the field onto where the
configuration's "tangent" is on.  The frame is the UV sphere's own: n
radial, u along increasing longitude, v = n x u, made in float64 from the
mesh points and stored as float32.  The mix's data are the take loop's.

Each take's poses are made on the host, so the loop itself never waits on
the card inside the window (take.Loop makes them there).  Timing, the kept records
and the comparison that decides `correct` are the cook loop's
(loops/cook.py).
"""

from __future__ import annotations

import numpy as np

from gpubench import inputs
from gpubench.loops import cook, take

compare = cook.compare


def sphere_frame(points: np.ndarray) -> tuple:
    """(u, v, n) of the UV sphere at points, each (V, 3) float32."""
    p = points.astype(np.float64)
    n = p / np.linalg.norm(p, axis=1, keepdims=True)
    lon = np.arctan2(p[:, 2], p[:, 0])
    u = np.stack([-np.sin(lon), np.zeros_like(lon), np.cos(lon)], -1)
    v = np.cross(n, u)
    return tuple(np.ascontiguousarray(a, np.float32) for a in (u, v, n))


class Loop(take.Loop):
    def __init__(self, scene: inputs.Scene, config: dict, mix: dict, seed: int, device):
        super().__init__(scene, config, mix, seed, device)
        for name, a in zip(("tangentu", "tangentv", "N"), sphere_frame(scene.points)):
            self.mesh.set_attr(name, a)
        # every cook refits the layer chain and evaluates every layer
        self.work = ["ml_refit", "ml_eval"] + (["morph"] if self.shapes else [])

    def requests(self, first: int, step: int):
        """(posed Mesh, pose array, params) of each frame of takes first,
        first + step, ..., each take's poses worked out on the host."""
        number = first
        while True:
            poses = inputs.shot_poses(self.scene.rest, self.mix["pose"], self.mix["frames"],
                                      self.mix["fps"], self.seed, number)
            for pose in poses.numpy():
                yield self.Mesh(points=pose), pose, self.params
            number += step
