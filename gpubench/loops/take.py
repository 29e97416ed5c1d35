"""Cooks of FaceDeformNode playing tracked takes (a mix's "loop": "take"),
one artist in a closed loop: the next cook is issued when the last has
returned, and each cook is the next frame of a take, every marker of the
rig moved, through a new posed-rig Mesh.  The mix's data:

  frames  frames a take, then the next take starts on its own trajectory
  fps     the take's frame rate
  pose    the seeded smooth rig motion of a take (inputs.shot_poses)
  cook    keyword arguments of FaceDeformNode.cook, the same every cook
  warmup  requests of their own take in set-up; keep: cooks kept for the
          comparison (a seeded reservoir, and the window's last)

Timing, the kept records and the comparison that decides `correct` are the
cook loop's (loops/cook.py); only where the poses come from differs.
"""

from __future__ import annotations

import torch

from gpubench import drive, inputs
from gpubench.loops import cook

compare = cook.compare


class Loop(cook.Loop):
    def __init__(self, scene: inputs.Scene, config: dict, mix: dict, seed: int, device):
        from facedeform_tpu_torch import FaceDeformNode, Mesh

        self.Mesh, self.mix, self.seed, self.device = Mesh, mix, seed, torch.device(device)
        self.scene = scene
        self.cfg, self.params = drive.program_config(config)
        self.mesh = Mesh(points=scene.points, faces=scene.faces)
        self.rest = Mesh(points=scene.rest)
        self.rest.set_attr("class", scene.classes)
        self.shapes = [Mesh(points=s) for s in scene.shapes] if scene.shapes is not None else []
        self.node = FaceDeformNode(device=device)
        self.kept = drive.Reservoir(mix["keep"], inputs.rng(seed, inputs.STREAM_SAMPLE))
        self.last = None
        # a take's rig is a partition-of-unity rig: every cook solves its
        # patches and evaluates them
        self.work = ["pu_fit", "pu_eval"] + (["morph"] if self.shapes else [])

    def requests(self, first: int, step: int):
        """(posed Mesh, pose array, params) of each frame of takes first,
        first + step, ..."""
        take = first
        while True:
            poses = inputs.shot_poses(self.scene.rest, self.mix["pose"], self.mix["frames"],
                                      self.mix["fps"], self.seed, take, self.device)
            for pose in poses.cpu().numpy():
                yield self.Mesh(points=pose), pose, self.params
            take += step

    def setup(self) -> None:
        """The cold cook (capture, DBSE basis, the kernel build, the first
        fit and plan), then `warmup` more frames of the same take of its
        own (take -1), so every shape the window uses has run."""
        warm = self.requests(-1, -1)
        for _ in range(1 + self.mix["warmup"]):
            posed, _, params = next(warm)
            self._cook(posed, params)
        self.stream = self.requests(0, 1)
