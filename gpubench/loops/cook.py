"""Cooks of FaceDeformNode (a mix's "loop": "cook"), one artist in a closed
loop: the next cook is issued when the last has returned.  The mix's data
says what each cook changes:

  moved   markers of the last pose each cook moves by N(0, sigma), through
          a new posed-rig Mesh (a drag; all of them: a tracked take); 0
          keeps the pose and its Mesh, so nothing is re-solved
  sweep   {DeformParams field: [lo, hi]}: each cook sets the field to a
          seeded value in [lo, hi] (a slider)
  cook    keyword arguments of FaceDeformNode.cook, the same every cook
  pose    the seeded smooth rig motion the first pose is taken from
  warmup  requests of their own stream in set-up; keep: cooks kept for
          the comparison (a seeded reservoir, and the window's last)

The mesh, rest rig and shapes are the same objects throughout, so the
node's caches hold.  The comparison reads each kept cook's P, fd_falloff
and DBSE weights against the reference's:

  p_err        max |P - P_ref| / max |P_ref - rest|, the worst cook
  falloff_err  max |fd_falloff - falloff_ref|
  weights_err  max |w - w_ref| / max |w_ref|
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gpubench import compare as cmp
from gpubench import drive, inputs


class Loop:
    unit = "cooks"
    frames = 1

    def __init__(self, scene: inputs.Scene, config: dict, mix: dict, seed: int, device):
        from facedeform_tpu_torch import FaceDeformNode, Mesh

        self.Mesh, self.mix, self.seed, self.device = Mesh, mix, seed, torch.device(device)
        self.cfg, self.params = drive.program_config(config)
        self.mesh = Mesh(points=scene.points, faces=scene.faces)
        self.rest = Mesh(points=scene.rest)
        self.rest.set_attr("class", scene.classes)
        self.shapes = [Mesh(points=s) for s in scene.shapes] if scene.shapes is not None else []
        self.node = FaceDeformNode(device=device)
        self.pose0 = inputs.start_pose(scene.rest, mix["pose"], seed)
        self.posed0 = Mesh(points=self.pose0)
        self.kept = drive.Reservoir(mix["keep"], inputs.rng(seed, inputs.STREAM_SAMPLE))
        self.last = None
        self.work = (["refit"] if mix["moved"] else []) + ["eval"] + \
            (["morph"] if self.shapes else [])

    def requests(self, poses: np.random.Generator, sweeps: np.random.Generator):
        """(posed Mesh, pose array, params) of each cook of a stream."""
        drags = (inputs.drags(self.pose0, self.mix["moved"], self.mix["sigma"], poses)
                 if self.mix["moved"] else None)
        while True:
            if drags is None:
                posed, pose = self.posed0, self.pose0
            else:
                pose = next(drags)
                posed = self.Mesh(points=pose)
            swept = {k: float(sweeps.uniform(lo, hi)) for k, (lo, hi) in
                     sorted(self.mix["sweep"].items())}
            yield posed, pose, self.params._replace(**swept)

    def _cook(self, posed, params, times=None):
        from facedeform_tpu_torch.utils.profiling import StageTimes

        st = StageTimes() if times is not None else None
        t0 = time.perf_counter()
        with torch.profiler.record_function("cook"):
            res = self.node.cook([self.mesh, self.rest, posed] + self.shapes, self.cfg, params,
                                 times=st, **self.mix["cook"])
            drive.fence(self.device)
        wall = time.perf_counter() - t0
        if st is not None:
            times.append({"wall": wall * 1e3, **st.ms})
        return res, wall

    def setup(self) -> None:
        """The cold cook (capture, DBSE basis, the fit and its FitPlan, the
        eval autotune, the kernel build), then `warmup` requests of their
        own stream, so every shape the window uses has run."""
        self._cook(self.posed0, self.params)
        warm = self.requests(inputs.rng(self.seed, inputs.STREAM_WARMUP),
                             inputs.rng(self.seed, inputs.STREAM_WARMUP, 1))
        for _ in range(self.mix["warmup"]):
            posed, _, params = next(warm)
            self._cook(posed, params)
        self.stream = self.requests(inputs.rng(self.seed, inputs.STREAM_DRAGS),
                                    inputs.rng(self.seed, inputs.STREAM_SLIDER))

    def step(self, times=None) -> tuple[float, int]:
        posed, pose, params = next(self.stream)
        slot = self.kept.slot()
        res, wall = self._cook(posed, params, times)
        rec = {"pose": pose, "params": params._asdict(), "P": res.mesh.points,
               "falloff": res.mesh.attr("fd_falloff"), "weights": res.weights}
        if slot is not None:
            self.kept.items[slot] = rec
        self.last = rec
        return wall, 1

    def records(self) -> list:
        recs = [r for r in self.kept.items if r is not None]
        if self.last is not None and all(r is not self.last for r in recs):
            recs.append(self.last)
        return recs

    def close(self) -> None:
        self.node = None


def compare(reference, records: list, produce=None) -> dict:
    """The numbers of `records` (the program's cooks), or, with `produce`
    (the reference at a control's precision), of what it gives for the
    same requests."""
    out = {"p_err": 0.0, "falloff_err": 0.0}
    dev = reference.device
    for rec in records:
        pose, params = rec["pose"], rec["params"]
        want_p, want_f, want_w = reference.cook(pose, params)
        if produce is None:
            got_p, got_f, got_w = (cmp.as64(rec["P"], dev), cmp.as64(rec["falloff"], dev),
                                   None if rec["weights"] is None
                                   else cmp.as64(rec["weights"], dev))
        else:
            got_p, got_f, got_w = (None if x is None else x.to(torch.float64)
                                   for x in produce.cook(pose, params))
        out["p_err"] = max(out["p_err"], cmp.p_err(got_p, want_p, reference.points))
        out["falloff_err"] = max(out["falloff_err"], cmp.max_abs(got_f, want_f))
        if want_w is not None:
            out["weights_err"] = max(out.get("weights_err", 0.0), cmp.rel_max(got_w, want_w))
    return out
