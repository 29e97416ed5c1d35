"""Animated shots through parallel/batched.py (a mix's "loop": "shot"),
back to back: each shot is `frames` poses on its own smooth seeded
trajectory at `fps`, run as fit_frames -> apply_frames (the capture
falloff, a gate of ones) -> transport_frames of the rest normals; P and N
are copied into pinned host buffers, and a shot counts once both are
there.  Capture runs once, in set-up.  A kept shot (a seeded reservoir of
`keep`, and the window's last) is written straight into a buffer of its
own, so keeping costs no copy.

The comparison reads every frame of the kept shots:

  p_err        max |P - P_ref| / max |P_ref - rest|, the worst frame
  n_err        max |N - N_ref| of the unit normals
"""

from __future__ import annotations

import time

import torch

from gpubench import compare as cmp
from gpubench import drive, inputs


class Loop:
    unit = "frames"
    work = ["fit_frames", "frames_eval", "jacobian"]

    def __init__(self, scene: inputs.Scene, config: dict, mix: dict, seed: int, device):
        from facedeform_tpu_torch import Mesh
        from facedeform_tpu_torch.capture.capture import ProximityCapture
        from facedeform_tpu_torch.parallel import batched

        self.batched, self.mix, self.seed = batched, mix, seed
        self.device = device = torch.device(device)
        self.scene = scene
        self.cfg, self.params = drive.program_config(config)
        self.frames = mix["frames"]
        cap = ProximityCapture(device=device)
        rest = Mesh(points=scene.rest)
        rest.set_attr("class", scene.classes)
        cap.init(Mesh(points=scene.points, faces=scene.faces), rest)
        res = cap.capture(self.params.maxedges, self.params.radius, self.cfg.dofalloff,
                          self.params.falloffrate)
        self.points = torch.as_tensor(scene.points, device=device)
        self.normals = torch.as_tensor(scene.normals, device=device)
        self.dist2 = torch.as_tensor(res.dist2, device=device)
        self.gate = torch.ones(len(scene.points), device=device)
        self.rest_dev = torch.as_tensor(scene.rest, device=device)
        shape = (self.frames, len(scene.points), 3)

        pin = device.type == "cuda"

        def buffers():
            return (torch.empty(shape, dtype=torch.float32, pin_memory=pin),
                    torch.empty(shape, dtype=torch.float32, pin_memory=pin))

        self.kept = drive.Reservoir(mix["keep"], inputs.rng(seed, inputs.STREAM_SAMPLE))
        self.bufs = [buffers() for _ in range(mix["keep"])]
        self.spare = buffers()
        self.last = None

    def poses(self, shot: int) -> torch.Tensor:
        return inputs.shot_poses(self.scene.rest, self.mix["pose"], self.frames,
                                 self.mix["fps"], self.seed, shot, self.device)

    def _shot(self, shot: int, buf, sync: drive.Sync) -> float:
        t0 = time.perf_counter()
        with torch.profiler.record_function("shot"):
            poses = self.poses(shot)
            with sync.span("shot.fit"):
                model, _ = self.batched.fit_frames(self.rest_dev, poses, self.cfg, self.params,
                                                   device=self.device)
            with sync.span("shot.eval"):
                pos, w = self.batched.apply_frames(model, self.points, self.dist2, self.gate,
                                                   self.cfg, self.params)
            with sync.span("shot.transport"):
                (nrm,) = self.batched.transport_frames(model, self.points, (self.normals,), w,
                                                       self.cfg, ("normal",))
            with sync.span("shot.output"):
                buf[0].copy_(pos, non_blocking=True)
                buf[1].copy_(nrm, non_blocking=True)
                drive.fence(self.device)
        return time.perf_counter() - t0

    def setup(self) -> None:
        """`warmup` shots of their own trajectories (kernel build, MAGMA,
        the shapes every shot has) into the spare buffers."""
        for k in range(self.mix["warmup"]):
            self._shot(-1 - k, self.spare, drive.Sync(self.device))
        self.index = 0

    def step(self, times=None) -> tuple[float, int]:
        shot = self.index
        self.index += 1
        slot = self.kept.slot()
        buf = self.bufs[slot] if slot is not None else self.spare
        sync = drive.Sync(self.device, times={} if times is not None else None)
        wall = self._shot(shot, buf, sync)
        if times is not None:
            times.append({"wall": wall * 1e3, **sync.times})
        rec = {"shot": shot, "P": buf[0], "N": buf[1]}
        if slot is not None:
            self.kept.items[slot] = rec
        self.last = rec
        return wall, self.frames

    def records(self) -> list:
        """The kept shots, each with its poses made again from the seed."""
        recs = [r for r in self.kept.items if r is not None]
        if self.last is not None and all(r["shot"] != self.last["shot"] for r in recs):
            recs.append(self.last)
        return [dict(r, poses=self.poses(r["shot"])) for r in recs]

    def close(self) -> None:
        self.points = self.normals = self.dist2 = self.gate = None


def compare(reference, records: list, produce=None) -> dict:
    out = {"p_err": 0.0, "n_err": 0.0}
    dev = reference.device
    params = reference.config["deform_params"]
    for rec in records:
        poses = rec["poses"]
        want_p, want_n = reference.shot(poses, params)
        got_p, got_n = (rec["P"], rec["N"]) if produce is None else produce.shot(poses, params)
        for k in range(want_p.shape[0]):
            out["p_err"] = max(out["p_err"], cmp.p_err(cmp.as64(got_p[k], dev), want_p[k],
                                                       reference.points))
            out["n_err"] = max(out["n_err"], cmp.max_abs(cmp.as64(got_n[k], dev), want_n[k]))
    return out
