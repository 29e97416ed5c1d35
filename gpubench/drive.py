"""What the loops (loops/<loop>.py) share in driving the program: the
program's config from a configuration file, fences, the traced run's
spans, and the seeded reservoir of kept requests.

A loop file defines `Loop(scene, config, mix, seed, device)` with

  unit        "cooks" | "frames", what a request delivers
  frames      frames a request delivers (1 for a cook)
  work        the roofline layers (roofline/<layer>.py) one request needs
  setup()     the cold request and the warm-up: every shape the window uses
  step(times) one request: (latency s, units delivered); a traced run
              passes a list that the request appends its stage times to
  records()   the kept requests, for the comparison after the window
  close()     drop the program's state

and `compare(reference, records, produce=None) -> {number: value}`: the
numbers that decide `correct`, the records judged against the
configuration's reference (reference/<name>.py), or, with `produce` (the
reference at a control's precision), what the control gives for the same
requests.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Optional

import numpy as np
import torch


def program_config(config: dict):
    """(DeformConfig, DeformParams) of a configuration file: every field it
    names, enums by their names."""
    from facedeform_tpu_torch import DeformConfig, DeformParams

    defaults = DeformConfig()
    fields = {}
    for key, value in config["deform_config"].items():
        default = getattr(defaults, key)
        fields[key] = type(default)[value] if isinstance(default, enum.Enum) else value
    return DeformConfig(**fields), DeformParams(**config["deform_params"])


class Reservoir:
    """`keep` items drawn uniformly from a stream of unknown length; the
    choice for item i is made before item i runs (it says where to put
    the item), from the seed only."""

    def __init__(self, keep: int, g: np.random.Generator):
        self.keep, self.g, self.seen = keep, g, 0
        self.items: list = [None] * keep

    def slot(self) -> Optional[int]:
        """The slot the next item goes to, or None."""
        i = self.seen
        self.seen += 1
        if i < self.keep:
            return i
        j = int(self.g.integers(0, i + 1))
        return j if j < self.keep else None


def fence(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Sync:
    """Fences and record_function ranges of the traced run; the untimed
    run passes times=None and is never fenced by the harness."""

    device: torch.device
    times: Optional[dict] = None

    def span(self, name: str):
        return _Span(name, self.times, self.device)


class _Span:
    def __init__(self, name, times, device):
        self.name, self.times, self.device = name, times, device

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.times is not None:
            fence(self.device)
            self.times[self.name] = self.times.get(self.name, 0.0) + \
                (time.perf_counter() - self.t0) * 1e3
        self.rf.__exit__(*exc)
