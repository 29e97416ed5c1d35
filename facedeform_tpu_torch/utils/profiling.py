"""Stage timing and device traces (port of facedeform_tpu/utils/profiling.py).

  * stage(name, times, *sync) — context manager: wall-clock per pipeline
    stage, fenced with torch.cuda.synchronize() whenever CUDA is in use:
    without the fence a wall time measures the launch queue, not the
    work; annotated as a record_function range in torch.profiler traces;
  * StageTimes — collected per-stage milliseconds (the solve/eval split is
    the headline observability metric);
  * trace(logdir) — a torch.profiler run with CUDA activity, written as a
    Chrome trace under logdir.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


class StageTimes:
    """Accumulates per-stage wall-clock times across a cook/run."""

    def __init__(self) -> None:
        self.ms: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def add(self, name: str, ms: float) -> None:
        self.ms[name] = self.ms.get(name, 0.0) + ms
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        parts = [
            f"{k}: {v:.2f}ms" + (f" x{self.counts[k]}" if self.counts[k] > 1 else "")
            for k, v in sorted(self.ms.items(), key=lambda kv: -kv[1])
        ]
        return ", ".join(parts)

    def __repr__(self) -> str:
        return f"StageTimes({self.summary()})"


def sync(*tensors) -> None:
    """Fence device execution: torch.cuda.synchronize() on the device of
    the first CUDA tensor given; host tensors and arrays need no fence."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
            return


@contextlib.contextmanager
def stage(name: str, times: Optional[StageTimes] = None, *sync_tensors):
    """Time a pipeline stage; annotates torch.profiler traces.

    When times is given, the stage's device work is inside its time: the
    exit fences the device of the first CUDA tensor in sync_tensors, or,
    with none, the current CUDA device once CUDA is initialized.  An
    untimed run is never fenced and keeps its launches queued."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    if times is not None:
        if any(isinstance(t, torch.Tensor) and t.device.type == "cuda"
               for t in sync_tensors):
            sync(*sync_tensors)
        elif torch.cuda.is_initialized():
            torch.cuda.synchronize()
        times.add(name, (time.perf_counter() - t0) * 1e3)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace (CPU activity, and CUDA activity when
    a card is present) and write it as logdir/trace.json (Chrome trace
    format, viewable in Perfetto or chrome://tracing).  Yields the
    profiler, whose key_averages() summarise the run."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
