"""The card's label and the reading of a profiler trace.

device_label is a copy of facedeform_tpu_torch/benchmark.device_label; the
busy-union arithmetic is chip_smoke._profile's: device busy time is the
union of the intervals of the operations that ran on the card (kernels,
copies, fills), user annotations left out, and it may not exceed the wall.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def device_label() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def union_us(spans) -> float:
    busy, reach = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > reach:
            busy += hi - max(lo, reach)
            reach = hi
    return busy


@dataclasses.dataclass
class Profile:
    """The profiled part of a window: its wall (us), the device operations
    in it, and which host range launched each."""

    t0: float
    wall_us: float
    ops: list          # (name, cat, start, end, launching range names, innermost first)
    ranges: list       # (name, start, end) host ranges inside the wall
    requests: int

    def busy_us(self) -> float:
        return union_us((s, e) for _, _, s, e, _ in self.ops)

    def kernel_us(self, range_name: str) -> float:
        """Device time of the kernels launched inside a host range."""
        return sum(e - s for _, cat, s, e, where in self.ops
                   if cat == "kernel" and range_name in where)

    def device_ops(self, top: int = 10) -> list:
        by = defaultdict(float)
        for name, _, s, e, _ in self.ops:
            by[name] += (e - s) * 1e-6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle stretches of the card by the innermost host range open at
        their middle."""
        spans = sorted((s, e) for _, _, s, e, _ in self.ops)
        t0 = self.t0
        gaps, reach = [], t0
        for lo, hi in spans:
            if lo > reach:
                gaps.append((reach, lo))
            reach = max(reach, hi)
        if t0 + self.wall_us > reach:
            gaps.append((reach, t0 + self.wall_us))
        by = defaultdict(float)
        for lo, hi in gaps:
            mid = 0.5 * (lo + hi)
            inner = [r for r in self.ranges if r[1] <= mid <= r[2]]
            name = max(inner, key=lambda r: r[1])[0] if inner else "outside any range"
            by[name] += (hi - lo) * 1e-6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def read_profile(prof, window: str, requests: int) -> Profile:
    """Parse a torch.profiler run through its Chrome trace (written to a
    temporary file and deleted): the device operations inside the host
    range `window`, each with the host ranges open when it was launched."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ranges = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
              for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    win = [r for r in ranges if r[0] == window]
    if not win:
        raise RuntimeError(f"the trace has no range {window!r}")
    t0, t1 = win[0][1], win[0][2]
    ranges = [r for r in ranges if r[1] >= t0 and r[2] <= t1]
    launch = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = float(e["ts"])
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = float(e["ts"])
        end = s + float(e.get("dur", 0))
        if s < t0 or end > t1:
            continue
        at = launch.get(e.get("args", {}).get("correlation"), s)
        where = [r for r in ranges if r[1] <= at <= r[2]]
        where.sort(key=lambda r: -r[1])
        ops.append((e["name"], e["cat"], s, end, tuple(r[0] for r in where)))
    prof_ = Profile(t0=t0, wall_us=t1 - t0, ops=ops, ranges=ranges, requests=requests)
    if prof_.busy_us() > prof_.wall_us:
        raise RuntimeError("device busy time exceeds the wall: a range was counted as "
                           "device work")
    return prof_
