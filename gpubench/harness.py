"""One run of one cell: inputs from the seed, set-up, the closed-loop window,
the comparison with the plain reference, and the result line.

A traced run (--trace 1) fences each stage (the node's StageTimes, the
shot loop's spans) in every request of the window and profiles a short
steady part of it with torch.profiler; its line carries the per-layer
metrics.  An untimed run (--trace 0) fences nothing but each request's
end, and its line carries the end-to-end metrics.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from gpubench import catalog, compare, drive
from gpubench import reference as ref

#: top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "facedeform_tpu")
#: the profiled part of a traced window: from its third request, at least
#: PROFILE_MIN requests and PROFILE_MIN_S seconds, at most PROFILE_MAX requests
PROFILE_FROM, PROFILE_MIN, PROFILE_MIN_S, PROFILE_MAX = 2, 3, 0.5, 30


class NoChip(RuntimeError):
    pass


@dataclasses.dataclass
class Run:
    """What a window measured; the metric readers read it."""

    unit: str                     # "cooks" | "frames"
    frames: int                   # frames a request delivers
    latencies: list               # s, each request of the window
    units: int                    # cooks or frames delivered
    elapsed: float                # s, the window
    setup_s: float
    work: list                    # the roofline layers a request needs
    requests: list = dataclasses.field(default_factory=list)   # traced: ms by stage
    profile: Optional[object] = None
    work_ctx: Optional[dict] = None
    base: Path = catalog.HERE

    def mean(self, name: str) -> Optional[float]:
        """Mean ms a request of a stage or span, None where no request had it."""
        if not self.requests or not any(name in r for r in self.requests):
            return None
        return sum(r.get(name, 0.0) for r in self.requests) / len(self.requests)

    def per_frame(self, name: str) -> Optional[float]:
        m = self.mean(name)
        return None if m is None else m / self.frames

    def work_s(self, layer: str) -> float:
        return catalog.roofline(layer, self.base)(self.work_ctx).seconds()

    def roofline_pct(self, layer: str, range_name: str) -> Optional[float]:
        """The least time of the layer's needed work over the device time
        of the kernels launched inside its host range, profiled requests."""
        if self.profile is None or self.work_ctx is None:
            return None
        t_dev = self.profile.kernel_us(range_name) * 1e-6
        if t_dev <= 0.0:
            return None
        return 100.0 * self.work_s(layer) * self.profile.requests / t_dev

    def idle_pct(self) -> Optional[float]:
        if self.profile is None:
            return None
        return 100.0 * (1.0 - self.profile.busy_us() / self.profile.wall_us)

    def mfu(self) -> Optional[float]:
        """The least time of all the work a request needs (the loop's `work`
        layers, one after another) over the profiled wall."""
        if self.profile is None or self.work_ctx is None:
            return None
        need = sum(self.work_s(layer) for layer in self.work)
        return 100.0 * need * self.profile.requests / (self.profile.wall_us * 1e-6)


def _window(loop, seconds: float, trace: bool, min_requests: int = 0):
    """Run requests for `seconds`, and on until `min_requests` have been
    attempted; a traced window also profiles a part."""
    latencies, units, attempted, failed = [], 0, 0, 0
    requests = [] if trace else None
    prof = rf = None
    profiled, prof_t0, profiling = 0, 0.0, trace
    t0 = time.perf_counter()
    end = t0 + seconds
    while time.perf_counter() < end or attempted < min_requests:
        if profiling and prof is None and attempted >= PROFILE_FROM:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            rf = torch.profiler.record_function("gpubench.profiled")
            rf.__enter__()
            prof_t0 = time.perf_counter()
        attempted += 1
        try:
            wall, n = loop.step(requests)
        except Exception:   # a request that fails is counted and reported, the loop goes on
            failed += 1
            if failed == 1:
                traceback.print_exc(file=sys.stderr)
            continue
        latencies.append(wall)
        units += n
        if profiling and prof is not None:
            profiled += 1
            span = time.perf_counter() - prof_t0
            if (profiled >= PROFILE_MIN and span >= PROFILE_MIN_S) or profiled >= PROFILE_MAX:
                rf.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                profiling = False
    elapsed = time.perf_counter() - t0
    if profiling and prof is not None:
        rf.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    return (latencies, units, attempted, failed, elapsed, requests,
            prof if profiled else None, profiled)


def check_chip(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoChip("torch.cuda.is_available() is false: this benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise NoChip(f"the cell asks for {chips} cards, torch sees {torch.cuda.device_count()}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: Optional[str] = None, base: Path = catalog.HERE,
        controls: Optional[dict] = None, min_requests: int = 0) -> dict:
    """One run; returns the result line's object.  device=None takes the
    card (and checks for it); tests pass "cpu" at test sizes.  `controls`
    ({name: reference.Prec}; calibrate.py and the tests, never a benchmark
    run) also puts the reference at each control's precision in the
    program's place on the same requests, and judges it as the program is
    judged, under the key "controls"."""
    bench = catalog.benchmark(root)
    cell = catalog.cell(bench, workload)
    config = catalog.config(cell["config"], base)
    mix = catalog.traffic(cell["traffic"], base)
    limits = catalog.limits(cell["name"], base)
    kind = catalog.loop(mix["loop"], base)
    Reference = catalog.reference(config["reference"], base)
    if device is None:
        check_chip(cell["chips"])
        device = "cuda:0"
    dev = torch.device(device)

    scene = catalog.scene(config["scene"], base)(config, seed, dev)
    loop = kind.Loop(scene, config, mix, seed, dev)
    loop.setup()
    if trace:
        # the profiler's first session starts CUPTI, seconds of host time:
        # spent here, not on the window's profiled requests
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device=dev).add_(1)
            drive.fence(dev)
    drive.fence(dev)
    setup_s = time.perf_counter() - t_start

    latencies, units, attempted, failed, elapsed, requests, prof, profiled = _window(
        loop, seconds, trace, min_requests)
    mem_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    profile = None
    if prof is not None:
        from gpubench.device import read_profile

        profile = read_profile(prof, "gpubench.profiled", profiled)
    records = loop.records()
    unit, frames, work = loop.unit, loop.frames, loop.work
    loop.close()
    del loop, prof
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the comparison, after the window, the peak reading and the program's state
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    judge = Reference(scene, config, dev, ref.JUDGE)
    checks, correct = compare.verdict(kind.compare(judge, records) if records else {}, limits,
                                      failed)
    judged_controls = {}
    for name, prec in (controls or {}).items():
        numbers = kind.compare(judge, records, Reference(scene, config, dev, prec))
        judged = compare.verdict(numbers, limits)
        judged_controls[name] = {"numbers": numbers, "correct": judged[1]}
    work_ctx = judge.work(config["deform_params"], frames) if trace else None
    del judge
    result_run = Run(unit=unit, frames=frames, latencies=latencies, units=units,
                     elapsed=elapsed, setup_s=setup_s, work=work, requests=requests or [],
                     profile=profile, work_ctx=work_ctx, base=base)
    metrics = {}
    for m in catalog.metrics_of(bench, cell["name"], "per_layer" if trace else "end_to_end"):
        value = catalog.metric(m["name"], base)(result_run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(mem_peak)}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev_info}
    if profile is not None:
        dev_info["busy_s"] = profile.busy_us() * 1e-6
        dev_info["window_s"] = profile.wall_us * 1e-6
        out["breakdown"] = {"device_ops": profile.device_ops(), "idle_gaps": profile.idle_gaps()}
    if controls:
        out["controls"] = judged_controls
    out["checks"] = checks
    return out
