"""Stage timing, spans, counters and device traces (port of
facedeform_tpu/utils/profiling.py).

  * stage(name, times, *sync) — context manager: wall-clock per pipeline
    stage, fenced with torch.cuda.synchronize() whenever CUDA is in use:
    without the fence a wall time measures the launch queue, not the
    work; annotated as a record_function range in torch.profiler traces,
    and a span;
  * StageTimes — collected per-stage milliseconds (the solve/eval split is
    the headline observability metric);
  * span(name), traced(name) — a named interval of the program's work:
    its parent span, a request id shared by every span under one root
    (an entry point: FaceDeformNode.cook, batched.fit_frames, ...), its
    host start and end and the counters' deltas over it.  Spans record
    only while a torch.profiler session is active, each as a
    record_function range too, into a bounded buffer (spans()); with no
    profiler a span costs one check and enters no range;
  * count(name, n), counter(name), counters() — the one registry of
    counters; they always count (kernel launches as launches.<kernel>).
    Each module registers its counters when it is imported (count(name,
    0)), and counter() refuses a name never registered;
  * to_host, host_f32, to_device, blocking — every host/device crossing
    of the program goes through these: each counts sync.count and
    sync.wait_ns (the time the host blocked) and the bytes it moves
    (copy.dtoh_bytes, copy.htod_bytes), only when the data crosses
    devices.  A CUDA sync debug mode is suspended inside them alone, so
    torch.cuda.set_sync_debug_mode("error") raises on any other sync.
    The fences of stage() and sync() count as fence.count and
    fence.wait_ns, never as syncs;
  * trace(logdir) — a torch.profiler run with CUDA activity, written as a
    Chrome trace (logdir/trace.json, with the counters as counter events)
    and the spans it recorded (logdir/spans.json), both on the trace's
    clock.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

#: spans kept in memory, the newest (about a thousand cooks' worth)
SPAN_CAPACITY = 1 << 14
#: the ranges trace() opens first: each one's host stamp against its trace
#: `ts` gives the offset from the spans' host clock to the trace's clock;
#: the offset is the median of ANCHORS ranges' (the session's first range
#: takes over a millisecond to open).
ANCHOR, ANCHORS = "profiling.anchor", 8

_profiling = torch._C._autograd._profiler_enabled


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


# ------------------------------------------------------------------ counters
_COUNTS: Dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counter(name: str) -> int:
    """The counter's total since the process started; KeyError for a name
    no module registered."""
    try:
        return _COUNTS[name]
    except KeyError:
        raise KeyError(f"no counter {name!r}; registered: {sorted(_COUNTS)}") from None


def counters() -> Dict[str, int]:
    """A snapshot of every counter."""
    return dict(_COUNTS)


for _name in ("sync.count", "sync.wait_ns", "fence.count", "fence.wait_ns",
              "copy.dtoh_bytes", "copy.htod_bytes"):
    count(_name, 0)


# --------------------------------------------------------------------- spans
class Span:
    """One recorded span.  t0_ns and t1_ns are time.perf_counter_ns() host
    stamps of its record_function range's opening and closing, each the
    midpoint of the call (the profiler stamps the range inside it; the
    call takes microseconds to tens of them); `counters` holds the
    counters that moved over it, by how much, and `start` their values
    when it opened (the trace's counter events)."""

    __slots__ = ("id", "name", "parent", "request", "t0_ns", "t1_ns", "counters", "start")

    @property
    def ms(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-6

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"request={self.request}, {self.ms:.3f} ms, {self.counters})")


class _Recorder:
    def __init__(self, capacity: int) -> None:
        self.done: collections.deque = collections.deque(maxlen=capacity)
        self.open_spans: List[Span] = []
        self.next_id = 0
        self.next_request = 0

    def open(self, name: str, before_ns: int) -> Span:
        """A span whose range opened in a call that began at before_ns."""
        s = Span()
        s.t0_ns = (before_ns + time.perf_counter_ns()) // 2
        s.id, s.name = self.next_id, name
        self.next_id += 1
        if self.open_spans:
            up = self.open_spans[-1]
            s.parent, s.request = up.id, up.request
        else:
            s.parent, s.request = None, self.next_request
            self.next_request += 1
        self.open_spans.append(s)
        s.start = dict(_COUNTS)
        return s

    def close(self, s: Span, before_ns: int) -> None:
        """Close s, whose range closed in a call that began at before_ns."""
        s.t1_ns = (before_ns + time.perf_counter_ns()) // 2
        start = s.start
        s.counters = {k: v - start.get(k, 0) for k, v in _COUNTS.items()
                      if v != start.get(k, 0)}
        s.start = {k: start.get(k, 0) for k in s.counters}
        while self.open_spans and self.open_spans.pop() is not s:
            pass
        self.done.append(s)


_REC = _Recorder(SPAN_CAPACITY)


def spans() -> List[Span]:
    """The recorded spans still in the buffer, in the order they opened."""
    return sorted(_REC.done, key=lambda s: s.id)


class span:
    """with span(name): a span of the program's work while a
    torch.profiler session is active, nothing (but one check) otherwise."""

    __slots__ = ("name", "_rf", "_rec")

    def __init__(self, name: str) -> None:
        self.name = name
        self._rec = None

    def __enter__(self) -> "span":
        if _profiling():
            self._rf = torch.profiler.record_function(self.name)
            t = time.perf_counter_ns()
            self._rf.__enter__()
            self._rec = _REC.open(self.name, t)
        return self

    def __exit__(self, *exc) -> bool:
        if self._rec is not None:
            t = time.perf_counter_ns()
            self._rf.__exit__(*exc)
            _REC.close(self._rec, t)
        return False


def traced(name: str):
    """Decorator: every call of the function is a span named `name`, a
    root span (a request) when no span is open."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


# ----------------------------------------------------------------- crossings
def _on_card(device: torch.device) -> bool:
    """Whether data on `device` has to cross to reach the host."""
    return device.type != "cpu"


class blocking:
    """with blocking(device): a call that makes the host wait for the
    device: a blocking copy, an event's synchronize, a library call that
    reads its result on the host.  On a card it counts one sync.count and
    the wait in sync.wait_ns (kind="fence": fence.count, fence.wait_ns)
    and suspends torch.cuda's sync debug mode for the call; on the host
    it counts nothing."""

    __slots__ = ("device", "kind", "mode", "t0")

    def __init__(self, device, kind: str = "sync") -> None:
        self.device = torch.device(device)
        self.kind = kind

    def __enter__(self) -> "blocking":
        self.mode, self.t0 = 0, None
        if _on_card(self.device):
            if self.device.type == "cuda" and torch.cuda.is_available():
                self.mode = torch.cuda.get_sync_debug_mode()
                if self.mode:
                    torch.cuda.set_sync_debug_mode(0)
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.t0 is not None:
            wait = time.perf_counter_ns() - self.t0
            if self.mode:
                torch.cuda.set_sync_debug_mode(self.mode)
            count(self.kind + ".count")
            count(self.kind + ".wait_ns", wait)
        return False


def to_host(t: torch.Tensor) -> torch.Tensor:
    """t on the host: a card tensor's blocking copy (one sync, its bytes in
    copy.dtoh_bytes); a host tensor as it is.  bool(), int() and .item()
    of a card tensor read it through here."""
    t = t.detach()
    if not _on_card(t.device):
        return t.cpu()
    with blocking(t.device):
        out = t.cpu()
    count("copy.dtoh_bytes", out.numel() * out.element_size())
    return out


def host_f32(a) -> np.ndarray:
    """A float32 numpy copy of a tensor (on any device, through to_host) or
    of an array; a float32 array as it is."""
    if isinstance(a, torch.Tensor):
        a = to_host(a).numpy()
    return np.asarray(a, np.float32)


def to_device(x, device, dtype=None) -> torch.Tensor:
    """torch.as_tensor(x, dtype=dtype, device=device); a host array's copy to
    a card is counted: its bytes in copy.htod_bytes and one sync, since a
    copy from pageable memory waits for the card's queue.  device None
    keeps x where it is, as torch.as_tensor does."""
    if device is None:
        return torch.as_tensor(x, dtype=dtype)
    device = torch.device(device)
    if not _on_card(device) or (isinstance(x, torch.Tensor) and _on_card(x.device)):
        return torch.as_tensor(x, dtype=dtype, device=device)
    host = torch.as_tensor(x, dtype=dtype)
    with blocking(device):
        out = host.to(device)
    count("copy.htod_bytes", out.numel() * out.element_size())
    return out


def sync(*tensors) -> None:
    """Fence device execution: torch.cuda.synchronize() on the device of
    the first CUDA tensor given; host tensors and arrays need no fence.
    Counted as a fence."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            with blocking(t.device, "fence"):
                torch.cuda.synchronize(t.device)
            return


@contextlib.contextmanager
def stage(name: str, times: Optional[StageTimes] = None, *sync_tensors):
    """Time a pipeline stage; annotates torch.profiler traces and is a span.

    When times is given, the stage's device work is inside its time: the
    exit fences the device of the first CUDA tensor in sync_tensors, or,
    with none, the current CUDA device once CUDA is initialized.  An
    untimed run is never fenced and keeps its launches queued."""
    t0 = time.perf_counter()
    with span(name) if _profiling() else torch.profiler.record_function(name):
        yield
    if times is not None:
        if any(isinstance(t, torch.Tensor) and t.device.type == "cuda"
               for t in sync_tensors):
            sync(*sync_tensors)
        elif torch.cuda.is_initialized():
            with blocking("cuda", "fence"):
                torch.cuda.synchronize()
        times.add(name, (time.perf_counter() - t0) * 1e3)


# -------------------------------------------------------------------- export
def _on_trace_clock(recorded: List[Span], offset_us: float, base: Dict[str, int]) -> tuple:
    """(spans as JSON objects, Chrome counter events) on the trace's clock;
    counter values count from `base`, the counters when the trace began."""
    out, events = [], []
    for s in recorded:
        t0, t1 = s.t0_ns * 1e-3 + offset_us, s.t1_ns * 1e-3 + offset_us
        out.append({"id": s.id, "name": s.name, "parent": s.parent, "request": s.request,
                    "ts": t0, "dur": t1 - t0, "counters": s.counters})
        for k, d in s.counters.items():
            v0 = s.start[k] - base.get(k, 0)
            events.append((t0, k, v0))
            events.append((t1, k, v0 + d))
    return out, sorted(events)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace (CPU activity, and CUDA activity when
    a card is present) and write it as logdir/trace.json (Chrome trace
    format, viewable in Perfetto or chrome://tracing), the counters that
    moved as counter events in it, and the spans the run recorded as
    logdir/spans.json on the trace's clock (`ts`, `dur` in the trace's
    microseconds).  Yields the profiler, whose key_averages() summarise
    the run."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    first, base = _REC.next_id, counters()
    stamps = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(ANCHORS):
            rf = torch.profiler.record_function(ANCHOR)
            t = time.perf_counter_ns()
            with rf:
                stamps.append((t + time.perf_counter_ns()) // 2)
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    anchors = sorted((e for e in doc["traceEvents"] if e.get("ph") == "X"
                      and e.get("cat") == "user_annotation" and e.get("name") == ANCHOR),
                     key=lambda e: float(e["ts"]))
    offset_us = statistics.median(float(e["ts"]) - ns * 1e-3 for e, ns in zip(anchors, stamps))
    recorded, events = _on_trace_clock([s for s in spans() if s.id >= first], offset_us, base)
    doc["traceEvents"] += [{"ph": "C", "name": k, "ts": ts, "pid": anchors[0]["pid"],
                            "args": {"value": v}} for ts, k, v in events]
    with open(path, "w") as f:
        json.dump(doc, f)
    total = {k: v - base.get(k, 0) for k, v in counters().items() if v != base.get(k, 0)}
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump({"spans": recorded, "counters": total}, f)
