"""The program's own spans and counters (facedeform_tpu_torch/utils/
profiling.py) in a traced run, for the per-layer metrics of source
`program_span` that read them.

The program records spans only while a torch.profiler session is active,
and the only such session of a run that runs the program is the window's
profiled part, so the newest root spans of an entry point are those of
the profiled requests.  A reader takes them, checks that the trace holds
one range of that entry point per profiled request, and reads the
counters' deltas over the spans, never the counters' totals.  It reads
None where the run profiled nothing or the program records no spans."""

from __future__ import annotations

from typing import Optional

COOK = "FaceDeformNode.cook"
SHOT = ("batched.fit_frames", "batched.apply_frames", "batched.transport_frames")


def roots(run, name: str) -> Optional[list]:
    """The root spans named `name` of the profiled requests, oldest first."""
    if run.profile is None:
        return None
    try:
        from facedeform_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    found = [s for s in spans() if s.parent is None and s.name == name]
    n = run.profile.requests
    in_trace = sum(1 for r in run.profile.ranges if r[0] == name)
    if in_trace != n or len(found) < n:
        raise RuntimeError(f"{n} profiled requests, but {in_trace} {name!r} ranges in the "
                           f"trace and {len(found)} such root spans recorded")
    return found[-n:]


def total(spans: list, *counters: str) -> int:
    """The counters' deltas over the spans, summed."""
    return sum(s.counters.get(c, 0) for s in spans for c in counters)


def inner_ms(roots: list, name: str) -> float:
    """Host ms of the spans named `name` under the roots, summed."""
    from facedeform_tpu_torch.utils.profiling import spans

    ids = {s.request for s in roots}
    return sum(s.ms for s in spans() if s.name == name and s.request in ids)


def shot_roots(run) -> Optional[list]:
    """The three roots of each profiled shot, fit_frames' first."""
    found = [roots(run, name) for name in SHOT]
    return None if found[0] is None else [s for r in found for s in r]
