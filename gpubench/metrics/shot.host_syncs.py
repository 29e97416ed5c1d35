"""Host syncs a shot: the program's sync.count over the batched.fit_frames,
apply_frames and transport_frames spans (the harness's own fences and
its pinned output copies are not the program's)."""

from gpubench import spans


def read(run):
    if run.unit != "frames":
        return None
    shot = spans.shot_roots(run)
    return None if shot is None else spans.total(shot, "sync.count") / run.profile.requests
