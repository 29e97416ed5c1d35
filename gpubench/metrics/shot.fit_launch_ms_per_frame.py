"""Host ms a frame that batched.fit_frames spent other than blocked in
one of the program's own syncs: its span's host time less its
sync.wait_ns.  A library's waits inside the fit (MAGMA's and cuSOLVER's
calls into the CUDA runtime) pass by the program's sync helper and stay
in this number, so it bounds the host's launch time from above: near
shot.fit_ms_per_frame, the fit is bound by its host, by launches or by
a library's waits, which this reading does not tell apart."""

from gpubench import spans


def read(run):
    if run.unit != "frames":
        return None
    fits = spans.roots(run, spans.SHOT[0])
    if fits is None:
        return None
    host_ns = sum(s.t1_ns - s.t0_ns - s.counters.get("sync.wait_ns", 0) for s in fits)
    return host_ns * 1e-6 / (len(fits) * run.frames)
