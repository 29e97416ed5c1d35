"""The shot's `shot.fit` span (the harness's own, fenced in the traced
run), ms a frame."""


def read(run):
    return run.per_frame("shot.fit") if run.unit == "frames" else None
