"""The shot's `shot.transport` span (the harness's own, fenced in the traced
run), ms a frame."""


def read(run):
    return run.per_frame("shot.transport") if run.unit == "frames" else None
