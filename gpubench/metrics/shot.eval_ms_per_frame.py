"""The shot's `shot.eval` span (the harness's own, fenced in the traced
run), ms a frame."""


def read(run):
    return run.per_frame("shot.eval") if run.unit == "frames" else None
