"""The shot's `shot.output` span (the harness's own, fenced in the traced
run), ms a frame."""


def read(run):
    return run.per_frame("shot.output") if run.unit == "frames" else None
