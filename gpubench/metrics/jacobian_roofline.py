"""The transport's share of its roofline in a shot: the least time of the
shot's needed normal transport (roofline/jacobian.py) over the device time
of every kernel launched inside the `shot.transport` span."""


def read(run):
    return run.roofline_pct("jacobian", "shot.transport") if run.unit == "frames" else None
