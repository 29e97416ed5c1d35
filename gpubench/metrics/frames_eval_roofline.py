"""The frames eval kernels' share of their roofline in a shot: the least
time of the shot's needed eval (roofline/frames_eval.py) over the device
time of every kernel launched inside the `shot.eval` span."""


def read(run):
    return run.roofline_pct("frames_eval", "shot.eval") if run.unit == "frames" else None
