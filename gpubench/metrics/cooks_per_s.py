"""Cooks completed over the whole window (one artist, closed loop)."""


def read(run):
    return run.units / run.elapsed if run.unit == "cooks" and run.units else None
