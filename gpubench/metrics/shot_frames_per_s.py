"""Frames delivered (positions and transported normals in host memory)
over the whole window."""


def read(run):
    return run.units / run.elapsed if run.unit == "frames" and run.units else None
