"""The fit layer (ops/fit.py, FitPlan.refit), the `solve` stage's mean ms a cook."""


def read(run):
    return run.mean("solve") if run.unit == "cooks" else None
