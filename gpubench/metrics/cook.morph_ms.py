"""The morph layer (ops/dbse.py), the `morph` stage's mean ms a cook."""


def read(run):
    return run.mean("morph") if run.unit == "cooks" else None
