"""The eval layer (Deformer.apply, the autotune, the eval kernels), the
`eval` stage's mean ms a cook."""


def read(run):
    return run.mean("eval") if run.unit == "cooks" else None
