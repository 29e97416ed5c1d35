"""From process start to the first timed request: imports, inputs, the
kernel build or load, the cold request and the warm-up."""


def read(run):
    return run.setup_s
