"""The eval kernels' share of their roofline in a cook: the least time of
one pose's needed eval (roofline/eval.py) over the device time of every
kernel launched inside the node's `eval` range (packing, tables and the
autotune's launches included), profiled cooks."""


def read(run):
    return run.roofline_pct("eval", "eval") if run.unit == "cooks" else None
