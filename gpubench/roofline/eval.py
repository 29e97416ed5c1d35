"""The eval of one pose (the node's `eval` stage): per needed pair the
distance (8 operations), s (1) and the basis (gaussian exp(-s): 2; thin
plate s log s: 5) on the CUDA cores, and the contraction's 3 FMAs (6) on
the fastest pipe of the precision; bytes: points and capture distances in,
positions and falloff out (32 a vertex), and the controls, radii and
weights (7 reals a control).  After chip_smoke.py's #1, #2 and #5 counts."""

from gpubench.peaks import Work, contraction, elementwise


def work(ctx: dict) -> Work:
    p, prec = ctx["pairs"], ctx["precision"]
    return Work(ops=(((9 + ctx["phi_ops"]) * p, elementwise(prec)),
                     (6 * p, contraction(prec))),
                bytes=32 * ctx["V"] + 7 * ctx["real_bytes"] * ctx["N"])
