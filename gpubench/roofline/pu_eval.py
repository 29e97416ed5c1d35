"""A pose's PU eval (the node's `eval` stage on a PU rig): per needed pair
(the live controls of every patch whose support holds the point, or of its
fallback patch) 3 differences, d2 5, s 1, the thin-plate phi 5, the
valid mask 1 and the one-pose contraction's 3 FMAs (6): 21 operations on
the CUDA cores, after chip_smoke.py's count of kernel #7 at one pose;
bytes: points and capture distances in, positions and falloff out (32 a
point), and each patch's live controls and weights (6 reals a control)
and center, radius, radius of the basis and tail (17 reals a patch)."""

from gpubench.peaks import Work, elementwise


def work(ctx: dict) -> Work:
    return Work(ops=((21 * ctx["pairs"], elementwise(ctx["precision"])),),
                bytes=32 * ctx["V"] + ctx["real_bytes"] * (6 * ctx["live"] + 17 * ctx["K"]))
