"""A shot's normal transport of F frames (transport_frames): per needed
pair the distance (8), s (1), phi' (2) and the three (c - x)_b phi' (3)
once on the CUDA cores, and the contraction of 9F columns (18F) on the
fastest pipe of the precision; bytes: points, normals and weight in,
(F, V, 3) normals out, the controls and F frames of weights.  After
chip_smoke._jac_bound."""

from gpubench.peaks import Work, contraction, elementwise


def work(ctx: dict) -> Work:
    p, f, prec = ctx["pairs"], ctx["F"], ctx["precision"]
    return Work(ops=((14 * p, elementwise(prec)), (18 * f * p, contraction(prec))),
                bytes=28 * ctx["V"] + 12 * f * ctx["V"]
                + ctx["real_bytes"] * ctx["N"] * (4 + 3 * f))
