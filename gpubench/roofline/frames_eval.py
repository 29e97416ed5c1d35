"""A shot's eval of F frames (apply_frames): the distance, s and basis once
a needed pair (11 gaussian, 14 thin plate) on the CUDA cores, the
contraction's 3 FMAs a frame (6F) on the fastest pipe of the precision;
bytes: points and the falloff weight in, (F, V, 3) positions out, the
controls and radii and F frames of weights.  After chip_smoke._frames_bound."""

from gpubench.peaks import Work, contraction, elementwise


def work(ctx: dict) -> Work:
    p, f, prec = ctx["pairs"], ctx["F"], ctx["precision"]
    return Work(ops=(((9 + ctx["phi_ops"]) * p, elementwise(prec)),
                     (6 * f * p, contraction(prec))),
                bytes=16 * ctx["V"] + 12 * f * ctx["V"]
                + ctx["real_bytes"] * ctx["N"] * (4 + 3 * f))
