"""A shot's fit: F poses of one rest rig need one factorization (2/3 R^3)
and F solves of 3 columns (12 R^2 each), R the controls and the 4 tail
rows, on the fastest pipe of the precision; bytes: the system once and
the F right-hand sides and solutions."""

from gpubench.peaks import Work, contraction


def work(ctx: dict) -> Work:
    r, f = ctx["N"] + 4, ctx["F"]
    return Work(ops=((2 / 3 * r ** 3 + 12 * f * r * r, contraction(ctx["precision"])),),
                bytes=ctx["real_bytes"] * (r * r + 6 * f * r))
