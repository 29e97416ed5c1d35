"""A drag's fit: the new pose solved against the rest rig's stored
factorization, two triangular solves of 3 columns (12 R^2 operations, R
the controls and the 4 tail rows) on the fastest pipe of the precision;
bytes: the factors read once (R^2 reals)."""

from gpubench.peaks import Work, contraction


def work(ctx: dict) -> Work:
    r = ctx["N"] + 4
    return Work(ops=((12 * r * r, contraction(ctx["precision"])),),
                bytes=ctx["real_bytes"] * r * r)
