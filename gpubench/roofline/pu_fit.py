"""A pose's least PU fit: each patch's solve against its stored factors,
two triangular solves of 3 columns (12 (n_k + 4)^2 operations, n_k the
patch's live controls and the 4 tail rows) on the fastest pipe of the
precision; bytes: the factors read once (sum of (n_k + 4)^2 reals).
As roofline/refit.py counts a global rig's."""

from gpubench.peaks import Work, contraction


def work(ctx: dict) -> Work:
    return Work(ops=((12 * ctx["systems"], contraction(ctx["precision"])),),
                bytes=ctx["real_bytes"] * ctx["systems"])
