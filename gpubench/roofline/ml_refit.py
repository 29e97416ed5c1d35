"""A pose's least refit of a multilayer rig: each layer's solve against its
stored factors, two triangular solves of 3 columns (12 R_l^2 operations,
R_0 = N + 4 with the tail rows, R_l = N past it), and the L - 1 residual
products between layers (Phi_l w_l at the markers, 6 N^2 each), on the
fastest pipe of the precision; bytes: the L factors read once.  As
roofline/refit.py counts one layer's solve."""

from gpubench.peaks import Work, contraction


def work(ctx: dict) -> Work:
    n, n_layers = ctx["N"], ctx["L"]
    rows = [(n + 4) ** 2] + [n * n] * (n_layers - 1)
    return Work(ops=((12 * sum(rows) + 6 * n * n * (n_layers - 1),
                      contraction(ctx["precision"])),),
                bytes=ctx["real_bytes"] * sum(rows))
