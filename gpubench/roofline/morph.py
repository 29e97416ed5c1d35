"""The morph of one pose (DBSE, float32 in every configuration): B^T d and
the reconstruction B w, 2 S 3V operations each, as float32-accurate
contractions; bytes: the (S, V, 3) basis read once, the RBF positions and
rest in, positions out (4 S 3V + 36 V).  The Gram is pose-independent."""

from gpubench.peaks import Work, contraction


def work(ctx: dict) -> Work:
    s, v = ctx["S"], ctx["V"]
    return Work(ops=((4 * s * 3 * v, contraction("float32")),), bytes=12 * s * v + 36 * v)
