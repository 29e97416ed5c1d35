"""The eval of one pose of a multilayer rig with a tangent frame (the
node's `eval` stage on kernels #1/#2 at L > 1): per needed layer-0 pair
the distance (8 operations) once, per needed (pair, layer) s and the
exponential (3) on the CUDA cores and the contraction's 3 FMAs (6) on the
fastest pipe of the precision, and per projected vertex the oblique
tangent projection of csrc/common.cuh (project_tangent): five
normalisations of 10 operations (3 products, 2 sums, a max, a reciprocal
square root, 3 scalings), six dot products of 5, the two axes' 30 and the
projection's 19 (two dot products and 9), 129 operations; bytes: points,
capture distance and the three frame vectors in, positions and falloff
out (68 a vertex), and the controls, L radii and 3 L weights a control.
A layer's needed pairs lie within the gaussian's cutoff at that layer's
radius, so layer 0's hold every other layer's."""

from gpubench.peaks import Work, contraction, elementwise

#: operations of one vertex's tangent projection (project_tangent)
PROJECTION_OPS = 129


def work(ctx: dict) -> Work:
    pairs, prec, n_layers = ctx["layer_pairs"], ctx["precision"], ctx["L"]
    triples = sum(pairs)
    return Work(ops=((8 * pairs[0] + 3 * triples + PROJECTION_OPS * ctx["projected"],
                      elementwise(prec)),
                     (6 * triples, contraction(prec))),
                bytes=68 * ctx["V"] + ctx["real_bytes"] * ctx["N"] * (3 + 4 * n_layers))
