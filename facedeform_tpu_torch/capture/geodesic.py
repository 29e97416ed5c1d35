"""Geodesic (edge-graph) capture distances — the lip-bleed fix.

A copy of facedeform_tpu/capture/geodesic.py (numpy only):
importing it from there would import the JAX package.

The reference measures falloff distance EUCLIDEAN, straight through space
to the nearest rig primitive (capture.cpp:81-86).  On a face that leaks:
a marker on the upper lip is millimetres from the lower lip through the
mouth gap, so euclidean falloff drags the lower lip along even though the
surface path between them runs all the way around the mouth corner.  The
flood-fill islands only gate *attenuation* (SURVEY.md quirk 1), so
maxedges does not save you.

cfg.falloff_metric="geodesic" measures the distance ALONG the mesh
instead: multi-source Dijkstra over the edge graph (weights = edge
lengths), seeded at the mesh vertex nearest each marker with the
marker-to-seed euclidean offset as the initial distance — so the measure
degrades gracefully to euclidean for markers hovering off-surface, and on
a straight edge path it equals the euclidean distance exactly.

Host-side irregular work, like the flood fill (SURVEY.md section 7 "keep
the irregular capture on host"): native C++ binary-heap Dijkstra in
fastgeo.cpp with a scipy.sparse.csgraph fallback.  The result is a plain
(V,) distance array; everything downstream (falloff curve, viz colors,
strict-parity sentinel) is unchanged device math.
"""

from __future__ import annotations

import numpy as np

# Distances are squared downstream (d^2 / r^2): cap so unreachable
# components stay finite after squaring (1e17^2 = 1e34 < f32 max).
UNREACHABLE = 1e17


def geodesic_distance(
    indptr: np.ndarray,
    indices: np.ndarray,
    points: np.ndarray,
    sources: np.ndarray,
    source_offsets: np.ndarray | None = None,
) -> np.ndarray:
    """(V,) f32 multi-source geodesic distance over the CSR edge graph.

    sources are vertex indices; source_offsets (same length) are initial
    distances (the marker-to-seed euclidean gap).  Unreachable vertices
    get UNREACHABLE (finite, squares without overflow).
    """
    from facedeform_tpu_torch import native

    sources = np.atleast_1d(np.asarray(sources, np.int64))
    if source_offsets is None:
        source_offsets = np.zeros(len(sources), np.float32)
    d = native.dijkstra(indptr, indices, points, sources, source_offsets)
    if d is None:
        d = _dijkstra_scipy(indptr, indices, points, sources, source_offsets)
    return np.minimum(d, UNREACHABLE).astype(np.float32)


def _dijkstra_scipy(indptr, indices, points, sources, source_offsets):
    """scipy.sparse.csgraph fallback: a virtual super-source node carries
    the per-seed offsets as edge weights (duplicate seeds resolved to the
    minimum offset — a COO build would SUM duplicates)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra as sp_dijkstra

    n = len(indptr) - 1
    points = np.asarray(points, np.float64)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    w = np.linalg.norm(points[rows] - points[indices], axis=1)

    best: dict[int, float] = {}
    for s, off in zip(sources.tolist(), np.asarray(source_offsets).tolist()):
        if 0 <= s < n:
            best[s] = min(best.get(s, np.inf), float(off))
    if not best:
        return np.full(n, np.inf, np.float32)
    src = np.fromiter(best.keys(), np.int64)
    off = np.fromiter(best.values(), np.float64)
    # scipy dijkstra rejects zero-weight entries being dropped implicitly;
    # nudge exact-zero offsets to a tiny epsilon so the virtual edges exist.
    off = np.maximum(off, 1e-30)

    data = np.concatenate([w, off])
    r = np.concatenate([rows, np.full(len(src), n, np.int64)])
    c = np.concatenate([indices.astype(np.int64), src])
    g = sp.coo_matrix((data, (r, c)), shape=(n + 1, n + 1)).tocsr()
    d = sp_dijkstra(g, directed=True, indices=n)
    return d[:n].astype(np.float32)
