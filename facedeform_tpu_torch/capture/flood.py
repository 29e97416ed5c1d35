"""Edge-ring flood fill over mesh topology (host-side half of component E).

A copy of facedeform_tpu/capture/flood.py (numpy only):
importing it from there would import the JAX package.

The reference uses HDK's GQ_Detail::groupEdgePoints to expand `max_edges`
edge rings from the mesh vertex nearest each rig marker, then merges the
per-marker groups by the rig's integer `class` attribute
(capture.cpp:107-141).  Per-marker BFS + union is equivalent to one
multi-source BFS per class, which is what this module does — vectorized
frontier expansion over a CSR adjacency, O(max_edges * E) total instead of
O(n_markers * max_edges * E).

Pointer-chasing graph traversal is TPU-hostile (SURVEY.md section 7, hard
part (c)); this stays on the host, cached by the node layer on topology
data ids.  A C++ fast path (native/) can be slotted in behind the same
function signature if profiles demand it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def multi_source_edge_rings(
    indptr: np.ndarray,
    indices: np.ndarray,
    seeds: np.ndarray,
    max_edges: int,
) -> np.ndarray:
    """Vertices within `max_edges` edge hops of any seed.

    Args:
      indptr, indices: CSR adjacency of the mesh (geometry.topology).
      seeds: (S,) vertex indices (one per rig marker of this class).
      max_edges: ring count (reference clamp >= 1, src/SOP_FaceDeform.cpp:257).

    Returns:
      (V,) bool mask of captured vertices (seeds included — matching
      groupEdgePoints, which includes the start vertex).
    """
    n = len(indptr) - 1
    visited = np.zeros(n, dtype=bool)
    if len(seeds) == 0:
        return visited
    # Native C++ fast path (facedeform_tpu_torch/native) — same contract.
    from facedeform_tpu_torch import native

    nat = native.bfs_rings(indptr, indices, np.asarray(seeds, np.int64), max_edges)
    if nat is not None:
        return nat
    visited[seeds] = True
    frontier = np.unique(seeds)
    for _ in range(max(int(max_edges), 1)):
        if len(frontier) == 0:
            break
        # Gather all neighbors of the frontier in one vectorized sweep.
        starts = indptr[frontier]
        ends = indptr[frontier + 1]
        counts = ends - starts
        if counts.sum() == 0:
            break
        # ranges -> flat neighbor index list
        flat = np.concatenate(
            [indices[s:e] for s, e in zip(starts, ends)]
        ) if len(frontier) < 4096 else _gather_neighbors(indptr, indices, frontier)
        nxt = flat[~visited[flat]]
        if len(nxt) == 0:
            break
        visited[nxt] = True
        frontier = np.unique(nxt)
    return visited


def _gather_neighbors(indptr, indices, frontier):
    """Allocation-light neighbor gather for large frontiers."""
    counts = indptr[frontier + 1] - indptr[frontier]
    total = int(counts.sum())
    out = np.empty(total, dtype=indices.dtype)
    # repeat-based range expansion: out[k] = indices[start_i + offset]
    base = np.repeat(indptr[frontier], counts)
    offs = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
    )
    out[:] = indices[base + offs]
    return out


def find_islands(
    indptr: np.ndarray,
    indices: np.ndarray,
    seed_vertices: np.ndarray,
    classes: np.ndarray,
    max_edges: int,
) -> Dict[int, np.ndarray]:
    """Per-class captured-vertex masks (the reference's handler group map,
    capture.cpp:129-137).

    Args:
      seed_vertices: (M,) mesh vertex nearest each rig marker.
      classes: (M,) int class id per marker (all zeros when the rig has no
        `class` attribute, capture.cpp:113-118).

    Returns:
      {class_id: (V,) bool mask}; empty dict if no markers (the reference
      fails capture when no island is found, capture.cpp:53-55).
    """
    out: Dict[int, np.ndarray] = {}
    for cls in np.unique(classes):
        seeds = seed_vertices[classes == cls]
        out[int(cls)] = multi_source_edge_rings(indptr, indices, seeds, max_edges)
    return out
