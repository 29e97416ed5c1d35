"""Rig/deformation symmetry across a mirror plane (a copy of
facedeform_tpu/ops/symmetry.py: host numpy/scipy, no device code).

Facial rigs are overwhelmingly built X-symmetric, and the reference offers
nothing for it: artists mirror marker edits by hand, and any asymmetry in
the scanned/tracked data leaks straight into the deformation
(src/SOP_FaceDeform.cpp:268-287 packs the rig verbatim).  This module
closes that gap with three host-side utilities:

  * `symmetrize_rig`: make the CONTROL DATA closed under the reflection
    (x, d) -> (Rx, Rd).  Every RBF family here depends only on pairwise
    distances (ops/kernels.py), distances commute with reflections, and
    the linear/constant polynomial tails commute too — so a rig closed
    under the reflection provably induces a deformation field with
    f(Rx) = R f(x).  No solver changes, no eval changes: symmetry becomes
    a property of the DATA, which is exactly how the math wants it.
  * `mirror_map`: vertex correspondence of a mesh with its reflection
    (KD-tree nearest over reflected points — native/fastgeo when built).
  * `symmetrize_displacement`: project an already-computed displacement
    field onto its symmetric (or antisymmetric) component across the
    plane — the post-hoc cleanup for meshes that are themselves slightly
    asymmetric, plus `symmetry_error` as the QC metric.

All of it is small host-side numpy (rig-sized, or one mesh KD query that
is cached at node level); nothing runs on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np

from facedeform_tpu_torch.utils import errors

# Named mirror planes: normal per axis, plane through the origin.
PLANE_AXES = {
    "x": (1.0, 0.0, 0.0),
    "y": (0.0, 1.0, 0.0),
    "z": (0.0, 0.0, 1.0),
}

PlaneSpec = Union[str, Tuple]


def _resolve_plane(plane: PlaneSpec) -> tuple[np.ndarray, np.ndarray]:
    """(unit normal (3,), origin point (3,)) from 'x'|'y'|'z', a normal
    triple, or a (normal, origin) pair."""
    origin = np.zeros(3, np.float64)
    if isinstance(plane, str):
        try:
            normal = np.asarray(PLANE_AXES[plane.lower()], np.float64)
        except KeyError:
            raise ValueError(
                f"unknown mirror plane {plane!r}; use 'x'/'y'/'z' or a "
                "(normal, origin) pair"
            ) from None
    else:
        plane = tuple(plane)
        if len(plane) == 2 and np.shape(plane[0]) == (3,):
            normal = np.asarray(plane[0], np.float64)
            origin = np.asarray(plane[1], np.float64)
        elif np.shape(plane) == (3,):
            normal = np.asarray(plane, np.float64)
        else:
            raise ValueError(
                "mirror plane must be 'x'/'y'/'z', a (3,) normal, or a "
                "(normal, origin) pair"
            )
    nrm = float(np.linalg.norm(normal))
    if nrm < 1e-12:
        raise ValueError("mirror plane normal must be non-zero")
    return normal / nrm, origin


def reflection_matrix(plane: PlaneSpec = "x") -> np.ndarray:
    """(3, 3) Householder reflection I - 2 n n^T for the plane's normal."""
    n, _ = _resolve_plane(plane)
    return np.eye(3) - 2.0 * np.outer(n, n)


def reflect_points(points, plane: PlaneSpec = "x") -> np.ndarray:
    """Mirror (V, 3) points across the plane (f32 result)."""
    n, o = _resolve_plane(plane)
    p = np.asarray(points, np.float64)
    return (p - 2.0 * ((p - o) @ n)[:, None] * n).astype(np.float32)


def _nearest(points: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """(M,) nearest-point indices into points, native KD-tree when built."""
    from facedeform_tpu_torch import native

    idx = native.nearest(points, queries)
    if idx is not None:
        return idx
    try:
        from scipy.spatial import cKDTree

        return cKDTree(points).query(queries)[1].astype(np.int64)
    except ImportError:  # tiny-N numpy fallback
        d2 = ((queries[:, None] - points[None]) ** 2).sum(-1)
        return np.argmin(d2, axis=1).astype(np.int64)


def pair_markers(
    rest: np.ndarray, plane: PlaneSpec = "x", tol: Optional[float] = None
) -> tuple[np.ndarray, np.ndarray, float]:
    """Mirror correspondence of a marker set with itself.

    Returns (partner (N,) int64 with -1 for unpaired, on_plane (N,) bool,
    tol_used).  partner[i] = j means R x_i lands within tol of x_j AND the
    match is mutual (both nearest to each other) — one-sided matches stay
    unpaired so a dense cluster can't swallow a lone marker.  on_plane[i]
    marks markers within tol OF THE PLANE itself (signed distance, not
    the self-pair reflection distance: a marker at plane distance d in
    (tol/2, tol] would otherwise be neither on-plane nor pairable, and
    its appended mirror would sit 2d <= 2 tol away — a near-duplicate
    control point).  tol defaults to 5% of the median nearest-neighbor
    spacing: tight enough that genuine pairs snap, loose enough to
    absorb tracker jitter.
    """
    rest = np.asarray(rest, np.float32)
    n_pts = len(rest)
    if n_pts == 0:
        return np.empty(0, np.int64), np.empty(0, bool), 0.0
    n_unit, origin = _resolve_plane(plane)
    refl = reflect_points(rest, plane)
    if tol is None:
        if n_pts >= 2:
            tol = 0.05 * _median_nn_spacing(rest)
        else:
            tol = 1e-6
    # explicit signed plane distance decides on-plane membership
    on_plane = np.abs((rest.astype(np.float64) - origin) @ n_unit) <= tol
    idx = _nearest(rest, refl)
    dist = np.linalg.norm(rest[idx] - refl, axis=1)
    cand = np.where(dist <= tol, idx, -1)
    # mutuality: i -> j only counts if j -> i as well (vectorized — rigs
    # reach 200k markers, no python-per-marker loops)
    valid = cand >= 0
    back = np.full(n_pts, -1, np.int64)
    back[valid] = cand[cand[valid]]
    mutual = np.where(valid & (back == np.arange(n_pts)), cand, -1)
    # on-plane markers are self-pairs regardless of what the KD matched
    mutual = np.where(on_plane, np.arange(n_pts), mutual)
    return mutual, on_plane, float(tol)


def _median_nn_spacing(pts: np.ndarray) -> float:
    """Median nearest-neighbor spacing (scipy KD; exact O(N^2) fallback
    for small sets; bbox estimate beyond that — never the mirror-match
    distances, which are biased by the asymmetry being measured)."""
    try:
        from scipy.spatial import cKDTree

        return float(np.median(cKDTree(pts).query(pts, k=2)[0][:, 1]))
    except ImportError:
        if len(pts) <= 4096:
            d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
            np.fill_diagonal(d2, np.inf)
            return float(np.median(np.sqrt(d2.min(1))))
        # surface-sampled points: spacing ~ sqrt(area / V) ~ diag / sqrt(V)
        diag = float(np.linalg.norm(pts.max(0) - pts.min(0)))
        return diag / max(np.sqrt(len(pts)), 1.0)


class SymmetryReport(NamedTuple):
    """What symmetrize_rig did: counts plus the asymmetry it removed.

    max_asymmetry is the largest |d_i - R d_{partner(i)}| BEFORE
    enforcement — the QC number telling the artist how asymmetric the
    incoming pose data was (0 on already-symmetric data).
    """

    n_paired: int       # markers in mirror pairs (counted per marker)
    n_on_plane: int     # markers on the plane (normal displacement removed)
    n_appended: int     # unpaired markers mirrored and appended
    max_asymmetry: float
    tol: float
    n_skipped: int = 0  # unpaired markers whose mirror would land within
    #                     tol of an existing marker (near-duplicate control
    #                     point -> near-singular system); NOT appended, so
    #                     exact closure is broken around them — the report
    #                     surfaces it for the caller to warn


def _symmetrize_core(
    rest: np.ndarray,       # (N, 3)
    disp: np.ndarray,       # (..., N, 3) f64 — one pose or an (F,) stack
    plane: PlaneSpec,
    tol: Optional[float],
    classes: Optional[np.ndarray],
    confidence: Optional[np.ndarray],
):
    """Shared closure machinery: pair once, enforce on every pose stack.

    Returns (rest' (N', 3) f32, disp' (..., N', 3) f64, classes'|None,
    confidence'|None, SymmetryReport).  Paired markers get the symmetric
    displacement average and snapped rest positions; on-plane markers lose
    their normal components; unpaired markers are mirrored in UNLESS the
    mirror would land within tol of an existing marker (near-duplicate
    control point — skipped and counted in report.n_skipped).  Attribute
    carry: appended copies inherit their source `class`/`confidence`;
    paired markers take the pair's MINIMUM confidence (the symmetric
    average is only as trustworthy as its weaker side).
    """
    n_unit, origin = _resolve_plane(plane)
    r_mat = reflection_matrix(plane).astype(np.float64)
    partner, on_plane, tol_used = pair_markers(rest, plane, tol)
    n_pts = len(rest)

    new_disp = disp.copy()
    max_asym = 0.0
    paired = (partner >= 0) & ~on_plane
    # each pair handled once from its lower-index side (vectorized)
    pi = np.nonzero(paired & (partner > np.arange(n_pts)))[0]
    pj = partner[pi]
    if len(pi):
        want = disp[..., pj, :] @ r_mat.T
        max_asym = float(
            np.linalg.norm(disp[..., pi, :] - want, axis=-1).max()
        )
        avg = 0.5 * (disp[..., pi, :] + want)
        new_disp[..., pi, :] = avg
        new_disp[..., pj, :] = avg @ r_mat.T
    if on_plane.any():
        normal_comp = new_disp[..., on_plane, :] @ n_unit
        max_asym = max(max_asym, float(np.abs(normal_comp).max(initial=0.0)))
        new_disp[..., on_plane, :] -= normal_comp[..., None] * n_unit
    # also snap paired REST positions to exact mirror images (tracker
    # jitter in the rest pose breaks closure just like displacement does)
    new_rest = rest.astype(np.float64)
    if len(pi):
        mirrored_j = (new_rest[pj] - origin) @ r_mat.T + origin
        avg = 0.5 * (new_rest[pi] + mirrored_j)
        new_rest[pi] = avg
        new_rest[pj] = (avg - origin) @ r_mat.T + origin
    if on_plane.any():
        off = (new_rest[on_plane] - origin) @ n_unit
        new_rest[on_plane] -= off[:, None] * n_unit

    unpaired = np.nonzero(partner < 0)[0]
    app_rest = reflect_points(
        new_rest[unpaired].astype(np.float32), plane
    )
    # near-duplicate guard: a mirror landing within tol of ANY existing
    # (snapped) marker would carry a different displacement at a nearly
    # coincident center — near-singular for the exact-interpolation
    # families.  Skip those appends; the report says how many.
    if len(unpaired):
        rest_f32 = new_rest.astype(np.float32)
        near = _nearest(rest_f32, app_rest)
        clash = (
            np.linalg.norm(rest_f32[near] - app_rest, axis=1) <= tol_used
        )
    else:
        clash = np.zeros(0, bool)
    keep = unpaired[~clash]
    app_rest = app_rest[~clash]
    app_disp = new_disp[..., keep, :] @ r_mat.T

    rest_out = np.concatenate(
        [new_rest.astype(np.float32), app_rest], axis=0
    )
    disp_out = np.concatenate([new_disp, app_disp], axis=-2)

    classes_out = None
    if classes is not None:
        classes = np.asarray(classes)
        classes_out = np.concatenate([classes, classes[keep]], axis=0)
    conf_out = None
    if confidence is not None:
        conf_out = np.asarray(confidence, np.float32).copy()
        if len(pi):
            both = np.minimum(conf_out[pi], conf_out[pj])
            conf_out[pi] = both
            conf_out[pj] = both
        conf_out = np.concatenate([conf_out, conf_out[keep]], axis=0)

    report = SymmetryReport(
        n_paired=int(paired.sum()),
        n_on_plane=int(on_plane.sum()),
        n_appended=int(len(keep)),
        max_asymmetry=max_asym,
        tol=tol_used,
        n_skipped=int(clash.sum()),
    )
    return rest_out, disp_out, classes_out, conf_out, report


def symmetrize_rig(
    rest_ctrl,
    deformed_ctrl,
    plane: PlaneSpec = "x",
    tol: Optional[float] = None,
    classes: Optional[np.ndarray] = None,
    confidence: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray], SymmetryReport]:
    """Close the rig under the mirror reflection -> provably symmetric field.

    For paired markers the displacements are replaced by their symmetric
    average d_i' = (d_i + R d_j) / 2 (and d_j' = R d_i'); on-plane markers
    get the normal component of their displacement stripped (R d = d needs
    d.n = 0); unpaired markers are appended mirrored: (R x, R d), carrying
    their `class` capture island id when classes is given, UNLESS the
    mirror would land within tol of an existing marker (a near-duplicate
    control point — skipped and reported in report.n_skipped).  The
    returned rig satisfies the closure property exactly (up to skipped
    markers), so the fitted RBF field commutes with the reflection for
    every kernel family and polynomial tail in the package.

    Pass `confidence` to keep per-marker confidence (ops/fit) consistent
    through the closure: appended copies inherit their source's value,
    paired markers take the pair minimum — retrieve it via
    symmetrize_rig_full when you need it back.

    Returns (rest', deformed', classes'|None, SymmetryReport); use
    symmetrize_rig_full for the confidence output as well.
    """
    rest_out, dfm_out, classes_out, _, report = symmetrize_rig_full(
        rest_ctrl, deformed_ctrl, plane, tol=tol, classes=classes,
        confidence=confidence,
    )
    return rest_out, dfm_out, classes_out, report


def symmetrize_rig_full(
    rest_ctrl,
    deformed_ctrl,
    plane: PlaneSpec = "x",
    tol: Optional[float] = None,
    classes: Optional[np.ndarray] = None,
    confidence: Optional[np.ndarray] = None,
):
    """symmetrize_rig returning every carried attribute:
    (rest', deformed', classes'|None, confidence'|None, report)."""
    rest = np.asarray(rest_ctrl, np.float32)
    dfm = np.asarray(deformed_ctrl, np.float32)
    if rest.shape != dfm.shape:
        raise errors.ShapeMismatchError(
            "Rest and deform geometry should match."
        )
    rest_out, disp_out, classes_out, conf_out, report = _symmetrize_core(
        rest, (dfm - rest).astype(np.float64), plane, tol, classes,
        confidence,
    )
    dfm_out = (rest_out.astype(np.float64) + disp_out).astype(np.float32)
    return rest_out, dfm_out, classes_out, conf_out, report


def symmetrize_frames(
    rest_ctrl,
    deformed_frames,
    plane: PlaneSpec = "x",
    tol: Optional[float] = None,
    classes: Optional[np.ndarray] = None,
    confidence: Optional[np.ndarray] = None,
):
    """symmetrize_rig for a whole (F, N, 3) shot in one pairing pass.

    The mirror pairing and the rest-pose snap depend only on the rest
    rig; running symmetrize_rig per frame would redo the KD build and
    mutual-pairing F times for identical results.  This pairs once and
    enforces the displacement symmetry on all F frames vectorized.

    Returns (rest' (N', 3), frames' (F, N', 3), classes'|None,
    confidence'|None, SymmetryReport).
    """
    rest = np.asarray(rest_ctrl, np.float32)
    frames = np.asarray(deformed_frames, np.float32)
    if frames.ndim != 3 or frames.shape[1:] != rest.shape:
        raise errors.ShapeMismatchError(
            f"deformed_frames {frames.shape} must be (F,) + {rest.shape}"
        )
    rest_out, disp_out, classes_out, conf_out, report = _symmetrize_core(
        rest, (frames - rest[None]).astype(np.float64), plane, tol,
        classes, confidence,
    )
    frames_out = (rest_out[None].astype(np.float64) + disp_out).astype(
        np.float32
    )
    return rest_out, frames_out, classes_out, conf_out, report


def mirror_map(
    points, plane: PlaneSpec = "x", tol: Optional[float] = None
) -> tuple[np.ndarray, np.ndarray]:
    """Vertex correspondence of a mesh with its reflection.

    Returns (idx (V,) int64, ok (V,) bool): idx[v] is the vertex nearest
    R p_v; ok[v] says the match landed within tol (default 10% of median
    NN spacing).  Vertices with ok False (genuinely asymmetric topology)
    are left untouched by symmetrize_displacement.
    """
    pts = np.asarray(points, np.float32)
    refl = reflect_points(pts, plane)
    idx = _nearest(pts, refl)
    dist = np.linalg.norm(pts[idx] - refl, axis=1)
    if tol is None:
        # NN spacing, never the mirror-match distances: on a slightly
        # asymmetric mesh those have a positive median, and a tol derived
        # from them marks ~half the vertices unmatched by construction
        tol = 0.1 * _median_nn_spacing(pts)
    ok = dist <= float(tol)
    # MUTUAL matches only (same rule as pair_markers): on a mesh sampled
    # more densely on one side, idx[v]=m with idx[m]=v' != v makes the
    # map non-involutive — symmetrize_displacement would then not be the
    # orthogonal projection its contract promises (not idempotent, and
    # symmetry_error of the result stays nonzero).  Such vertices count
    # as unmatched and keep their original displacement.
    ok = ok & (idx[idx] == np.arange(len(idx)))
    return idx, ok


def symmetrize_displacement(
    disp,
    mirror_idx: np.ndarray,
    ok: np.ndarray,
    plane: PlaneSpec = "x",
    part: str = "symmetric",
) -> np.ndarray:
    """Project a (V, 3) displacement field onto its symmetric (or
    antisymmetric) component: d_sym(v) = (d(v) ± R d(m(v))) / 2.

    Vertices without a mirror partner (ok False) keep their original
    displacement.  This is an orthogonal projection, so applying it twice
    is a no-op and ||d_sym|| <= ||d||.
    """
    if part not in ("symmetric", "antisymmetric"):
        raise ValueError("part must be 'symmetric' or 'antisymmetric'")
    d = np.asarray(disp, np.float64)
    r_mat = reflection_matrix(plane).astype(np.float64)
    mirrored = d[mirror_idx] @ r_mat.T
    sign = 1.0 if part == "symmetric" else -1.0
    out = 0.5 * (d + sign * mirrored)
    out = np.where(ok[:, None], out, d)
    return out.astype(np.float32)


def symmetry_error(
    disp, mirror_idx: np.ndarray, ok: np.ndarray, plane: PlaneSpec = "x"
) -> float:
    """max |d(v) - R d(m(v))| over matched vertices — the QC scalar (0 for
    a perfectly symmetric deformation)."""
    d = np.asarray(disp, np.float64)
    r_mat = reflection_matrix(plane).astype(np.float64)
    resid = d - d[mirror_idx] @ r_mat.T
    resid = resid[np.asarray(ok, bool)]
    return float(np.linalg.norm(resid, axis=1).max(initial=0.0))
