"""Rig/mesh QC: lint the inputs BEFORE a fit goes wrong (port of
facedeform_tpu/doctor.py).

A copy of the JAX package's host module over the port's capture, Deformer,
fit routing, errors, symmetry and temporal filter, with a `device` for
the capture's distances and the solve probe.  Findings and stats equal
the JAX package's on the same inputs.

The reference's only diagnostics fire after the fact — node errors when
point counts mismatch (src/SOP_FaceDeform.cpp:231-234) and the solver's
terminationtype once the build already failed (:363-368).  In production
the questions arrive earlier: "why does my deform look wrong?", "is my
radius sane?", "did the tracker glitch?".  `diagnose()` answers them from
the inputs alone, reusing the framework's own machinery (capture,
symmetry pairing, the solve health check, the temporal filter) so the
advice always matches what the fit will actually do.

Findings carry a stable machine `code` plus a human message; the CLI
`doctor` subcommand prints them (or --json for pipelines) and exits 1
only on errors — warnings are advice, not gates.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from facedeform_tpu_torch.config import DeformConfig, DeformParams, RBFModelType

__all__ = ["Finding", "DoctorReport", "diagnose"]


class Finding(NamedTuple):
    severity: str   # "error" | "warning" | "info"
    code: str       # stable machine key, e.g. "duplicate-markers"
    message: str


class DoctorReport(NamedTuple):
    findings: List[Finding]
    stats: dict     # machine-readable numbers backing the findings

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    def summary(self) -> str:
        n_e, n_w = len(self.errors), len(self.warnings)
        if not self.findings:
            return "clean: no findings"
        return f"{n_e} error(s), {n_w} warning(s), " \
               f"{len(self.findings) - n_e - n_w} note(s)"


def _finite_check(name: str, pts: np.ndarray, out: List[Finding]) -> bool:
    bad = ~np.isfinite(pts)
    if bad.any():
        out.append(Finding(
            "error", "non-finite-positions",
            f"{name}: {int(bad.any(axis=1).sum())} point(s) carry "
            "NaN/inf positions",
        ))
        return False
    return True


def _scale_overlap(mesh_pts, rig_pts, out, stats) -> None:
    """Units/transform mismatch: the classic 'nothing deforms' failure."""
    m_lo, m_hi = mesh_pts.min(0), mesh_pts.max(0)
    r_lo, r_hi = rig_pts.min(0), rig_pts.max(0)
    m_diag = float(np.linalg.norm(m_hi - m_lo))
    r_diag = float(np.linalg.norm(r_hi - r_lo))
    gap = float(np.linalg.norm(
        np.maximum(0.0, np.maximum(r_lo - m_hi, m_lo - r_hi))
    ))
    stats["mesh_bbox_diag"] = m_diag
    stats["rig_bbox_diag"] = r_diag
    stats["bbox_gap"] = gap
    if gap > 0.5 * max(m_diag, 1e-30):
        out.append(Finding(
            "error", "no-overlap",
            f"rig and mesh bounding boxes are {gap:.3g} apart (mesh "
            f"diagonal {m_diag:.3g}) — units or transform mismatch? the "
            "deformation will extrapolate garbage",
        ))
    elif r_diag > 0 and m_diag > 0 and not (
        0.01 < r_diag / m_diag < 100.0
    ):
        out.append(Finding(
            "warning", "scale-mismatch",
            f"rig spans {r_diag:.3g} vs mesh {m_diag:.3g} "
            f"({r_diag / m_diag:.1e}x) — check import units",
        ))


def _marker_spacing(rig_pts, params, out, stats) -> float:
    n = rig_pts.shape[0]
    if n < 2:
        # no spacing to measure (the tiny-rig warning already fired);
        # skip rather than emit inf-based advice
        stats["median_marker_spacing"] = 0.0
        stats["near_duplicate_markers"] = 0
        return 0.0
    # exact min-NN (cheap at rig sizes)
    try:
        from scipy.spatial import cKDTree

        d_nn = cKDTree(rig_pts).query(rig_pts, k=2)[0][:, 1]
    except ImportError:
        d2 = ((rig_pts[:, None] - rig_pts[None]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        d_nn = np.sqrt(d2.min(1))
    # median over NONZERO spacings: a rig whose markers are exported
    # twice (the canonical duplicate bug) has median NN spacing 0, which
    # would make the 5%-of-median duplicate test vacuous exactly when it
    # matters most
    pos = d_nn[(d_nn > 0) & np.isfinite(d_nn)]
    if pos.size == 0:
        out.append(Finding(
            "error", "all-markers-coincident",
            f"every one of the {n} markers coincides with another — the "
            "RBF system is singular",
        ))
        stats["median_marker_spacing"] = 0.0
        stats["near_duplicate_markers"] = n
        return 0.0
    med = float(np.median(pos))
    stats["median_marker_spacing"] = med
    # absolute floor too: duplicates at exactly 0 distance must count
    # even against a healthy median
    n_dup = int((d_nn < max(0.05 * med, 1e-12)).sum())
    stats["near_duplicate_markers"] = n_dup
    if n_dup:
        out.append(Finding(
            "warning", "duplicate-markers",
            f"{n_dup} of {n} markers sit within 5% of the median marker "
            f"spacing ({med:.3g}) of a neighbor — near-duplicate control "
            "points make the RBF system near-singular; merge them or "
            "rely on a ridge (lambda / confidence)",
        ))

    # radius doubles as the capture/falloff cutoff AND the kernel scale
    # (SOP_FaceDeform.cpp:347,402-408); the PU auto rule (2x median NN
    # spacing, ops/pu.py eps="auto") is the sane default scale
    radius = max(float(params.radius), 0.01)
    suggested = 2.0 * med
    stats["radius"] = radius
    stats["suggested_radius"] = suggested
    if radius < 0.25 * suggested:
        out.append(Finding(
            "warning", "radius-small",
            f"radius {radius:g} is well under the marker spacing scale "
            f"(suggested ~{suggested:.3g}): with dofalloff the cutoff "
            "d2 > r2 will freeze most of the mesh, and MULTILAYER/KERNEL "
            "kernels will spike at the markers",
        ))
    elif radius > 4.0 * suggested:
        out.append(Finding(
            "info", "radius-large",
            f"radius {radius:g} is {radius / max(suggested, 1e-30):.1f}x "
            f"the marker-spacing scale (~{suggested:.3g}): the "
            "deformation is effectively global and falloff rarely "
            "attenuates",
        ))
    return med


def _capture_coverage(mesh, rest_rig, cfg, params, group_mask, out, stats, device):
    from facedeform_tpu_torch.capture.capture import ProximityCapture

    maxedges = max(int(params.maxedges), 1)
    radius = max(float(params.radius), 0.01)
    try:
        cap = ProximityCapture(device=device)
        cap.init(mesh, rest_rig)
        res = cap.capture(
            maxedges, radius, True, float(params.falloffrate),
            strict_parity=cfg.strict_parity, metric=cfg.falloff_metric,
        )
    except Exception as e:  # capture failures are themselves the finding
        out.append(Finding(
            "warning", "capture-failed",
            f"capture pass failed ({e}) — island/falloff checks skipped",
        ))
        return
    sel = group_mask if group_mask is not None else np.ones(
        mesh.num_points, bool
    )
    v_sel = max(int(sel.sum()), 1)
    cap_frac = float((res.captured & sel).sum()) / v_sel
    stats["captured_fraction"] = cap_frac
    # quirk 1 (SURVEY.md): UNcaptured vertices deform fully (d2 stays 0)
    if cap_frac < 0.05:
        out.append(Finding(
            "warning", "capture-sparse",
            f"only {cap_frac * 100:.1f}% of the target points fall in "
            f"capture islands at maxedges={maxedges} — note uncaptured "
            "vertices still deform FULLY (falloff 1, the reference's "
            "d2=0 default); raise maxedges if you expected coverage",
        ))
    # of the captured verts, how many found no rig prim within radius
    d2 = np.asarray(res.dist2)
    inside = res.captured & sel
    # the clipping advice only applies when the user's config actually
    # computes falloff distances — with dofalloff=False the deform
    # applies weight 1 everywhere and nothing clips
    if inside.any() and cfg.dofalloff:
        far = float((d2[inside] >= radius * radius).mean())
        stats["captured_beyond_radius_fraction"] = far
        if far > 0.5:
            out.append(Finding(
                "info", "falloff-clips",
                f"{far * 100:.0f}% of captured vertices lie beyond the "
                f"falloff radius {radius:g} (falloff 0 there) — the "
                "active band is thin; consider a larger radius",
            ))


def _solve_probe(rest_rig_pts, posed_pts, cfg, params, confidence, out, stats, device):
    from facedeform_tpu_torch.deformer import Deformer
    from facedeform_tpu_torch.ops import fit as fit_mod
    from facedeform_tpu_torch.utils.errors import (
        FaceDeformError, SolveFailedError,
    )

    n = rest_rig_pts.shape[0]
    if cfg.solver == "pu" or fit_mod.uses_krylov(cfg, n):
        out.append(Finding(
            "info", "solve-probe-skipped",
            f"solve probe skipped ({n} markers route through "
            f"{'PU' if cfg.solver == 'pu' else 'Krylov'}; the fit itself "
            "runs its health check)",
        ))
        return
    try:
        d = Deformer.fit(rest_rig_pts, posed_pts, cfg, params,
                         confidence=confidence, device=device)
    except SolveFailedError as e:
        out.append(Finding(
            "error", "solve-failed",
            f"test solve FAILED: {e}",
        ))
        return
    except FaceDeformError as e:
        out.append(Finding("error", "solve-invalid", str(e)))
        return
    rep = d.report
    # THE backward-error definition lives on SolveReport (handles a
    # missing scale_norm); re-deriving it here let the criterion drift
    backward = float(rep.backward_error())
    stats["solve_backward_error"] = backward
    cond = getattr(rep, "cond_est", None)
    if cond is not None:
        c = float(cond)
        stats["solve_cond_indicator"] = c
        if np.isfinite(c) and c > 1e7:
            out.append(Finding(
                "warning", "ill-conditioned",
                f"solve succeeds but the LU growth indicator is {c:.1e} "
                "— expect f32 noise in the weights; a ridge (lambda) or "
                "merging close markers improves it",
            ))
    out.append(Finding(
        "info", "solve-ok",
        f"test solve ok: backward error {backward:.2e}",
    ))


def _symmetry_scan(rest_rig_pts, posed_pts, out, stats) -> None:
    from facedeform_tpu_torch.ops import symmetry as sym

    best = None
    for plane in ("x", "y", "z"):
        partner, on_plane, tol = sym.pair_markers(rest_rig_pts, plane)
        frac = float(((partner >= 0) | on_plane).mean())
        if best is None or frac > best[1]:
            best = (plane, frac, partner, on_plane, tol)
    plane, frac, partner, on_plane, _ = best
    stats["symmetry_plane"] = plane
    stats["symmetry_pairable_fraction"] = frac
    if frac < 0.8:
        return
    msg = (
        f"rig is {frac * 100:.0f}% mirror-symmetric about {plane}"
    )
    if posed_pts is not None:
        r_mat = sym.reflection_matrix(plane)
        d = np.asarray(posed_pts, np.float64) - rest_rig_pts
        ok = partner >= 0
        asym = np.linalg.norm(
            d[ok] - d[partner[ok]] @ r_mat.T, axis=1
        ).max(initial=0.0)
        stats["pose_asymmetry"] = float(asym)
        msg += f"; pose asymmetry up to {asym:.3g}"
    out.append(Finding(
        "info", "symmetric-rig",
        msg + " — --symmetrize " + plane +
        " makes the deformation exactly symmetric",
    ))


def _confidence_check(rest_rig, cfg, out, stats) -> Optional[np.ndarray]:
    conf = rest_rig.attr("confidence")
    if conf is None:
        return None
    c = np.asarray(conf, np.float32).reshape(-1)
    stats["confidence_min"] = float(c.min())
    stats["confidence_out_of_range"] = int(((c <= 0) | (c > 1)).sum())
    if c.shape[0] != rest_rig.num_points:
        out.append(Finding(
            "error", "confidence-shape",
            f"confidence attr has {c.shape[0]} entries for "
            f"{rest_rig.num_points} markers",
        ))
        return None
    if stats["confidence_out_of_range"]:
        out.append(Finding(
            "warning", "confidence-range",
            f"{stats['confidence_out_of_range']} confidence value(s) "
            "outside (0, 1] — they clip to [1e-3, 1] at fit time",
        ))
    if cfg.model == RBFModelType.QNN:
        out.append(Finding(
            "warning", "confidence-qnn",
            "rig carries a confidence attr but model=QNN interpolates "
            "exactly (lam=0): confidence is ignored on this family — "
            "use MULTILAYER or KERNEL to apply it",
        ))
        return None
    return c


def _temporal_scan(frame_stack, out, stats) -> None:
    from facedeform_tpu_torch.ops import temporal

    f_n = frame_stack.shape[0]
    window = min(7, f_n if f_n % 2 else f_n - 1)
    if window < 5:
        return
    sm = temporal.smooth_frames(frame_stack, window=window, order=2)
    jitter = float(np.sqrt(((frame_stack - sm) ** 2).mean()))
    motion = float(np.sqrt(
        ((sm[1:] - sm[:-1]) ** 2).mean()
    )) if f_n > 1 else 0.0
    stats["temporal_jitter_rms"] = jitter
    stats["temporal_motion_rms"] = motion
    if jitter > 0.2 * max(motion, 1e-30):
        out.append(Finding(
            "warning", "tracker-jitter",
            f"rig trajectories carry jitter rms {jitter:.3g} vs "
            f"frame-to-frame motion rms {motion:.3g} — the mesh will "
            f"shimmer; consider --temporal-smooth {window}",
        ))


def diagnose(
    mesh,
    rest_rig,
    posed_rigs: Sequence = (),
    cfg: DeformConfig = DeformConfig(),
    params: DeformParams = DeformParams(),
    group: Optional[str] = None,
    probe_solve: bool = True,
    device="cuda",
) -> DoctorReport:
    """Lint a (mesh, rest rig[, posed rigs...]) input set.

    Host-side except the capture's distances and the optional solve probe
    (one real fit at the given cfg/params, dense routes only), which run
    on `device`.  Returns every finding at once — the
    point is the overview, not fail-fast.
    """
    out: List[Finding] = []
    stats: dict = {}
    mesh_pts = np.asarray(mesh.points, np.float32)
    rig_pts = np.asarray(rest_rig.points, np.float32)
    stats["num_points"] = int(mesh_pts.shape[0])
    stats["num_markers"] = int(rig_pts.shape[0])
    for name, pts in (("mesh", mesh_pts), ("rest rig", rig_pts)):
        if pts.shape[0] == 0:
            out.append(Finding(
                "error", "empty-input", f"{name} has no points"
            ))
    if out:
        return DoctorReport(out, stats)

    ok = _finite_check("mesh", mesh_pts, out)
    ok &= _finite_check("rest rig", rig_pts, out)
    posed_stack = None
    counted = []
    for i, r in enumerate(posed_rigs):
        p = np.asarray(r.points, np.float32)
        if p.shape[0] != rig_pts.shape[0]:
            out.append(Finding(
                "error", "rig-count-mismatch",
                f"posed rig {i} has {p.shape[0]} markers, rest rig has "
                f"{rig_pts.shape[0]} (the reference errors here, "
                "SOP_FaceDeform.cpp:231-234)",
            ))
            ok = False
            continue
        ok &= _finite_check(f"posed rig {i}", p, out)
        counted.append(p)
    if counted:
        posed_stack = np.stack(counted)
    if not ok:
        return DoctorReport(out, stats)
    if rig_pts.shape[0] < 4:
        out.append(Finding(
            "warning", "tiny-rig",
            f"{rig_pts.shape[0]} markers can't span a LINEAR polynomial "
            "tail; expect a degenerate or trivial fit",
        ))

    group_mask = None
    if group is not None:
        try:
            group_mask = mesh.select_points(group)
        except (KeyError, ValueError) as e:
            out.append(Finding("error", "bad-group", str(e)))
            return DoctorReport(out, stats)
        stats["group_fraction"] = float(group_mask.mean())
        if not group_mask.any():
            out.append(Finding(
                "error", "empty-group",
                f"group {group!r} selects no points",
            ))
            return DoctorReport(out, stats)

    _scale_overlap(mesh_pts, rig_pts, out, stats)
    _marker_spacing(rig_pts, params, out, stats)
    _capture_coverage(mesh, rest_rig, cfg, params, group_mask, out, stats, device)

    cls = rest_rig.attr("class")
    if cls is not None:
        ids, counts = np.unique(np.asarray(cls).astype(np.int64),
                                return_counts=True)
        stats["capture_classes"] = int(ids.shape[0])
        lonely = int((counts == 1).sum())
        if lonely:
            out.append(Finding(
                "info", "singleton-class",
                f"{lonely} capture class(es) contain a single marker — "
                "each floods its own island from one seed vertex",
            ))

    confidence = _confidence_check(rest_rig, cfg, out, stats)
    first_pose = posed_stack[0] if posed_stack is not None else None
    if rig_pts.shape[0] >= 4:
        _symmetry_scan(rig_pts, first_pose, out, stats)

    if posed_stack is not None and posed_stack.shape[0] >= 5:
        _temporal_scan(posed_stack, out, stats)

    if probe_solve and first_pose is not None:
        _solve_probe(rig_pts, first_pose, cfg, params, confidence, out,
                     stats, device)

    return DoctorReport(out, stats)
