"""FaceDeformNode: the cook orchestrator (port of facedeform_tpu/node.py).

The reference's single public entry point is SOP_FaceDeform::cookMySop
(src/SOP_FaceDeform.cpp:216-489): lock inputs, validate, build RBF data,
drive capture -> RBF solve -> per-vertex eval -> morph-space pass, with
data-id change tracking so capture/DBSE only re-run when their inputs
actually changed (InputGeoID, src/SOP_FaceDeform.hpp:47-64).

Input contract (reference :38-46, :228-234):

    inputs[0] = mesh (rest pose)          -- deformed copy is the output
    inputs[1] = rest control rig
    inputs[2] = deformed control rig      -- counts of 1 and 2 must match
    inputs[3:] = blendshapes              -- must match input0 point count,
                                             else skipped with a warning

Produced attributes (reference :179-185, :401, :425, :438, :474-480):
    P (deformed points), `fd_falloff` float, `Cd` color viz, `rest` float3,
    `weights` detail float array.

Cache improvements over the reference (documented deviations):
  * capture is also keyed on radius/maxedges/falloff params (the FIXME at
    src/SOP_FaceDeform.cpp:310-312, SURVEY.md quirk 4);
  * the RBF solve is cached on (rig data ids, params) instead of being
    re-run every cook (:330-368 always rebuilds), and a pose-only change
    re-solves through the route's cached plan (deformer.fit_route: the
    dense route's FitPlan at O(n^2)).

The cook runs on one device: FaceDeformNode(device=...) ("cuda" by
default), or the device of a deformer passed to cook(deformer=...).
Positions stay on the device from the eval through the morph and PSD
passes; the output mesh takes one (V, 3) host copy at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from facedeform_tpu_torch.capture.capture import CaptureResult, ProximityCapture
from facedeform_tpu_torch.config import DeformConfig, DeformParams
from facedeform_tpu_torch.deformer import Deformer, fit_params_key, fit_route
from facedeform_tpu_torch.geometry.mesh import Mesh
from facedeform_tpu_torch.ops import dbse as dbse_ops
from facedeform_tpu_torch.utils import errors, profiling
from facedeform_tpu_torch.utils.profiling import StageTimes, host_f32, stage

profiling.count("eval.autotune_runs", 0)
profiling.count("eval.autotune_hits", 0)


def _no_mesh_devices(mesh_devices) -> None:
    if mesh_devices is not None:
        raise NotImplementedError(
            "cook(mesh_devices=...) shards the eval and morph passes across "
            "devices: multi-GPU is slice H of the port (parallel/), not ported yet"
        )


@dataclasses.dataclass
class CookResult:
    """Everything a cook produces (the reference's output detail + node UI
    messages)."""

    mesh: Mesh                       # deformed copy of input 0
    warnings: List[str]
    messages: List[str]
    capture: Optional[CaptureResult]
    weights: Optional[np.ndarray]    # DBSE per-shape weights (detail attr)
    #: point attrs this cook rewrote beyond P/fd_falloff/Cd/rest
    #: (update_normals / transform_attrs / output_stretch outputs), so host
    #: adapters can write back only what changed
    transported: tuple = ()
    #: deformed copies of cook(secondary=...) accessory meshes, in order,
    #: driven by the same solved field, full displacement (no capture gate)
    secondary: tuple = ()


def _all_params_key(params: DeformParams) -> tuple:
    """Every param as a plain float."""
    return tuple(float(v) for v in params[:-1]) + (int(params.maxedges),)


class FaceDeformNode:
    """Stateful node: holds caches across cooks like the SOP instance holds
    m_mesh_capture / m_direct_blends / m_input_tracker
    (src/SOP_FaceDeform.hpp:110-113)."""

    def __init__(self, device="cuda") -> None:
        self.device = torch.device(device)
        self._capture = ProximityCapture(device=self.device)
        self._capture_key: Optional[tuple] = None
        self._capture_result: Optional[CaptureResult] = None
        self._dbse_key: Optional[tuple] = None
        self._dbse_model: Optional[dbse_ops.DBSEModel] = None
        self._fit_key: Optional[tuple] = None
        self._deformer: Optional[Deformer] = None
        # The fit route's pose-independent plan (deformer.fit_route), keyed
        # on everything in the fit key EXCEPT the deformed rig: a marker
        # drag (new pose, same rest rig/params) re-solves through
        # plan.refit(), which keeps what the route can keep (the dense
        # factorization; the PU patches, their factorizations and eval
        # plans); None where every pose is a cold fit.
        self._plan = None
        self._plan_key: Optional[tuple] = None
        self._rest_key: Optional[int] = None
        self._rest_attr: Optional[np.ndarray] = None
        # Autotuned eval backend (dense vs culled kernel), keyed on (mesh
        # pos id, pose-free fit key): culling efficacy depends on the rig's
        # locality and the mesh's vertex-order coherence, which no static
        # rule captures; both are measured once per mesh and rest rig and
        # kept across poses, since a refit changes only the weights and
        # both kernels' cost follows the rest rig's centers and cutoffs.
        self._backend_key: Optional[tuple] = None
        self._backend_choice: str = "auto"
        #: the autotune's last measurement, {backend: best ms}, and the
        #: backend the last cook's eval took
        self.backend_timings: Dict[str, float] = {}
        self.last_backend: Optional[str] = None
        self._sym_key: Optional[tuple] = None
        self._sym_rigs: Optional[tuple] = None
        # Pose-space deformation (ops/psd.py): the fitted correction model
        # and a child node that cooks the example poses through the SAME
        # pipeline (its FitPlan makes the K base cooks one factorization
        # and K pose refits).
        self._psd_key: Optional[tuple] = None
        self._psd_deformer = None
        self._psd_node: Optional["FaceDeformNode"] = None
        # the last cook's validated EXTERNAL (checkpoint-loaded) PSD
        self._psd_ext = None
        # pins the parent-cook external deformer captured in _psd_key (its
        # id() is part of the key and must not be recycled)
        self._psd_parent_deformer_pin = None
        # 1-ring neighbor table + LSQ gradient plan for the morph/PSD
        # transport gradient (ops/jacobian.field_gradient_plan), cached on
        # mesh topology / (topology, rest positions)
        self._nbr_key: Optional[tuple] = None
        self._nbr_table = None
        self._grad_plan_key: Optional[tuple] = None
        self._grad_plan = None
        # device copies of host inputs, {name: (key, tensor)}: the mesh
        # positions and capture distances cross to the device once per
        # data id, not once per cook
        self._dev_inputs: dict = {}

    def _on_device(self, name: str, key, array, dev, dtype=torch.float32):
        hit = self._dev_inputs.get(name)
        if hit is not None and hit[0] == (key, dev):
            return hit[1]
        t = profiling.to_device(np.ascontiguousarray(array), dev, dtype)
        self._dev_inputs[name] = ((key, dev), t)
        return t

    # ---------------------------------------------------------- symmetrize
    def _symmetrized_rigs(self, rest_rig, deform_rig, plane, tol):
        """Symmetrized (rest, deform) rig Meshes + report, cached on the
        input data ids so unchanged inputs keep stable Mesh objects (and
        therefore warm capture/solve caches downstream)."""
        from facedeform_tpu_torch.ops import symmetry as sym_ops

        def _plane_key(p):
            if isinstance(p, str):
                return p.lower()
            p = tuple(p)
            if len(p) == 2 and np.shape(p[0]) == (3,):
                return (tuple(float(x) for x in p[0]),
                        tuple(float(x) for x in p[1]))
            return tuple(float(x) for x in p)

        key = (
            rest_rig.pos_id, deform_rig.pos_id, rest_rig.attr_id,
            _plane_key(plane), None if tol is None else float(tol),
        )
        if key != self._sym_key:
            classes = rest_rig.attr("class")
            confidence = rest_rig.attr("confidence")
            r2, d2, cls2, conf2, report = sym_ops.symmetrize_rig_full(
                rest_rig.points, deform_rig.points, plane,
                tol=tol, classes=classes, confidence=confidence,
            )
            rest_m, dfm_m = Mesh(points=r2), Mesh(points=d2)
            if cls2 is not None:
                rest_m.set_attr("class", cls2)
            if conf2 is not None:
                # the solve stage reads `confidence` off THIS mesh: dropping
                # it would disable the weighted ridge whenever symmetrize is on
                rest_m.set_attr("confidence", conf2)
            self._sym_rigs = (rest_m, dfm_m, report)
            self._sym_key = key
        return self._sym_rigs

    # ------------------------------------------------------------------ psd
    def _psd_fit(
        self, inputs, examples, cfg, params, group_mask, dev,
        symmetrize, symmetry_tol, psd_lam, psd_eps, psd_normalize,
        psd_align, warnings, times, deformer=None,
    ):
        """Fit (or reuse) the pose-space correction model for `examples`.

        Each example pose is cooked through a CHILD FaceDeformNode with this
        cook's exact configuration, so the stored corrections are
        sculpt-minus-this-pipeline: whatever capture/tangent/morph do at
        that pose is absorbed.  The child's caches make the K base cooks
        one capture, one FitPlan factorization and K pose refits.  Returns
        a PSDDeformer or None (invalid or unsolvable examples degrade to a
        warning, the blendshape-mismatch convention,
        src/SOP_FaceDeform.cpp:201-204).
        """
        from facedeform_tpu_torch.ops import psd as psd_ops

        mesh_in, rest_rig = inputs[0], inputs[1]
        blends = list(inputs[3:])
        valid = []
        skipped = 0
        for posed, sculpt in examples:
            if (
                posed.num_points != rest_rig.num_points
                or sculpt.num_points != mesh_in.num_points
            ):
                skipped += 1
                continue
            valid.append((posed, sculpt))
        if skipped:
            warnings.append(
                f"psd: {skipped} example(s) don't match the rig/mesh "
                "point counts. Ignoring them."
            )
        if not valid:
            warnings.append("psd: no usable examples. Ignoring pose-space "
                            "deformation.")
            return None

        if symmetrize is None:
            sym_key = None
        elif isinstance(symmetrize, str):
            sym_key = (symmetrize.lower(),
                       None if symmetry_tol is None else float(symmetry_tol))
        else:
            sym_key = (repr(np.asarray(symmetrize, np.float64).tolist()),
                       None if symmetry_tol is None else float(symmetry_tol))
        mask_key = (
            None if group_mask is None
            else hash(np.asarray(group_mask, bool).tobytes())
        )
        key = (
            mesh_in.pos_id, mesh_in.top_id,
            rest_rig.pos_id, rest_rig.attr_id,
            tuple((p.pos_id, s.pos_id) for p, s in valid),
            tuple(b.pos_id for b in blends) if cfg.morphspace else (),
            cfg, _all_params_key(params), mask_key, sym_key,
            # an external deformer changes what the child cooks evaluate,
            # so it is part of the corrections' identity (pinned below so
            # its id() cannot be recycled while the cache entry lives)
            None if deformer is None else id(deformer),
            float(psd_lam),
            None if psd_eps is None else float(psd_eps),
            bool(psd_normalize), bool(psd_align), str(dev),
        )
        if key == self._psd_key:
            return self._psd_deformer

        with stage("psd_fit", times):
            if self._psd_node is None or self._psd_node.device != dev:
                self._psd_node = FaceDeformNode(device=dev)
            feats, corr = [], []
            max_off_group = 0.0
            for posed, sculpt in valid:
                base = self._psd_node.cook(
                    [mesh_in, rest_rig, posed] + blends, cfg, params,
                    group_mask=group_mask,
                    symmetrize=symmetrize, symmetry_tol=symmetry_tol,
                    # the parent's external field, if any: the corrections
                    # must be measured against the SAME field they will be
                    # applied on, or the example sculpt is not reproduced
                    deformer=deformer,
                )
                c = (sculpt.points.astype(np.float32)
                     - base.mesh.points.astype(np.float32))
                if group_mask is not None:
                    # The group contract (src/SOP_FaceDeform.cpp:485) caps
                    # writes to the group; a sculpt editing off-group
                    # vertices cannot be reproduced: zero it and report.
                    mask = np.asarray(group_mask, bool)
                    if (~mask).any():
                        max_off_group = max(
                            max_off_group, float(np.abs(c[~mask]).max())
                        )
                    c = np.where(mask[:, None], c, np.float32(0.0))
                f, r = psd_ops.pose_feature(
                    rest_rig.points, posed.points, bool(psd_align)
                )
                # align: the stored correction lives in the rest
                # (head-local) frame; the apply pass rotates it back by
                # the QUERY pose's own rigid rotation (ops/psd.py)
                corr.append(c @ r if r is not None else c)
                feats.append(f)
            if max_off_group > 1e-6:
                warnings.append(
                    f"psd: sculpt(s) move off-group vertices by up to "
                    f"{max_off_group:.3g}; those edits are outside the "
                    "group and were dropped."
                )
            try:
                model, report = psd_ops.fit_psd(
                    np.stack(feats), np.stack(corr),
                    eps=psd_eps, lam=float(psd_lam), device=dev,
                )
                errors.check_solve(report)
            except (ValueError, errors.SolveFailedError) as e:
                # not cached: a failing fit is cheap to re-derive and the
                # warning must re-emit on every cook that ignores examples
                warnings.append(
                    f"psd: {e} — ignoring pose-space deformation."
                )
                self._psd_key, self._psd_deformer = None, None
                return None
            psd = psd_ops.PSDDeformer(
                model, normalize=bool(psd_normalize), report=report,
                align=bool(psd_align),
            )
        self._psd_key, self._psd_deformer = key, psd
        self._psd_parent_deformer_pin = deformer
        return psd

    def _transport_neighbors(self, mesh: Mesh, dev):
        """Self-padded 1-ring table for ops/jacobian.mesh_field_gradient,
        cached on mesh topology: one device upload per topology."""
        key = (mesh.top_id, str(dev))
        if self._nbr_key != key:
            from facedeform_tpu_torch.geometry.topology import padded_neighbors, unique_edges
            from facedeform_tpu_torch.ops.jacobian import TRANSPORT_MAX_DEGREE

            nbr, _ = padded_neighbors(
                mesh.num_points, unique_edges(mesh.faces),
                max_degree=TRANSPORT_MAX_DEGREE,
            )
            self._nbr_table = profiling.to_device(nbr, dev, torch.int64)
            self._nbr_key = key
        return self._nbr_table

    def _transport_grad_plan(self, mesh: Mesh, dev):
        """(nbr, coeff) for ops/jacobian.apply_field_gradient, cached on
        (top_id, pos_id): the geometry half of the LSQ gradient (edge
        gather, Gram, Cholesky) runs once per rest mesh, so each morph/PSD
        cook pays only the one-gather apply."""
        key = (mesh.top_id, mesh.pos_id, str(dev))
        if self._grad_plan_key != key:
            from facedeform_tpu_torch.ops.jacobian import field_gradient_plan

            nbr = self._transport_neighbors(mesh, dev)
            self._grad_plan = field_gradient_plan(
                profiling.to_device(mesh.points, dev, torch.float32), nbr
            )
            self._grad_plan_key = key
        return self._nbr_table, self._grad_plan

    # -------------------------------------------------------------- backend
    def _choose_backend(self, mesh_in: Mesh, deformer, points, dist2, frame,
                        group_mask, tune_key) -> str:
        """Autotune the dense vs the culled eval kernel, cached on (pos_id,
        tune_key): culling wins on localized rigs and loses on spatially
        incoherent vertex orders, so a one-time measurement of both is the
        only rule that is right on every mesh.  tune_key is the cook's fit
        key without the pose (a checkpoint's whole key on an external
        cook): the choice is kept across the poses of one rest rig, as
        both kernels evaluate against the rest rig's centers with the same
        cutoffs and a refit replaces only the weights, which do not change
        what either kernel costs.  Each candidate takes a warm-up launch
        and then the best of 2, timed by CUDA events.  The deformer names
        the candidates (autotune_backends); a single one is taken
        untimed."""
        cands = deformer.autotune_backends(mesh_in.num_points)
        if len(cands) == 1:
            return cands[0]
        key = (mesh_in.pos_id, tune_key)
        if key == self._backend_key:
            profiling.count("eval.autotune_hits")
        else:
            timings = {}
            profiling.count("eval.autotune_runs")
            with profiling.span("eval.autotune"):
                for cand in cands:
                    def run():
                        return deformer.apply(points, dist2=dist2, frame=frame,
                                              group_mask=group_mask, backend=cand)

                    run()  # warm-up: first launch, lazy build
                    best = float("inf")
                    for _ in range(2):
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                        run()
                        end.record()
                        with profiling.blocking(deformer.device):
                            end.synchronize()
                        best = min(best, start.elapsed_time(end))
                    timings[cand] = best
            self.backend_timings = timings
            self._backend_choice = min(timings, key=timings.get)
            self._backend_key = key
        return self._backend_choice

    def dbse_state(self):
        """(dbse_model, rest_attr) cached by the last cook, or (None, None).

        A shot's batch path morphs frames 1+ in one dispatch; reusing the
        cook-cached blend basis guarantees it sees exactly the filtered
        shapes / rest attr / packed factor of frame 0's full cook (the
        setupBlends cache, src/SOP_FaceDeform.cpp:178-213).
        """
        return self._dbse_model, self._rest_attr

    def psd_state(self):
        """(PSDDeformer, its corrections (K, V, 3) on the node's device)
        cached by the last cook's examples= fit (or its validated psd=
        model), or (None, None).  A shot's batch path applies the
        pose-space correction to frames 1+ itself; reusing the cook-cached
        fit guarantees those frames see exactly the corrections frame 0's
        cook derived."""
        psd = self._psd_deformer if self._psd_deformer is not None else self._psd_ext
        if psd is None:
            return None, None
        return psd, psd.model.corrections

    # ------------------------------------------------------------------ cook
    @profiling.traced("FaceDeformNode.cook")
    def cook(
        self,
        inputs: Sequence[Mesh],
        cfg: DeformConfig = DeformConfig(),
        params: DeformParams = DeformParams(),
        group_mask: Optional[np.ndarray] = None,
        group: Optional[str] = None,
        times: Optional[StageTimes] = None,
        mesh_devices=None,
        picked: bool = False,
        deformer=None,
        update_normals: bool = False,
        transform_attrs: Optional[Sequence[str]] = None,
        output_stretch: bool = False,
        recompute_normals: bool = False,
        symmetrize=None,
        symmetry_tol: Optional[float] = None,
        examples: Optional[Sequence] = None,
        psd_lam: float = 0.0,
        psd_eps: Optional[float] = None,
        psd_normalize: bool = False,
        psd_align: bool = False,
        psd=None,
        secondary: Optional[Sequence[Mesh]] = None,
    ) -> CookResult:
        """Run one cook; mirrors cookMySop's flow (src/SOP_FaceDeform.cpp:216-489).

        Raises ShapeMismatchError / CaptureError / SolveFailedError for the
        conditions the reference reports as node errors; non-fatal
        conditions are collected as warnings.  Pass a StageTimes to collect
        per-stage wall times (each stage fenced on the device).
        mesh_devices (vertex sharding across devices) raises
        NotImplementedError: multi-GPU is slice H of the port.

        `deformer` (a solved deformer: deformer.Deformer or the PU route's
        facade) skips the RBF solve stage and cooks with the precomputed
        model on its device.
        Solve-relevant cfg fields come from the deformer's own fit; THIS
        cook's cfg supplies only the eval-side toggles (tangent/morphspace/
        dofalloff/doclampweight/strict_parity/dbse_lstsq).

        `update_normals` transports N by the cofactor rule;
        `transform_attrs` names further point attributes to push through
        the same deformation gradient ((V, 3) as vectors v' = F v, (V, 4)
        as orientation quaternions rotated by the polar factor of F); both
        share ONE Jacobian pass (the Jacobian kernel on the card).
        `output_stretch` writes fd_stretch / fd_compress (max / min
        singular value of F per vertex).  `recompute_normals` rebuilds N
        from the final output's faces (area-weighted); when both it and
        update_normals are set the recompute wins and the analytic N
        transport is skipped.  `symmetrize` ('x'/'y'/'z', a (3,) normal or
        a (normal, origin) pair) closes the rig under the mirror reflection
        before capture/fit (ops/symmetry.py); `symmetry_tol` overrides the
        marker-pairing tolerance.

        `examples` enables pose-space deformation (ops/psd.py): (posed_rig,
        sculpt) Mesh pairs.  Each example pose cooks through this same
        pipeline, the sculpt-minus-base corrections are interpolated in
        pose space and added AFTER the morph pass, so an example pose
        reproduces its sculpt.  `psd_lam` / `psd_eps` / `psd_normalize` /
        `psd_align` tune the pose-space fit; weights land in
        mesh.detail_attrs['psd_weights'].  `psd` applies an already-fitted
        PSDDeformer instead (`examples` wins when both are given).

        `secondary` accessory meshes ride the same solved field, fully
        (no capture gate, group, morph or PSD), with cfg.tangent where they
        carry a frame and recompute_normals from their faces; their
        deformed copies land on CookResult.secondary in order.
        """
        _no_mesh_devices(mesh_devices)
        if len(inputs) < 3:
            raise errors.ShapeMismatchError(
                "need at least 3 inputs: mesh, rest rig, deformed rig"
            )
        if group is not None:
            # point-group restriction (the reference's `group` parameter,
            # src/SOP_FaceDeform.cpp:119-120, applied :485), Houdini pattern
            # syntax (cookInputGroups grammar, :156-173)
            if group_mask is not None:
                raise ValueError("pass either group or group_mask, not both")
            group_mask = inputs[0].select_points(group)
        warnings: List[str] = []
        messages: List[str] = []
        mesh_in, rest_rig, deform_rig = inputs[0], inputs[1], inputs[2]
        blends = list(inputs[3:])
        dev = deformer.device if deformer is not None else self.device

        # validation (:228-234)
        if rest_rig.num_points != deform_rig.num_points:
            raise errors.ShapeMismatchError(
                "Rest and deform geometry should match."
            )

        # ------------------------------------------------------- symmetrize
        if symmetrize is not None:
            # close the rig under the mirror reflection BEFORE capture/fit,
            # cached on the input data ids so downstream caches stay warm
            # (beyond the reference, which packs the rig verbatim,
            # src/SOP_FaceDeform.cpp:268-287)
            rest_rig, deform_rig, sym_report = self._symmetrized_rigs(
                rest_rig, deform_rig, symmetrize, symmetry_tol
            )
            messages.append(
                f"symmetrize: {sym_report.n_paired} paired, "
                f"{sym_report.n_on_plane} on-plane, "
                f"{sym_report.n_appended} mirrored in; removed asymmetry "
                f"{sym_report.max_asymmetry:.3g} (pair tol "
                f"{sym_report.tol:.3g})"
            )
            if sym_report.n_skipped:
                warnings.append(
                    f"symmetrize: {sym_report.n_skipped} marker(s) not "
                    "mirrored in (the mirror would land within tol of an "
                    "existing marker — near-duplicate control point); the "
                    "deformation is not exactly symmetric around them."
                )

        # duplicatePointSource(0) (:226)
        with stage("copy", times):
            out = mesh_in.copy()
        maxedges = max(int(params.maxedges), 1)
        radius = max(float(params.radius), 0.01)

        # ---------------------------------------------------------- capture
        cap_key = (
            mesh_in.pos_id, mesh_in.top_id, rest_rig.pos_id, rest_rig.top_id,
            rest_rig.attr_id,  # capture groups islands by the rig `class` attr
            maxedges, radius, bool(cfg.dofalloff), float(params.falloffrate),
            bool(cfg.strict_parity), cfg.falloff_metric,
        )
        if cap_key != self._capture_key:
            with stage("capture", times):
                self._capture.device = dev
                self._capture.init(out, rest_rig)
                self._capture_result = self._capture.capture(
                    maxedges, radius, cfg.dofalloff, float(params.falloffrate),
                    strict_parity=cfg.strict_parity,
                    metric=cfg.falloff_metric,
                )
            self._capture_key = cap_key
        capture = self._capture_result

        # -------------------------------------------- rest attr + DBSE setup
        dbse_model = None
        valid_blends: List[Mesh] = []
        if cfg.morphspace and blends:
            # store/refresh `rest` when the rest pose changed (setupBlends,
            # :178-185)
            if self._rest_key != mesh_in.pos_id or self._rest_attr is None:
                self._rest_attr = mesh_in.points.copy()
                self._rest_key = mesh_in.pos_id
            out.set_attr("rest", self._rest_attr)
            for b in blends:
                if b.num_points != mesh_in.num_points:
                    warnings.append(
                        "Some blendshapes don't match rest pose point count. "
                        "Ignoring them."
                    )
                    continue
                valid_blends.append(b)
            if valid_blends:
                dbse_key = (
                    mesh_in.pos_id,
                    tuple(b.pos_id for b in valid_blends),
                    not cfg.dbse_lstsq, str(dev),
                )
                if dbse_key != self._dbse_key:
                    with stage("dbse_build", times):
                        self._dbse_model = dbse_ops.build_model(
                            self._rest_attr,
                            [b.points for b in valid_blends],
                            parity=not cfg.dbse_lstsq, device=dev,
                        )
                    self._dbse_key = dbse_key
                dbse_model = self._dbse_model
            else:
                warnings.append(
                    "Can't proceed with morph space deformation. Ignoring it."
                )
        elif cfg.morphspace:
            warnings.append("No blendshapes found. Ignoring morphspace deformation.")

        # -------------------------------------------------------- RBF solve
        # Keyed on cfg.solve_view(), not the full cfg: toggling eval-only
        # flags (tangent, morphspace, dofalloff, ...) must not re-solve.
        # The EXTERNAL deformer argument is kept before the local is
        # rebound below: the PSD pass must see the caller's deformer (None
        # on ordinary cooks), not a per-cook fit whose id() would bust the
        # PSD cache.
        ext_deformer = deformer
        if deformer is not None:
            # precomputed-solve cook: the deformer's solve fields with this
            # cook's eval toggles; the solve stage is skipped
            cfg = dataclasses.replace(
                deformer.cfg,
                tangent=cfg.tangent, morphspace=cfg.morphspace,
                dofalloff=cfg.dofalloff, doclampweight=cfg.doclampweight,
                strict_parity=cfg.strict_parity, dbse_lstsq=cfg.dbse_lstsq,
            )
            model = getattr(deformer, "model", None)
            if (
                model is not None
                and int(model.ctrl.shape[-2]) != rest_rig.num_points
                # reduced-basis regressions (decimate.fit_reduced) choose
                # K < N centers on purpose: not a stale checkpoint
                and not getattr(deformer, "reduced", False)
            ):
                warnings.append(
                    f"precomputed deformer was fitted on "
                    f"{int(model.ctrl.shape[-2])} control points but the "
                    f"rest rig has {rest_rig.num_points}; capture islands "
                    "follow the rig, the deformation follows the checkpoint"
                )
            self._deformer = dataclasses.replace(deformer, cfg=cfg, params=params)
            self._fit_key = (
                "external", id(deformer), cfg.solve_view(),
                _all_params_key(params),
            )
            fit_key = self._fit_key
        else:
            # Per-marker confidence (rest-rig `confidence` point attr):
            # consumed by the ridge families' fits; warn-and-ignore for QNN.
            confidence = rest_rig.attr("confidence")
            if confidence is not None:
                from facedeform_tpu_torch.config import RBFModelType

                if cfg.model == RBFModelType.QNN:
                    # the PU route too: QNN keeps lam = 0 there
                    # (node_fit_kwargs), so lam / c would still be 0
                    warnings.append(
                        "confidence attr needs a ridge family (MULTILAYER "
                        "or KERNEL); QNN interpolates exactly — ignoring "
                        "it."
                    )
                    confidence = None
            fit_key = (
                rest_rig.pos_id, deform_rig.pos_id, cfg.solve_view(),
                # the params the route solves with: slider changes of any
                # other param must not re-run the fit
                fit_params_key(cfg, params),
                # confidence edits bump the rig's attr id -> refit; rigs
                # without the attr keep a constant key term
                rest_rig.attr_id if confidence is not None else None,
                str(dev),
            )
        # the fit key minus the deformed rig: a pose-only change (marker
        # drag, next tracked frame) keeps it, the route's plan re-solves
        # the pose and the eval autotune keeps its choice; an external
        # cook keeps its whole key, whose id(deformer) tells checkpoints
        # apart
        plan_key = fit_key if fit_key[0] == "external" else fit_key[:1] + fit_key[2:]
        if fit_key != self._fit_key:
            with stage("solve", times):
                if self._plan is not None and plan_key == self._plan_key:
                    # the plan's cfg/params carry fit-time eval toggles:
                    # refresh to this cook's
                    self._deformer = dataclasses.replace(
                        self._plan.refit(deform_rig.points), cfg=cfg, params=params)
                else:
                    self._deformer, self._plan = fit_route(
                        rest_rig.points, deform_rig.points, cfg, params,
                        confidence=confidence, device=dev,
                    )
                    self._plan_key = plan_key
            self._fit_key = fit_key
        elif (
            self._deformer.cfg != cfg
            or _all_params_key(self._deformer.params) != _all_params_key(params)
        ):
            # cache hit with changed eval-side knobs: reuse the solved
            # model, refresh the knobs the cached deformer holds
            self._deformer = dataclasses.replace(self._deformer, cfg=cfg, params=params)
        deformer = self._deformer
        rep = deformer.report
        # the report's scalars in ONE device -> host transfer
        with profiling.span("cook.report"):
            scalars = [rep.residual_norm, rep.rhs_norm]
            if rep.scale_norm is not None:
                scalars += [rep.backward_error(), rep.cond_est]
            vals = profiling.to_host(torch.stack([
                torch.full((), float("nan"), device=rep.residual_norm.device) if x is None
                else x.float().reshape(()) for x in scalars
            ])).numpy()
        if rep.scale_norm is not None:
            messages.append(
                f"Solve residual: {vals[0]:.3e} (rhs {vals[1]:.3e}, "
                f"backward error {vals[2]:.3e}, cond est {vals[3]:.2e})"
            )
        else:
            messages.append(f"Solve residual: {vals[0]:.3e} (rhs {vals[1]:.3e})")

        # ------------------------------------------------- tangent frame
        frame = None
        if cfg.tangent:
            if out.has_tangent_frame():
                frame = tuple(
                    self._on_device(f"frame {n}", mesh_in.attr_id, out.attr(n), dev)
                    for n in ("tangentu", "tangentv", "N"))
            else:
                # reference warning text (:295-297)
                warnings.append(
                    "Append PolyFrameSOP and enable tangent[u/v] and N "
                    "attribute to allow tangent displacement."
                )

        # ------------------------------------------------------- eval loop
        rest_pts = self._on_device("points", mesh_in.pos_id, mesh_in.points, dev)
        dist2 = None
        if capture is not None:
            dist2 = self._on_device("dist2", self._capture_key, capture.dist2, dev)
        mask_t = (None if group_mask is None
                  else profiling.to_device(np.asarray(group_mask, bool), dev))
        with stage("eval", times):
            backend = self._choose_backend(
                mesh_in, deformer, rest_pts, dist2, frame, mask_t, plan_key
            )
            with profiling.span("eval.apply"):
                # the point set keyed by the mesh positions' data id: the PU
                # route's eval plan needs no per-cook content hash of the
                # full point buffer, and a pose-only refit keeps it
                new_pts, falloff = deformer.apply(
                    rest_pts, dist2=dist2, frame=frame, group_mask=mask_t,
                    backend=backend, points_key=(mesh_in.pos_id, out.num_points),
                )
            with profiling.span("eval.falloff_copy"):
                falloff_host = host_f32(falloff)
        self.last_backend = backend
        out.set_attr("fd_falloff", falloff_host)

        if picked:
            # eval-pass falloff viz: the reference maps falloff onto an HSV
            # 200..250 hue when the node is selected ("picked",
            # src/SOP_FaceDeform.cpp:426-436, FIXME'd out there), white
            # otherwise
            from facedeform_tpu_torch.capture.capture import _hsv_to_rgb

            f = np.clip(falloff_host, 0.0, 1.0)
            out.set_attr("Cd", _hsv_to_rgb(200.0 + f * 50.0))
        elif capture is not None:
            out.set_attr("Cd", capture.color)

        # ------------------------------------------------------ morph pass
        weights_out = None
        rbf_pts = new_pts  # RBF-pass output, kept for the morph Jacobian
        if dbse_model is not None:
            with stage("morph", times, new_pts):
                rest_attr = self._on_device("rest attr", self._rest_key, self._rest_attr, dev)
                cur = new_pts
                if cfg.dbse_robust and not cfg.dbse_lstsq:
                    warnings.append(
                        "dbse_robust requires the least-squares weight path "
                        "(dbse_lstsq=True); ignoring it for the parity recipe."
                    )
                with profiling.span("morph.weights"):
                    if cfg.dbse_lstsq:
                        fn = (dbse_ops.weights_robust if cfg.dbse_robust
                              else dbse_ops.weights_lstsq)
                        w, w_report = fn(dbse_model, cur, rest_attr)
                        try:
                            errors.check_solve(w_report)
                            ok = True
                        except errors.SolveFailedError:
                            ok = False
                    else:
                        w = dbse_ops.weights_parity(dbse_model, cur, rest_attr)
                        ok = bool(profiling.to_host(torch.isfinite(w).all()))
                if not ok:
                    warnings.append(
                        "Can't compute weights for morphspace deformation. Ignoring it."
                    )
                else:
                    with profiling.span("morph.apply"):
                        morphed = dbse_ops.morph_apply(dbse_model, cur, rest_attr, w, cfg,
                                                       params)
                        if mask_t is not None:
                            # group contract: the blend reconstruction writes
                            # all V rows; off-group vertices keep the
                            # (already gated) eval output
                            morphed = torch.where(mask_t[:, None], morphed, new_pts)
                        new_pts = morphed
                        weights_out = host_f32(w)
                    out.detail_attrs["weights"] = weights_out

        # -------------------------------------------------------- psd pass
        psd_applied = False
        # pose-space sculpt corrections layered on top of the full pipeline
        # output; at an example pose the cook reproduces the sculpt
        if examples:
            psd = self._psd_fit(
                inputs, examples, cfg, params, group_mask, dev,
                symmetrize, symmetry_tol, psd_lam, psd_eps, psd_normalize,
                psd_align, warnings, times, deformer=ext_deformer,
            )
        elif psd is not None:
            # an already-fitted model: validate against THIS mesh/rig
            _, v_corr, _ = (int(s) for s in psd.model.corrections.shape)
            d_feat = int(psd.model.features.shape[1])
            # validate against the ORIGINAL inputs[1] rig: pose_feature
            # below reads inputs[1]/inputs[2], not the symmetrized rig
            # (whose appended mirrors would reject a valid model)
            n_rig_orig = inputs[1].num_points
            if v_corr != mesh_in.num_points or d_feat != 3 * n_rig_orig:
                warnings.append(
                    f"psd: checkpoint was fitted for {v_corr} mesh points / "
                    f"{d_feat // 3} rig markers; inputs have "
                    f"{mesh_in.num_points} / {n_rig_orig}. "
                    "Ignoring pose-space deformation."
                )
                psd = None
            else:
                self._psd_ext = psd
        if psd is not None:
            with stage("psd", times, new_pts):
                new_pts, w_psd = self._psd_apply(psd, inputs, new_pts, mask_t)
                psd_applied = True
            out.detail_attrs["psd_weights"] = w_psd
            messages.append(
                f"psd: {psd.model.features.shape[0]} example pose(s), "
                f"max |w| {float(np.abs(w_psd).max()):.3f}"
            )

        # ---------------------------------------------- attribute transport
        # Extension over the reference: cookMySop writes positions only
        # (src/SOP_FaceDeform.cpp:438), leaving rest-pose N/v/orient frames
        # on the deformed surface.  The field's closed-form Jacobian
        # transports them through the applied map (ops/jacobian.py): ONE
        # Jacobian pass shared by N and every requested attribute.
        from facedeform_tpu_torch.ops.jacobian import infer_attr_kind

        to_transport: Dict[str, np.ndarray] = {}
        transport_kinds: Dict[str, str] = {}
        # when the geometric recompute will run (faces present), it
        # overwrites any analytically transported N: skip that transport
        recompute_wins = bool(
            recompute_normals and out.faces is not None and len(out.faces)
        )
        if update_normals and recompute_wins:
            pass  # N comes from the geometric recompute below
        elif update_normals:
            if "N" not in out.point_attrs:
                warnings.append(
                    "update_normals: mesh has no N point attribute; skipping"
                )
            elif not hasattr(deformer, "transform_attrs"):
                warnings.append(
                    "update_normals: not available for this model family; "
                    "skipping"
                )
            else:
                to_transport["N"] = out.attr("N")
                transport_kinds["N"] = "normal"
        for name in transform_attrs or ():
            if name in to_transport:
                continue
            if name == "N" and recompute_wins:
                continue  # superseded by the geometric recompute
            vals = out.attr(name)
            if vals is None:
                warnings.append(
                    f"transform_attrs: mesh has no {name!r} point attribute;"
                    " skipping"
                )
                continue
            kind = infer_attr_kind(name, vals, out.attr_typeinfo.get(name))
            if kind is None:
                warnings.append(
                    f"transform_attrs: {name!r} has shape "
                    f"{tuple(vals.shape)} — only (V, 3) vectors/normals and"
                    " (V, 4) quaternions transport; skipping"
                )
                continue
            if not hasattr(deformer, "transform_attrs"):
                warnings.append(
                    "transform_attrs: not available for this model family; "
                    "skipping"
                )
                break
            to_transport[name] = vals
            transport_kinds[name] = kind
        # Whole-map composition: after the morph and/or PSD passes the
        # realized map is m(x) = x + d(x) + gamma (P(x) - x), P the RBF
        # pass, gamma the share of the analytic RBF Jacobian that survives
        # (the dofalloff-gated falloffradius residual after a morph,
        # ops/dbse.morph_pass; 1 when only PSD ran on the full RBF output),
        # d everything discrete layered on top (the effective blend
        # reconstruction plus the blended PSD correction).  Morph and PSD
        # weights are constants of the map, so F = I + grad(d) +
        # gamma (F_P - I): grad(d) from ONE 1-ring least-squares fit
        # (ops/jacobian.apply_field_gradient, exact on the tangent plane,
        # which is all the cofactor normal rule reads), F_P the deformer's
        # closed-form Jacobian.
        f_map = None
        if (weights_out is not None or psd_applied) and (
            update_normals or transform_attrs or output_stretch
        ):
            if out.faces is None or len(out.faces) == 0:
                warnings.append(
                    "morph/psd attribute transport needs mesh faces for "
                    "the discrete-displacement gradient; transported "
                    "attrs / stretch reflect the RBF pass only"
                )
            else:
                from facedeform_tpu_torch.ops.jacobian import apply_field_gradient

                if weights_out is None:
                    gamma = 1.0        # PSD on top of the full RBF pass
                else:
                    gamma = (
                        float(params.falloffradius)
                        if cfg.dofalloff and float(params.falloffradius) != 0.0
                        else 0.0
                    )
                with stage("transport_grad", times, rest_pts):
                    # keyed on the INPUT mesh: `out` is a copy with fresh
                    # data ids, so keying on it would rebuild every cook
                    nbr, grad_coeff = self._transport_grad_plan(mesh_in, dev)
                    d_field = new_pts - rest_pts - gamma * (rbf_pts - rest_pts)
                    g_blend = apply_field_gradient(d_field, nbr, grad_coeff)
                eye3 = torch.eye(3, dtype=torch.float32, device=dev)

                def f_map(f, _g=g_blend, _gm=gamma, _eye=eye3):
                    return _eye[None] + _g + _gm * (f - _eye[None])

        stretch_sig = None
        transported_names: List[str] = []
        if to_transport:
            with stage("normals", times):
                # query at the REST positions (where the map acted);
                # `falloff` is the per-vertex multiplier apply used (incl.
                # the group gate), treated locally constant
                if output_stretch:
                    # one Jacobian/F pass covers the attrs AND the stretch
                    moved, stretch_sig = deformer.transform_attrs(
                        rest_pts, to_transport, falloff, frame=frame,
                        kinds=transport_kinds, want_stretch=True, f_map=f_map,
                    )
                else:
                    moved = deformer.transform_attrs(
                        rest_pts, to_transport, falloff, frame=frame,
                        kinds=transport_kinds, f_map=f_map,
                    )
                for name, arr in moved.items():
                    out.set_attr(name, host_f32(arr))
                    transported_names.append(name)
        if output_stretch:
            if stretch_sig is None and not hasattr(deformer, "principal_stretches"):
                warnings.append(
                    "output_stretch: not available for this model family; "
                    "skipping"
                )
            else:
                with stage("stretch", times):
                    if stretch_sig is None:
                        stretch_sig = deformer.principal_stretches(
                            rest_pts, falloff, frame=frame, f_map=f_map,
                        )
                    sig = host_f32(stretch_sig)
                out.set_attr("fd_stretch", sig[:, 0])
                out.set_attr("fd_compress", sig[:, 2])
                transported_names += ["fd_stretch", "fd_compress"]
        with stage("output", times):
            out.set_points(host_f32(new_pts))   # the cook's one (V, 3) host copy
        # ------------------------------------------- geometric normals
        # on the FINAL positions (after the morph pass), so unlike the
        # analytic transport it reflects everything written
        if recompute_normals:
            if out.faces is None or len(out.faces) == 0:
                warnings.append(
                    "recompute_normals: mesh has no faces; skipping "
                    "(use update_normals for point clouds)"
                )
            else:
                from facedeform_tpu_torch.geometry.topology import vertex_normals

                with stage("normals_topo", times):
                    out.set_attr("N", vertex_normals(out))
                if "N" not in transported_names:
                    transported_names.append("N")

        # ------------------------------------------------ secondary meshes
        # Extension over the reference: accessory geometry rides the same
        # solved field in the same cook.  Full displacement everywhere
        # (dist2 zeros: reference quirk 1's no-capture semantics,
        # src/SOP_FaceDeform.cpp:404-410).
        sec_out: List[Mesh] = []
        if secondary:
            with stage("secondary", times):
                for sec in secondary:
                    s_out = sec.copy()
                    s_frame = None
                    if cfg.tangent and s_out.has_tangent_frame():
                        s_frame = (
                            s_out.attr("tangentu"),
                            s_out.attr("tangentv"),
                            s_out.attr("N"),
                        )
                    s_pts, s_w = deformer.apply(
                        s_out.points, frame=s_frame,
                        points_key=(sec.pos_id, s_out.num_points),
                    )
                    s_out.set_points(host_f32(s_pts))
                    s_out.set_attr("fd_falloff", host_f32(s_w))
                    if (recompute_normals and s_out.faces is not None
                            and len(s_out.faces)):
                        from facedeform_tpu_torch.geometry.topology import vertex_normals

                        s_out.set_attr("N", vertex_normals(s_out))
                    sec_out.append(s_out)

        return CookResult(
            mesh=out, warnings=warnings, messages=messages,
            capture=capture, weights=weights_out,
            transported=tuple(transported_names),
            secondary=tuple(sec_out),
        )

    def _psd_apply(self, psd, inputs, new_pts, mask_t):
        """(positions + the blended PSD correction, host weights (K,)).
        The (K) x (K, 3V) contraction runs on the device that holds the
        positions and the model's corrections; only the K weights cross
        to the host."""
        from facedeform_tpu_torch.ops import psd as psd_ops
        from facedeform_tpu_torch.utils.precision import highest_precision

        feat, r_q = psd_ops.pose_feature(inputs[1].points, inputs[2].points, psd.align)
        w_psd = host_f32(psd_ops.psd_weights(psd.model, feat, psd.kernel, psd.normalize))
        delta = psd_ops.psd_delta(psd.model, feat, psd.kernel, psd.normalize)
        delta = delta.to(new_pts.device)
        if r_q is not None:
            # rest-frame corrections ride the query pose's rigid rotation
            # back to world (rigid equivariance)
            with highest_precision():
                delta = delta @ profiling.to_device(r_q.T, new_pts.device)
        if mask_t is not None:
            # group contract (src/SOP_FaceDeform.cpp:485): a model fitted
            # without (or with another) group is gated here too
            delta = torch.where(mask_t[:, None], delta, torch.zeros_like(delta))
        return new_pts + delta, w_psd
