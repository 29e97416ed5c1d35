"""Deformer: the solve-once / eval-many user API (port of
facedeform_tpu/deformer.py).

The reference's eval loop, per mesh point: skip if the captured d2 exceeds
radius^2, disp = rbfcalc(P), optional tangent projection, falloff =
(1 - min(d2/r^2, 1))^rate, write fd_falloff and P += falloff * disp,
restricted to the optional point group.  apply_fn is that step as a
plain function; FitPlan is the pose-independent half of a dense fit (the
interactive marker drag: factor once, refit each pose in O(n^2)).

fit_route is the one seam between a caller that re-poses a rig (the
node) and the fit routes: a cold fit returns the deformer and the route's
pose-independent plan (a FitPlan, an ops.pu.PUFitPlan, or None where
every pose is a cold fit), and plan.refit(pose) re-solves a new pose.
fit_params_key says which params a route's solve reads.
"""

from __future__ import annotations

import dataclasses

import torch

from facedeform_tpu_torch.config import DeformConfig, DeformParams
from facedeform_tpu_torch.ops import cuda_eval, cuda_jacobian, cuda_precise
from facedeform_tpu_torch.ops import fit as fit_mod
from facedeform_tpu_torch.ops import jacobian as jac_mod
from facedeform_tpu_torch.ops.evaluate import evaluate
from facedeform_tpu_torch.ops.falloff import falloff_weight
from facedeform_tpu_torch.ops.fit import RBFModel
from facedeform_tpu_torch.ops.precise_eval import GROWING_KERNELS, evaluate_precise
from facedeform_tpu_torch.ops.solve import SolveReport
from facedeform_tpu_torch.ops.tangent import project_to_tangents
from facedeform_tpu_torch.utils import errors, profiling

_BACKENDS = ("dense", "dense_precise", "cuda", "cuda_culled", "cuda_precise")

# The culled kernel needs enough vertex blocks for coherent bboxes to pay
# for the slab tests (the JAX package's measured crossover).
_CULL_MIN_VERTS = 4096

#: the backends the node's autotune times where either kernel may win
#: (Deformer.autotune_backends)
AUTOTUNE_BACKENDS = ("cuda", "cuda_culled")


def _apply_plain(evaluate_fn, model, points, dist2, frame, group_mask, cfg, params):
    """The plain deform step with the displacement from evaluate_fn."""
    params = params.clamped()
    disp = evaluate_fn(model, points, fit_mod.effective_kernel(cfg), cfg.term)
    if cfg.tangent and frame is not None:
        disp = project_to_tangents(*frame, disp)
    w, active = falloff_weight(
        dist2, params.radius, params.falloffrate, strict_parity=cfg.strict_parity)
    if group_mask is not None:
        active = active & group_mask
    w = torch.where(active, w, torch.zeros_like(w))
    return points + disp * w[:, None], w


def apply_fn(model: RBFModel, points, dist2, frame, group_mask, cfg: DeformConfig,
             params: DeformParams) -> tuple[torch.Tensor, torch.Tensor]:
    """Pure deformation step on the model's device, the plain f32 field:
    (new_points (V, 3), fd_falloff (V,)).  frame (u, v, n) projects when
    cfg.tangent; group_mask (V,) bool restricts; either may be None."""
    points = profiling.to_device(points, model.device, torch.float32)
    dist2 = profiling.to_device(dist2, model.device, torch.float32)
    return _apply_plain(evaluate, model, points, dist2, frame, group_mask, cfg, params)


def fit_params_key(cfg: DeformConfig, params: DeformParams) -> tuple:
    """Only the params cfg's route solves with, as plain floats: eval-only
    knobs (the falloff rate, weight clamps) must not invalidate a cached
    solve.  The PU route reads lam alone (per-patch radii are automatic);
    the others read qcoef, zcoef, radius and lam, clamped to the cook-time
    floors, so sub-floor slider values (lam 0.001 vs 0.005, both floored
    to 0.01) do not refit a byte-identical model."""
    if cfg.solver == "pu":
        return (float(params.lam),)
    return (
        max(float(params.qcoef), 0.1), max(float(params.zcoef), 0.1),
        max(float(params.radius), 0.01), max(float(params.lam), 0.01),
    )


def fit_route(rest_ctrl, deformed_ctrl, cfg: DeformConfig, params: DeformParams,
              confidence=None, device="cuda"):
    """A cold fit on cfg's route: (deformer, plan), where plan.refit(pose)
    re-solves a new pose of the same rest rig, cfg and fit params, or plan
    is None where each pose is a cold fit.  Dense: Deformer.fit_with_plan
    (one factorization).  PU: an ops.pu.PUFitPlan (its patches, their
    factorizations and its eval plans kept across refits).  Krylov:
    Deformer.fit, no plan (matrix-free)."""
    if cfg.solver == "pu":
        from facedeform_tpu_torch.ops.pu import PUFitPlan

        plan = PUFitPlan(profiling.host_f32(rest_ctrl), cfg, params,
                         confidence=confidence, device=device)
        return plan.refit(deformed_ctrl), plan
    if FitPlan.supports(cfg, len(rest_ctrl)):
        return Deformer.fit_with_plan(rest_ctrl, deformed_ctrl, cfg, params,
                                      confidence=confidence, device=device)
    return Deformer.fit(rest_ctrl, deformed_ctrl, cfg, params,
                        confidence=confidence, device=device), None


def _fit_inputs(rest_ctrl, deformed_ctrl, confidence, device):
    """The rigs as f32 tensors on `device` and the clipped confidence;
    ShapeMismatchError on a rig count mismatch."""
    rest_ctrl = profiling.to_device(rest_ctrl, device, torch.float32)
    deformed_ctrl = profiling.to_device(deformed_ctrl, device, torch.float32)
    if rest_ctrl.shape != deformed_ctrl.shape:
        raise errors.ShapeMismatchError(
            f"rest and deform rigs must match: {tuple(rest_ctrl.shape)} vs "
            f"{tuple(deformed_ctrl.shape)}"
        )
    if confidence is not None:
        confidence = fit_mod.confidence_clipped(confidence, rest_ctrl.shape[0], device)
    return rest_ctrl, deformed_ctrl, confidence


@dataclasses.dataclass(frozen=True)
class Deformer:
    """A solved RBF deformation: model + config; eval-many across frames."""

    model: RBFModel
    cfg: DeformConfig
    params: DeformParams
    report: SolveReport
    # True for reduced-basis regression fits (ops/decimate.fit_reduced):
    # the model's ctrl are K selected centers of a larger rig, so a
    # deformer/rig control-count mismatch is intended there
    reduced: bool = False

    @classmethod
    def fit(
        cls,
        rest_ctrl,
        deformed_ctrl,
        cfg: DeformConfig = DeformConfig(),
        params: DeformParams = DeformParams(),
        check: bool = True,
        confidence=None,
        device="cuda",
    ) -> "Deformer":
        """Solve the RBF system mapping rest_ctrl -> deformed_ctrl on `device`.

        Up to 8192 controls (solver "auto" or "direct") the system is
        assembled and LU-solved; past it, or with solver="krylov", it is
        solved matrix-free (GMRES for QNN, PMINRES for MULTILAYER/KERNEL).
        `confidence` ((N,) per-marker quality in (0, 1]) weights the ridge
        per marker (ridge families only).  Raises ShapeMismatchError on a
        rig count mismatch and SolveFailedError on solver blow-up, at the
        backward-error threshold of the route taken.
        """
        if cfg.solver == "pu":
            # the PU model is a different artifact (patch tensors, not an
            # RBFModel); the dense route would not fit at the rig sizes PU
            # exists for
            raise ValueError(
                "solver='pu' is not a Deformer route — use "
                "ops.pu.PUDeformer.fit (or ops.pu.PUSeqDeformer.fit for a shot)"
            )
        rest_ctrl, deformed_ctrl, confidence = _fit_inputs(
            rest_ctrl, deformed_ctrl, confidence, device)
        model, report = fit_mod.fit(
            rest_ctrl, deformed_ctrl, cfg.solve_view(), params, confidence=confidence)
        if check:
            # the CPD-kernel Krylov route converges to the f32 Krylov noise
            # floor, not the refined-LU floor: match the route fit() took
            errors.check_solve(
                report,
                rtol=errors.KRYLOV_CPD_BACKWARD_RTOL
                if fit_mod.krylov_cpd(cfg, rest_ctrl.shape[0])
                else errors.SOLVE_BACKWARD_RTOL,
            )
        return cls(model=model, cfg=cfg, params=params, report=report)

    @classmethod
    def fit_with_plan(
        cls,
        rest_ctrl,
        deformed_ctrl,
        cfg: DeformConfig = DeformConfig(),
        params: DeformParams = DeformParams(),
        check: bool = True,
        confidence=None,
        device="cuda",
    ) -> tuple["Deformer", "FitPlan"]:
        """Deformer.fit that also returns the pose-independent FitPlan: its
        factors are the fit's own (no second factorization), and later
        poses of the same rest rig go through plan.refit() at O(n^2).
        Dense route only: gate with FitPlan.supports(cfg, n)."""
        if not FitPlan.supports(cfg, len(rest_ctrl)):
            raise ValueError(
                "fit_with_plan needs the dense route (plans cache the dense "
                "factorization): this cfg/rig routes through "
                f"{'PU' if cfg.solver == 'pu' else 'Krylov'} - gate with "
                "FitPlan.supports(cfg, n)"
            )
        rest_ctrl, deformed_ctrl, confidence = _fit_inputs(
            rest_ctrl, deformed_ctrl, confidence, device)
        model, report, factors = fit_mod.fit_with_factors(
            rest_ctrl, deformed_ctrl, cfg.solve_view(), params, confidence=confidence)
        if check:
            errors.check_solve(report, rtol=errors.SOLVE_BACKWARD_RTOL)
        return (cls(model=model, cfg=cfg, params=params, report=report),
                FitPlan(factors=factors, cfg=cfg, params=params))

    @property
    def device(self) -> torch.device:
        return self.model.device

    def autotune_backends(self, num_points: int) -> tuple:
        """The apply backends the node's autotune times on a mesh of
        num_points: ("auto",), apply's own rule, on a CPU model, for the
        growing kernels (the f32 kernels break the 5e-5 budget for them:
        only the float64 kernel will do) and below the culled kernel's
        crossover; ("cuda",) for a kernel the culled kernel cannot take;
        otherwise AUTOTUNE_BACKENDS."""
        kernel = fit_mod.effective_kernel(self.cfg)
        if (self.device.type != "cuda" or num_points < _CULL_MIN_VERTS
                or kernel in GROWING_KERNELS):
            return ("auto",)
        if not cuda_eval.kernel_is_cullable(kernel):
            return ("cuda",)
        return AUTOTUNE_BACKENDS

    def _points(self, points) -> torch.Tensor:
        return profiling.to_device(points, self.device, torch.float32)

    def displacement(self, points) -> torch.Tensor:
        """Raw RBF displacement field at points (V, 3) -> (V, 3); growing
        kernels evaluate in float64 (ops/precise_eval), as apply() does."""
        kernel = fit_mod.effective_kernel(self.cfg)
        fn = evaluate_precise if kernel in GROWING_KERNELS else evaluate
        return fn(self.model, self._points(points), kernel, self.cfg.term)

    def jacobian(self, points) -> torch.Tensor:
        """Spatial Jacobian of the displacement field at points, (V, 3, 3):
        the CUDA Jacobian kernel on a CUDA model, the plain
        displacement_jacobian on a CPU model."""
        kernel = fit_mod.effective_kernel(self.cfg)
        return cuda_jacobian.jacobian_cuda(
            self.model, self._points(points).contiguous(), kernel, self.cfg.term)

    def deformed_normals(self, points, normals, weight, frame=None) -> torch.Tensor:
        """Transport normals through the applied map y = x + w (T) d(x) by
        the cofactor rule (the reference leaves rest-pose normals).

        points: (V, 3) REST positions; normals: (V, 3) rest normals;
        weight: (V,) the falloff apply() returned; frame: the (u, v, n)
        apply() used, when cfg.tangent."""
        return jac_mod.transport_normals(
            self.jacobian(points), normals, weight, self.cfg, frame)

    def transform_attrs(self, points, attrs, weight, frame=None, kinds=None,
                        want_stretch=False, f_map=None):
        """Transport point attributes through the applied map's deformation
        gradient, one shared Jacobian for the batch: (V, 3) attrs as
        vectors (N by the cofactor rule), (V, 4) as orientation
        quaternions.  Returns {name: array}, plus the (V, 3) principal
        stretches when want_stretch (see ops.jacobian.transport_attrs)."""
        return jac_mod.transport_attrs(
            self.jacobian(points), attrs, weight, self.cfg, frame, kinds,
            want_stretch=want_stretch, f_map=f_map,
        )

    def principal_stretches(self, points, weight, frame=None, f_map=None) -> torch.Tensor:
        """Singular values of the applied map's deformation gradient,
        descending; (V, 3): > 1 stretch, < 1 compression."""
        f = jac_mod._applied_gradient(self.jacobian(points), weight, self.cfg, frame)
        if f_map is not None:
            f = f_map(f)
        return jac_mod.principal_stretches(f)

    def apply(
        self,
        points,
        dist2=None,
        frame=None,
        group_mask=None,
        backend: str = "auto",
        spatial_perm=None,
        points_key=None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Deform points on the model's device; returns (new_points (V, 3),
        fd_falloff (V,)).

        dist2: optional (V,) captured squared distances (default zeros:
        everything deforms fully, reference quirk 1).  frame: optional
        (u, v, n) tangent attributes, used when cfg.tangent.  group_mask:
        optional (V,) bool point-group restriction; masked-out points are
        returned exactly.  backend: "auto" takes, on a CUDA model, the
        float64 precise kernel for growing kernels (TPS/MQ/linear/cubic),
        the culled CUDA kernel for gaussian/Wendland at V >= 4096 and the
        dense CUDA kernel otherwise; on a CPU model the plain
        "dense_precise" path for growing kernels and "dense" otherwise.
        "dense", "dense_precise", "cuda", "cuda_culled" and "cuda_precise"
        force a path ("dense"/"cuda" on a growing kernel evaluate the f32
        field, as in the JAX package).  spatial_perm: optional (perm,
        inv_perm) from ops.morton.spatial_order(points): the points, dist2,
        frame and group mask are gathered into Z-order, evaluated (the
        culled kernel's slabs then hold neighbours) and the result is
        scattered back; each gather of 1M rows is device work the caller
        should amortize (a persistent mesh is better sorted once).
        points_key: the caller's id for the point set, which the PU route
        keys its eval plan on; the global model has no such plan.
        """
        if spatial_perm is not None:
            return self._apply_sorted(points, dist2, frame, group_mask, backend, spatial_perm)
        points = self._points(points)
        dev = points.device
        v = points.shape[0]
        if dist2 is None:
            dist2 = torch.zeros(v, dtype=torch.float32, device=dev)
        else:
            dist2 = profiling.to_device(dist2, dev, torch.float32).contiguous()
        if frame is not None:
            frame = tuple(profiling.to_device(f, dev, torch.float32).contiguous()
                          for f in frame)
        if group_mask is not None:
            group_mask = profiling.to_device(group_mask, dev, torch.bool)
        frame = frame if self.cfg.tangent and frame is not None else None
        kernel = fit_mod.effective_kernel(self.cfg)
        if backend == "auto":
            if kernel in GROWING_KERNELS:
                # f32 breaks the 5e-5 budget for these well below
                # production sizes: the float64 path, kernel or plain twin
                backend = "cuda_precise" if dev.type == "cuda" else "dense_precise"
            elif dev.type != "cuda":
                backend = "dense"
            elif cuda_eval.kernel_is_cullable(kernel) and v >= _CULL_MIN_VERTS:
                backend = "cuda_culled"
            else:
                backend = "cuda"
        if backend not in _BACKENDS:
            # a typo must not fall through to some other path
            raise ValueError(
                f"unknown backend {backend!r}; expected 'auto', 'dense', "
                "'dense_precise', 'cuda', 'cuda_culled' or 'cuda_precise'"
            )
        if backend in ("dense", "dense_precise"):
            fn = evaluate_precise if backend == "dense_precise" else evaluate
            return _apply_plain(fn, self.model, points, dist2, frame, group_mask,
                                self.cfg, self.params)
        params = self.params.clamped()
        gate = (
            group_mask.float() if group_mask is not None
            else torch.ones(v, dtype=torch.float32, device=dev)
        )
        fn = {"cuda": cuda_eval.evaluate_cuda, "cuda_culled": cuda_eval.evaluate_cuda_culled,
              "cuda_precise": cuda_precise.evaluate_cuda_precise}[backend]
        new_pts, w = fn(
            self.model, points.contiguous(), dist2, gate, params.radius,
            params.falloffrate, kernel, self.cfg.term,
            strict_parity=self.cfg.strict_parity, frame=frame,
        )
        if group_mask is not None:
            # the gate zeroes the displacement; also pin positions exactly
            new_pts = torch.where(group_mask[:, None], new_pts, points)
        return new_pts, w

    def _apply_sorted(self, points, dist2, frame, group_mask, backend, spatial_perm):
        """apply() in the Z-order of spatial_perm, scattered back."""
        points = self._points(points)
        perm, inv = (profiling.to_device(p, points.device, torch.int64)
                     for p in spatial_perm)

        def gather(t, dtype):
            return None if t is None else profiling.to_device(t, points.device, dtype)[perm]

        new_s, w_s = self.apply(
            points[perm], dist2=gather(dist2, torch.float32),
            frame=None if frame is None else tuple(gather(f, torch.float32) for f in frame),
            group_mask=gather(group_mask, torch.bool), backend=backend)
        return new_s[inv], w_s[inv]


@dataclasses.dataclass(frozen=True)
class FitPlan:
    """The pose-independent half of a dense fit: the interactive-drag
    artifact.

    The system depends on the rest rig and the solve params only; the
    deformed rig enters through the right-hand side.  A plan holds the
    assembled and LU-factored per-layer systems (ops/fit.FitFactors), so
    re-posing the same rest rig (an artist dragging markers, a tracked
    shot streaming poses) costs O(n^2) triangular solves and refinement
    instead of the O(n^3) factorization.  refit() returns a Deformer whose
    model equals Deformer.fit's of the same pose bit for bit.  Obtain one
    from Deformer.fit_with_plan or FitPlan.prepare.  Dense route only (PU
    rigs plan per patch, Krylov fits are matrix-free): gate with
    FitPlan.supports(cfg, n).
    """

    factors: fit_mod.FitFactors
    cfg: DeformConfig
    params: DeformParams

    @staticmethod
    def supports(cfg: DeformConfig, n: int) -> bool:
        """Whether (cfg, n-control rig) takes the dense factorization a
        plan caches."""
        return cfg.solver != "pu" and not fit_mod.uses_krylov(cfg, n)

    @classmethod
    def prepare(
        cls,
        rest_ctrl,
        cfg: DeformConfig = DeformConfig(),
        params: DeformParams = DeformParams(),
        confidence=None,
        device="cuda",
    ) -> "FitPlan":
        """Assemble and factor on `device` without a pose (ops/fit.prepare)."""
        rest_ctrl = profiling.to_device(rest_ctrl, device, torch.float32)
        if confidence is not None:
            confidence = fit_mod.confidence_clipped(confidence, rest_ctrl.shape[0], device)
        factors = fit_mod.prepare(rest_ctrl, cfg.solve_view(), params, confidence=confidence)
        return cls(factors=factors, cfg=cfg, params=params)

    @property
    def num_controls(self) -> int:
        return int(self.factors.ctrl.shape[0])

    def refit(self, deformed_ctrl, check: bool = True) -> Deformer:
        """Re-solve for a new pose of the planned rest rig, on the plan's
        device: ShapeMismatchError on a pose of another rig size,
        SolveFailedError through errors.check_solve at the dense route's
        threshold.  A span, fit.refit."""
        with profiling.span("fit.refit"):
            ctrl = self.factors.ctrl
            deformed_ctrl = profiling.to_device(deformed_ctrl, ctrl.device, torch.float32)
            if deformed_ctrl.shape != ctrl.shape:
                raise errors.ShapeMismatchError(
                    f"planned rest rig has {tuple(ctrl.shape)} points but the pose has "
                    f"{tuple(deformed_ctrl.shape)}"
                )
            model, report = fit_mod.refit(self.factors, deformed_ctrl, self.cfg.solve_view())
            if check:
                errors.check_solve(report, rtol=errors.SOLVE_BACKWARD_RTOL)
            return Deformer(model=model, cfg=self.cfg, params=self.params, report=report)
