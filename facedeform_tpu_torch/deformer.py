"""Deformer: the solve-once / eval-many user API (port of
facedeform_tpu/deformer.py).

The reference's eval loop, per mesh point: skip if the captured d2 exceeds
radius^2, disp = rbfcalc(P), optional tangent projection, falloff =
(1 - min(d2/r^2, 1))^rate, write fd_falloff and P += falloff * disp,
restricted to the optional point group.
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
from facedeform_tpu_torch.ops.kernels import kernel_is_pd
from facedeform_tpu_torch.ops.precise_eval import GROWING_KERNELS, evaluate_precise
from facedeform_tpu_torch.ops.solve import SolveReport
from facedeform_tpu_torch.ops.tangent import project_to_tangents
from facedeform_tpu_torch.utils import errors

_BACKENDS = ("dense", "dense_precise", "cuda", "cuda_culled", "cuda_precise")

# The culled kernel needs enough vertex blocks for coherent bboxes to pay
# for the slab tests (the JAX package's measured crossover).
_CULL_MIN_VERTS = 4096


@dataclasses.dataclass(frozen=True)
class Deformer:
    """A solved RBF deformation: model + config; eval-many across frames."""

    model: RBFModel
    cfg: DeformConfig
    params: DeformParams
    report: SolveReport

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

        `confidence` ((N,) per-marker quality in (0, 1]) weights the ridge
        per marker (ridge families only).  Raises ShapeMismatchError on a
        rig count mismatch and SolveFailedError on solver blow-up.
        """
        if cfg.solver == "pu":
            # the PU model is a different artifact (patch tensors, not an
            # RBFModel); the dense route would not fit at the rig sizes PU
            # exists for
            raise ValueError(
                "solver='pu' is not a Deformer route — use "
                "ops.pu.PUDeformer.fit (or ops.pu.PUSeqDeformer.fit for a shot)"
            )
        rest_ctrl = torch.as_tensor(rest_ctrl, dtype=torch.float32, device=device)
        deformed_ctrl = torch.as_tensor(deformed_ctrl, dtype=torch.float32, device=device)
        if rest_ctrl.shape != deformed_ctrl.shape:
            raise errors.ShapeMismatchError(
                f"rest and deform rigs must match: {tuple(rest_ctrl.shape)} vs "
                f"{tuple(deformed_ctrl.shape)}"
            )
        n = rest_ctrl.shape[0]
        if confidence is not None:
            confidence = fit_mod.confidence_clipped(confidence, n, device)
        model, report = fit_mod.fit(
            rest_ctrl, deformed_ctrl, cfg.solve_view(), params, confidence=confidence
        )
        if check:
            # the CPD-kernel Krylov route converges to the f32 Krylov noise
            # floor, not the refined-LU floor: match the route fit() took
            kernel = fit_mod.effective_kernel(cfg)
            cpd_krylov = fit_mod.uses_krylov(cfg, n) and not kernel_is_pd(kernel)
            errors.check_solve(
                report,
                rtol=errors.KRYLOV_CPD_BACKWARD_RTOL if cpd_krylov
                else errors.SOLVE_BACKWARD_RTOL,
            )
        return cls(model=model, cfg=cfg, params=params, report=report)

    def _points(self, points) -> torch.Tensor:
        return torch.as_tensor(points, dtype=torch.float32, device=self.model.device)

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
        field, as in the JAX package).
        """
        points = self._points(points)
        dev = points.device
        v = points.shape[0]
        if dist2 is None:
            dist2 = torch.zeros(v, dtype=torch.float32, device=dev)
        else:
            dist2 = torch.as_tensor(dist2, dtype=torch.float32, device=dev).contiguous()
        if frame is not None:
            frame = tuple(
                torch.as_tensor(f, dtype=torch.float32, device=dev).contiguous()
                for f in frame
            )
        if group_mask is not None:
            group_mask = torch.as_tensor(group_mask, dtype=torch.bool, device=dev)
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
        params = self.params.clamped()
        if backend in ("dense", "dense_precise"):
            fn = evaluate_precise if backend == "dense_precise" else evaluate
            disp = fn(self.model, points, kernel, self.cfg.term)
            if frame is not None:
                disp = project_to_tangents(*frame, disp)
            w, active = falloff_weight(
                dist2, params.radius, params.falloffrate,
                strict_parity=self.cfg.strict_parity,
            )
            if group_mask is not None:
                active = active & group_mask
            w = torch.where(active, w, torch.zeros_like(w))
            return points + disp * w[:, None], w
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
