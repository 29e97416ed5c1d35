"""Animated-shot batching: per-frame solve, eval and attribute transport
over a frame axis (port of facedeform_tpu/parallel/batched.py).

An animated shot keeps its rest rig and mesh fixed, so:

  * fit_frames solves F deformed-rig poses against the one rest rig, by
    F per-pose factorizations or, past a memory budget, by one shared
    factorization per layer with the frames as right-hand-side columns;
  * apply_frames evaluates every frame against the same vertex buffer in
    one kernel pass per frame chunk (distances and phi computed once per
    (vertex, control): ops.cuda_eval.evaluate_cuda_frames, or for growing
    kernels the float64 ops.cuda_precise.evaluate_cuda_precise_frames);
  * transport_frames carries point attributes through each frame's
    deformation gradient, with the Jacobians of a frame chunk from one
    kernel pass (ops.cuda_jacobian.jacobian_cuda_frames).

Every function runs on its inputs' device: the kernels for CUDA tensors,
their plain twins for CPU tensors.  A device mesh (mesh=) is the
multi-GPU slice's work and raises NotImplementedError.
"""

from __future__ import annotations

import torch

from facedeform_tpu_torch.config import DeformConfig, DeformParams
from facedeform_tpu_torch.ops import cuda_eval, cuda_jacobian, cuda_precise
from facedeform_tpu_torch.ops import fit as fit_mod
from facedeform_tpu_torch.ops.falloff import falloff_weight
from facedeform_tpu_torch.ops.fit import GROWING_KERNELS, RBFModel
from facedeform_tpu_torch.ops.jacobian import (
    RULES, deformation_gradient, principal_stretches, tangent_projection,
)
from facedeform_tpu_torch.utils import profiling

# Device-memory budget of the per-pose fit's temporaries.  Past it
# fit_frames takes the shared factorization (fit_mod.fit_frames_dense),
# whose temporaries do not grow with F beyond its (N + m, 3F) columns.
# The per-pose route holds F LU factors of the (R, R) system, R = N + m
# (f32, from one contiguous copy of the expanded system), beside the
# shared system in f32 and its float64 copy for the refinement residual;
# its (F, R, 3) solution, residual and correction columns are negligible:
#     bytes = 4 F R^2 + (4 + 8) R^2      (_vmap_fit_bytes)
# (measured on an H100 at 4096 controls x 32 frames: 2.378 GB peak, 2.353
# GB estimated).  The budget is three eighths of an 80 GB card, the share
# of device memory the JAX package's 6e9 left the fit on a 15.75 GB v5e.
# Growing kernels make no F copies: both routes run one factorization and
# the same per-pose GMRES-IR and keep its lo words, so for them the two
# routes give the same model bit for bit (the JAX package's shared route
# drops the lo words).
vmap_fit_hbm_budget = 30e9


def _vmap_fit_bytes(n_rows: int, f: int) -> float:
    """Peak device bytes of the per-pose fit's temporaries (see above)."""
    return 4.0 * f * n_rows * n_rows + 12.0 * n_rows * n_rows


def _mesh_not_ported(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh (sharded frames) is not ported yet "
            "(ROADMAP queue 1, slice H: multi-GPU)"
        )


def _f32(x, device) -> torch.Tensor:
    return profiling.to_device(x, device, torch.float32)


@profiling.traced("batched.fit_frames")
def fit_frames(
    rest_ctrl,
    deformed_frames,
    cfg: DeformConfig,
    params: DeformParams = DeformParams(),
    confidence=None,
    device="cuda",
    want_report: bool = False,
):
    """Solve F frames at once on `device`: (N, 3), (F, N, 3) -> (stacked
    RBFModel, per-frame residual norms (F,)).

    The model carries a leading F axis on w_rbf (F, L, N, 3) and w_poly
    (F, m, 3); ctrl and eps are frame-invariant.  Routing, as in the JAX
    package: the per-pose fit (fit_mod.fit_frames_per_pose, lo words
    stacked) while its temporaries fit vmap_fit_hbm_budget, the shared
    factorization (fit_mod.fit_frames_dense) above it, which drops the lo
    words of decaying kernels.  For growing kernels the two routes run the
    same solve and give the same model, lo words included.  Krylov-size
    rigs (fit_mod.uses_krylov) always take the per-pose route: one
    matrix-free fit() per pose, no lo words.  want_report adds a third
    return, the per-frame SolveReport of each frame's worst layer.  Check
    the residuals with utils.errors.check_frames (on the Krylov route of a
    CPD kernel it needs cfg= and that report=)."""
    rest_ctrl = _f32(rest_ctrl, device)
    deformed_frames = _f32(deformed_frames, device)
    if confidence is not None:
        confidence = fit_mod.confidence_clipped(confidence, rest_ctrl.shape[0], device)
    n, f = rest_ctrl.shape[0], deformed_frames.shape[0]
    if not fit_mod.uses_krylov(cfg, n) and (
        _vmap_fit_bytes(n + cfg.n_poly, f) > vmap_fit_hbm_budget
    ):
        out = fit_mod.fit_frames_dense(
            rest_ctrl, deformed_frames, cfg, params, confidence=confidence,
            want_report=want_report)
        return out[:2] + out[3:]
    return fit_mod.fit_frames_per_pose(
        rest_ctrl, deformed_frames, cfg, params, confidence=confidence,
        want_report=want_report)


@profiling.traced("batched.apply_frames")
def apply_frames(
    batched_model: RBFModel,
    points,
    dist2,
    gate,
    cfg: DeformConfig,
    params: DeformParams,
    mesh=None,
    frame=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Evaluate every frame on the model's device: -> ((F, V, 3) positions,
    (V,) falloff).

    The falloff depends on the capture distances only, so it is computed
    once and folded with the gate into one per-vertex weight, which the
    frames kernel takes as its gate (dist2 = 0, radius = rate = 1: the
    kernel's falloff is then exactly that weight).  frame=(u, v, n) of
    (V, 3) tangent attributes projects every frame's displacement when
    cfg.tangent is set; it is dropped otherwise.  The frames kernel is
    f32-only, so growing kernels take the float64 precise kernel's frames
    launches (ops.cuda_precise.evaluate_cuda_precise_frames: phi shared
    across up to 8 frames, each frame's lo words when the model has them),
    with the same folded weight as their gate."""
    _mesh_not_ported(mesh)
    dev = batched_model.device
    kernel = fit_mod.effective_kernel(cfg)
    points = _f32(points, dev).contiguous()
    frame = None if not cfg.tangent or frame is None else tuple(
        _f32(f, dev).contiguous() for f in frame)
    params = params.clamped()
    with profiling.span("eval.falloff_weight"):
        w, _ = falloff_weight(_f32(dist2, dev), params.radius, params.falloffrate,
                              strict_parity=cfg.strict_parity)
        w = (w * _f32(gate, dev)).contiguous()
    zeros = torch.zeros_like(w)
    evaluate = (cuda_precise.evaluate_cuda_precise_frames if kernel in GROWING_KERNELS
                else cuda_eval.evaluate_cuda_frames)
    with profiling.span("eval.frames"):
        out, _ = evaluate(batched_model, points, zeros, w, 1.0, 1.0, kernel, cfg.term,
                          frame=frame)
    return out, w


def deform_frames(
    rest_ctrl,
    deformed_frames,
    points,
    dist2,
    gate,
    cfg: DeformConfig,
    params: DeformParams = DeformParams(),
    mesh=None,
    frame=None,
    confidence=None,
    device="cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole shot on `device`: fit_frames then apply_frames; returns
    ((F, V, 3) positions, (V,) falloff)."""
    _mesh_not_ported(mesh)
    model, _ = fit_frames(rest_ctrl, deformed_frames, cfg, params,
                          confidence=confidence, device=device)
    return apply_frames(model, points, dist2, gate, cfg, params, frame=frame)


@profiling.traced("batched.transport_frames")
def transport_frames(
    batched_model: RBFModel,
    points,
    values,
    weight,
    cfg: DeformConfig,
    kinds,
    mesh=None,
    frame=None,
    want_stretch: bool = False,
):
    """Per-frame attribute transport for a whole shot, on the model's
    device.

    For each frame the displacement Jacobian of that frame's model is
    taken at the REST positions and the per-kind rules applied (vector /
    normal / quaternion, ops/jacobian.py), plus the principal stretches
    when want_stretch: the batched twin of Deformer.transform_attrs.  The
    Jacobians come one kernel chunk of frames at a time and the rules are
    applied per chunk, so the (F, V, 3, 3) stack never lives whole.

    values: tuple of (V, 3)/(V, 4) rest attributes, one per kind in
    `kinds`; weight: (V,) frame-invariant multiplier (falloff x gate).
    Returns a tuple of (F, V, k) tensors (+ (F, V, 3) stretches last)."""
    _mesh_not_ported(mesh)
    dev = batched_model.device
    kernel = fit_mod.effective_kernel(cfg)
    kinds = tuple(kinds)
    for k in kinds:
        if k not in RULES:
            raise ValueError(f"no transport rule for kind {k!r}; expected one of {tuple(RULES)}")
    points = _f32(points, dev).contiguous()
    values = tuple(_f32(v, dev) for v in values)
    weight = _f32(weight, dev)
    # the tangent projection is frame-invariant: once for the shot
    proj = tangent_projection(cfg, frame, points)
    n_frames = batched_model.w_rbf.shape[0]
    step = cuda_jacobian.JAC_FRAMES_PER_LAUNCH
    outs = [[] for _ in range(len(values) + int(want_stretch))]
    for lo in range(0, n_frames, step):
        sub = RBFModel(ctrl=batched_model.ctrl, w_rbf=batched_model.w_rbf[lo:lo + step],
                       w_poly=batched_model.w_poly[lo:lo + step], eps=batched_model.eps)
        with profiling.span("transport.jacobian"):
            jacs = cuda_jacobian.jacobian_cuda_frames(sub, points, kernel, cfg.term)
        with profiling.span("transport.rules"):
            for jac in jacs:
                f = deformation_gradient(jac, weight, proj)
                for out, val, k in zip(outs, values, kinds):
                    out.append(RULES[k](val, f))
                if want_stretch:
                    outs[-1].append(principal_stretches(f))
    with profiling.span("transport.stack"):
        return tuple(torch.stack(o) for o in outs)
