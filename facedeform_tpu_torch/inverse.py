"""Inverse rig fitting: recover control-point motion from a target mesh
(port of facedeform_tpu/inverse.py).

For single-layer models the pipeline is LINEAR in the rig displacement
`delta`:

    w      = A^-1 [delta; 0]                  (the RBF solve)
    disp_i = falloff_i * PhiEval_i . w        (the eval loop)

so the vertex displacements are D = W K delta with K = PhiEval A^-1[:, :N]
(V, N) and W the per-vertex falloff, and the inverse problem is one
ridge-regularized least-squares solve in the N rig deltas (shared across
xyz):

    delta* = argmin ||W (K delta - T)||_F^2 + ridge ||delta||^2

on the device: one LU of A^T against V right-hand sides for K (QNN's
per-point radii make A non-symmetric), one (N, N) Gram and a refined
Cholesky solve, every product in float32 without TF32.

Multilayer stacks and tangent projection take the gradient path: Adam
(written out, with optax's defaults: b1 0.9, b2 0.999, eps 1e-8, eps_root
0, bias correction) on the rig delta, differentiating through ops/fit.fit
(the LU and its refinement) and the eval.  On a CUDA model the eval is
ops/cuda_eval.evaluate_cuda_diff (the dense kernel forward, the plain
twin's backward); on the CPU the plain evaluate.

The subsample of constraint vertices is drawn from a torch.Generator
seeded with `seed` (the JAX package draws it with jax.random, which the
port cannot reproduce), so the two packages agree where V <= subsample.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from facedeform_tpu_torch.config import DeformConfig, DeformParams, RBFModelType
from facedeform_tpu_torch.ops import fit as fit_mod
from facedeform_tpu_torch.ops.assemble import assemble_system, poly_basis
from facedeform_tpu_torch.ops.cuda_eval import evaluate_cuda_diff
from facedeform_tpu_torch.ops.evaluate import evaluate
from facedeform_tpu_torch.ops.falloff import falloff_weight
from facedeform_tpu_torch.ops.kernels import apply_kernel, pairwise_sqdist
from facedeform_tpu_torch.ops.solve import LUFactors, cholesky_solve_refined, lu_solve
from facedeform_tpu_torch.ops.tangent import project_to_tangents
from facedeform_tpu_torch.utils.precision import highest_precision

# optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_EPS_ROOT = 0.9, 0.999, 1e-8, 0.0


class InverseRigResult(NamedTuple):
    deformed_ctrl: torch.Tensor  # (N, 3) recovered rig pose
    residual_rms: torch.Tensor   # rms vertex error of the refit
    iterations: int              # 0 for the closed-form path


def _linear_map_matrix(rest_ctrl: torch.Tensor, points: torch.Tensor, cfg: DeformConfig,
                       params: DeformParams) -> torch.Tensor:
    """K (V, N): vertex displacement per unit rig delta (single layer)."""
    params = params.clamped()
    n = rest_ctrl.shape[0]
    kernel = fit_mod.effective_kernel(cfg)
    if cfg.model == RBFModelType.QNN:
        eps = fit_mod._qnn_radii(rest_ctrl, params.qcoef, params.zcoef)
        lam = 0.0
    else:
        eps = torch.full((n,), params.radius, dtype=torch.float32, device=rest_ctrl.device)
        lam = params.lam
    a = assemble_system(rest_ctrl, kernel, cfg.term, eps, lam)
    phi_e = apply_kernel(kernel, pairwise_sqdist(points, rest_ctrl), eps)
    phi_full = torch.cat([phi_e, poly_basis(points, cfg.term)], 1)   # (V, N+m)
    # K = phi_full A^-1[:, :N] == ((A^T)^-1 phi_full^T)[:N]^T: one f32 LU
    # of A^T against V right-hand sides (A is not symmetric in QNN mode)
    with highest_precision():
        z = lu_solve(LUFactors(*torch.linalg.lu_factor(a.T)), phi_full.T)
    return z[:n].T


def _fit_rig_closed_form(rest_ctrl, rest_points, target_points, dist2, cfg, params, ridge):
    params = params.clamped()
    target_disp = target_points - rest_points
    k = _linear_map_matrix(rest_ctrl, rest_points, cfg, params)
    w, _ = falloff_weight(dist2, params.radius, params.falloffrate,
                          strict_parity=cfg.strict_parity)
    # the falloff is part of the prediction: observed_i = w_i (K delta)_i
    kw = k * w[:, None]
    with highest_precision():
        g = kw.T @ kw
        rhs = kw.T @ target_disp
    n = g.shape[0]
    reg = ridge * torch.trace(g) / n + 1e-30
    delta, _ = cholesky_solve_refined(g + reg * torch.eye(n, dtype=g.dtype, device=g.device), rhs)
    with highest_precision():
        err = kw @ delta - target_disp
    rms = torch.sqrt(torch.mean(torch.sum(err * err, -1)))
    return rest_ctrl + delta, rms


def fit_rig(
    rest_ctrl,
    rest_points,
    target_points,
    cfg: DeformConfig = DeformConfig(),
    params: DeformParams = DeformParams(),
    dist2=None,
    frame=None,
    ridge: float = 1e-4,
    max_iters: int = 200,
    learning_rate: float = 5e-2,
    subsample: Optional[int] = 20000,
    seed: int = 0,
    device="cuda",
) -> InverseRigResult:
    """Recover the deformed rig whose deformation best matches the target,
    on `device`.

    rest_ctrl: (N, 3) rest rig markers; rest_points / target_points: (V, 3)
    rest and target mesh positions; dist2: optional capture distances
    gating the fit as in the forward pass; frame: optional (u, v, n)
    tangent attributes, used with cfg.tangent (no frame = no projection,
    so the closed form still applies).  ridge: Tikhonov weight on the rig
    delta.  max_iters / learning_rate: the gradient path's budget
    (multilayer or tangent).  subsample: cap on constraint vertices (a
    random subset from a torch.Generator seeded with `seed`); None = all.

    Returns InverseRigResult; feed .deformed_ctrl back into Deformer.fit
    to reproduce the target.
    """
    dev = torch.device(device)
    rest_ctrl = torch.as_tensor(rest_ctrl, dtype=torch.float32, device=dev)
    rest_points = torch.as_tensor(rest_points, dtype=torch.float32, device=dev)
    target_points = torch.as_tensor(target_points, dtype=torch.float32, device=dev)
    # the closed form factorizes the (N+m)^2 system and holds a (V, N+m)
    # map; the gradient path differentiates the dense solve only
    n_rig = int(rest_ctrl.shape[0])
    grad_path = cfg.n_layers > 1 or (cfg.tangent and frame is not None)
    if n_rig > fit_mod._KRYLOV_THRESHOLD or (grad_path and fit_mod.uses_krylov(cfg, n_rig)):
        raise ValueError(
            f"inverse rig fit needs the dense solve route (N <= "
            f"{fit_mod._KRYLOV_THRESHOLD}; the gradient path additionally "
            f"needs solver auto/direct — Krylov while_loops don't "
            f"reverse-differentiate); got N={n_rig}, "
            f"solver={cfg.solver!r} — decimate the rig first "
            "(ops.decimate.reduce_rig / CLI deform --reduce-k)"
        )
    v = rest_points.shape[0]
    if dist2 is None:
        dist2 = torch.zeros(v, dtype=torch.float32, device=dev)
    else:
        dist2 = torch.as_tensor(dist2, dtype=torch.float32, device=dev)
    if frame is not None:
        frame = tuple(torch.as_tensor(f, dtype=torch.float32, device=dev) for f in frame)
    if subsample is not None and v > subsample:
        gen = torch.Generator().manual_seed(int(seed))
        idx = torch.randperm(v, generator=gen)[:subsample].to(dev)
        rest_points, target_points, dist2 = rest_points[idx], target_points[idx], dist2[idx]
        if frame is not None:
            frame = tuple(f[idx] for f in frame)

    use_tangent = cfg.tangent and frame is not None
    if cfg.n_layers == 1 and not use_tangent:
        ctrl, rms = _fit_rig_closed_form(rest_ctrl, rest_points, target_points, dist2,
                                         cfg.eval_view(), params, ridge)
        return InverseRigResult(deformed_ctrl=ctrl, residual_rms=rms, iterations=0)

    # ---- the gradient path: Adam through the differentiable pipeline
    params_c = params.clamped()
    kernel = fit_mod.effective_kernel(cfg)
    w_fall, _ = falloff_weight(dist2, params_c.radius, params_c.falloffrate,
                               strict_parity=cfg.strict_parity)
    target_disp = target_points - rest_points
    on_card = dev.type == "cuda"
    gate = torch.ones_like(dist2)
    points = rest_points.contiguous()
    frame_c = tuple(f.contiguous() for f in frame) if use_tangent else None

    def forward_err(delta):
        model, _ = fit_mod.fit(rest_ctrl, rest_ctrl + delta, cfg, params)
        if on_card:
            out, _ = evaluate_cuda_diff(model, points, dist2, gate, params_c.radius,
                                        params_c.falloffrate, frame_c, kernel, cfg.term,
                                        cfg.strict_parity)
            return out - points - target_disp
        disp = evaluate(model, points, kernel, cfg.term)
        if use_tangent:
            disp = project_to_tangents(*frame_c, disp)
        # the forward model applies the falloff to the prediction
        return disp * w_fall[:, None] - target_disp

    delta = torch.zeros_like(rest_ctrl)
    mu, nu = torch.zeros_like(delta), torch.zeros_like(delta)
    for step in range(1, max_iters + 1):
        d = delta.detach().requires_grad_(True)
        err = forward_err(d)
        loss = torch.mean(torch.sum(err * err, -1)) + ridge * torch.mean(d * d)
        (grad,) = torch.autograd.grad(loss, d)
        mu = (1.0 - ADAM_B1) * grad + ADAM_B1 * mu
        nu = (1.0 - ADAM_B2) * (grad * grad) + ADAM_B2 * nu
        mu_hat = mu / (1.0 - ADAM_B1 ** step)
        nu_hat = nu / (1.0 - ADAM_B2 ** step)
        delta = delta - learning_rate * (mu_hat / (torch.sqrt(nu_hat + ADAM_EPS_ROOT) + ADAM_EPS))
    # the pure vertex-error RMS of the final iterate, as the closed form's
    with torch.no_grad():
        final_err = forward_err(delta)
        rms = torch.sqrt(torch.mean(torch.sum(final_err * final_err, -1)))
    return InverseRigResult(deformed_ctrl=rest_ctrl + delta, residual_rms=rms,
                            iterations=max_iters)
