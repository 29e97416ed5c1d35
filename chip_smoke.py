#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on a CUDA GPU.

    python3 chip_smoke.py

1. requires a CUDA device (exits non-zero without one) and prints the
   card's name and power limit;
2. builds the hand-written CUDA kernels from facedeform_tpu_torch/csrc (one
   nvcc per source, started together) and prints ptxas' register and
   spill counts per kernel;
3. holds each kernel against its plain PyTorch version on the card, all 7
   bases, L in {1, 4}, N in {1000, 2500}, a ragged V = 70002, with and
   without a tangent frame:
   - dense and culled eval: strict_parity both ways, 33% capture-active
     plus a group gate (culled for gaussian and Wendland);
   - frames eval: F in {1, 8, 11, 17} (17 crosses the 16-frame launch
     chunk), a 33%-active folded weight;
   - Jacobian: single entry and F in {8, 9} (9 crosses the 8-frame launch
     chunk), plus a float64 central-difference check of J on 64 vertices;
4. runs slice A's main path at the headline size: Deformer.fit of 1000
   Fibonacci controls (default config), apply("auto") and
   apply(backend="cuda") on the 1M-vertex UV sphere, the localized
   4096-control rig and the capture-gated run, with launch counters read
   around it, and checks the displacement against a float64 oracle on a
   4096-vertex subset;
5. runs slice B's main path, the animated shot: 8 poses smoothed by
   temporal.smooth_frames, batched.fit_frames + check_frames,
   apply_frames on the 1M-vertex sphere with a capture d2 and a tangent
   frame, transport_frames of the sphere's normals with stretches, and
   Deformer.jacobian at 1M, with launch counters read around it; every
   frame is held against a single-pose Deformer on a 4096-vertex subset and
   two frames against a float64 oracle;
6. times fit, each kernel and its plain version, the frames kernel against
   8 dense launches, F = 8/11/16/17/32 per frame, and both fit_frames routes
   (facedeform_tpu_torch.benchmark);
7. prints a kernels JSON line, the card line, and as its last line
   {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero.
"""

from __future__ import annotations

import json
import re
import sys
import time

import numpy as np
import torch

# Tolerances of kernel vs plain version on the card (same inputs, f32):
POS_TOL_DECAYING = 5e-6   # gaussian/IMQ/Wendland positions, absolute
# growing bases (TPS/MQ/linear/cubic) carry |w| >> |disp|; the two sides
# sum in different orders, so they agree to ~u * sum |w phi|: the parity
# budget is their bound
POS_TOL_GROWING = 5e-5
FALLOFF_TOL = 1e-6
ORACLE_BUDGET = 5e-5      # max displacement error vs float64 (BASELINE.md)
BACKWARD_TOL = 1e-6       # fit health, SOLVE_BACKWARD_RTOL
# Jacobian kernel vs plain version, relative to max(1, max|J|): decaying
# bases; growing bases sum larger |g w c| terms in a different order, so
# they get the eval's 10x
JAC_TOL_DECAYING = 1e-5
JAC_TOL_GROWING = 1e-4
# f32 kernel J vs a float64 central difference (h = 1e-5, truncation
# ~1e-8 at these radii), relative to max(1, max|J|)
JAC_FD_TOL = 2e-5
# frames of a shot vs the single-pose kernel path on the same vertices:
# same weights to an ulp, same summation order
FRAME_VS_SINGLE_TOL = 5e-6
TRANSPORT_TOL = 1e-5      # transported normals, kernel vs plain Jacobian, x sigma_min


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _synthetic_model(n, n_layers, kernel, rng, dev):
    """Controls on the unit sphere, seeded radii and weights (layer-0
    weights sum to zero, the tail constraint)."""
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points
    from facedeform_tpu_torch.ops.fit import GROWING_KERNELS, RBFModel

    lo, hi = (1.0, 2.0) if kernel in GROWING_KERNELS else (0.15, 0.4)
    w = rng.standard_normal((n_layers, n, 3)) * (0.05 / np.sqrt(n))
    w[0] -= w[0].mean(axis=0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    return RBFModel(
        ctrl=t(fibonacci_points(n)), w_rbf=t(w),
        w_poly=t(rng.standard_normal((4, 3)) * 0.01),
        eps=t(rng.uniform(lo, hi, (n_layers, n))),
    )


def check_kernels(dev) -> dict:
    """Phase 3: every kernel against its plain version; returns the worst
    deviations per kernel."""
    from facedeform_tpu_torch.config import PolyTerm, RBFKernel
    from facedeform_tpu_torch.geometry.primitives import uv_sphere
    from facedeform_tpu_torch.ops import cuda_eval
    from facedeform_tpu_torch.ops.fit import GROWING_KERNELS

    rng = np.random.default_rng(0)
    pts_np = uv_sphere(250, 280).points * 1.05              # V = 70002, ragged
    v = pts_np.shape[0]
    pts = torch.as_tensor(pts_np, device=dev)
    dist2 = torch.sum((pts - torch.tensor([0.0, 1.05, 0.0], device=dev)) ** 2, -1)
    radius = float(torch.quantile(dist2, 0.33).sqrt())       # 33% active
    dist2[::97] = -1.0                                       # strict-parity sentinel
    gate = (pts[:, 0] > -0.6).float()                        # a group gate
    frame = tuple(torch.as_tensor(rng.standard_normal((v, 3)).astype(np.float32), device=dev)
                  for _ in range(3))
    rate = 1.5
    worst = {"dense": 0.0, "culled": 0.0}
    n_cases = 0
    for n in (1000, 2500):
        for n_layers in (1, 4):
            for kernel in RBFKernel:
                model = _synthetic_model(n, n_layers, kernel, rng, dev)
                tol = POS_TOL_GROWING if kernel in GROWING_KERNELS else POS_TOL_DECAYING
                routes = [("dense", cuda_eval.evaluate_cuda)]
                if cuda_eval.kernel_is_cullable(kernel):
                    routes.append(("culled", cuda_eval.evaluate_cuda_culled))
                group = {name: [0.0, 0.0] for name, _ in routes}
                for with_frame in (False, True):
                    for strict in (False, True):
                        args = (model, pts, dist2, gate, radius, rate, kernel,
                                PolyTerm.LINEAR)
                        kw = dict(strict_parity=strict,
                                  frame=frame if with_frame else None)
                        want_p, want_w = cuda_eval.evaluate_reference(*args, **kw)
                        for name, fn in routes:
                            got_p, got_w = fn(*args, **kw)
                            torch.cuda.synchronize()
                            dp = float(torch.max(torch.abs(got_p - want_p)))
                            dw = float(torch.max(torch.abs(got_w - want_w)))
                            _check(
                                dp <= tol and dw <= FALLOFF_TOL,
                                f"{name} {kernel.name} N={n} L={n_layers} "
                                f"frame={with_frame} strict={strict}: |dpos| {dp:.3e} "
                                f"(tol {tol:g}), |dfalloff| {dw:.3e}",
                            )
                            if tol == POS_TOL_DECAYING:
                                worst[name] = max(worst[name], dp)
                            group[name] = [max(group[name][0], dp), max(group[name][1], dw)]
                            n_cases += 1
                print(f"  N={n} L={n_layers} {kernel.name:20s} " + ", ".join(
                    f"{name} max|dpos| {g[0]:.3e} (tol {tol:g}) max|dfalloff| "
                    f"{g[1]:.3e}" for name, g in group.items()), flush=True)
    print(f"kernel checks: {n_cases} cases within tolerance (positions "
          f"{POS_TOL_DECAYING:g} decaying / {POS_TOL_GROWING:g} growing, "
          f"falloff {FALLOFF_TOL:g}); worst decaying |dpos| dense "
          f"{worst['dense']:.3e}, culled {worst['culled']:.3e}", flush=True)
    return worst


def _frames_model(n, n_layers, n_frames, kernel, rng, dev):
    """A frames-stacked synthetic model: _synthetic_model's controls and
    radii, per-frame seeded weights and tails."""
    from facedeform_tpu_torch.ops.fit import RBFModel

    base = _synthetic_model(n, n_layers, kernel, rng, dev)
    w = rng.standard_normal((n_frames, n_layers, n, 3)) * (0.05 / np.sqrt(n))
    w[:, 0] -= w[:, 0].mean(axis=1, keepdims=True)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    return RBFModel(ctrl=base.ctrl, w_rbf=t(w), eps=base.eps,
                    w_poly=t(rng.standard_normal((n_frames, 4, 3)) * 0.01))


def _ragged_points(dev, rng):
    """V = 70002 points (not a multiple of any block) on a 1.05 sphere and
    a random tangent frame."""
    from facedeform_tpu_torch.geometry.primitives import uv_sphere

    pts_np = uv_sphere(250, 280).points * 1.05
    v = pts_np.shape[0]
    frame = tuple(torch.as_tensor(rng.standard_normal((v, 3)).astype(np.float32), device=dev)
                  for _ in range(3))
    return torch.as_tensor(pts_np, device=dev), frame


def check_frames_kernel(dev) -> float:
    """Phase 3b: the frames eval kernel against its plain twin on a 33%-
    active folded weight (apply_frames' call: dist2 = 0, radius = rate = 1,
    gate = the weight); returns the worst decaying |dpos|."""
    from facedeform_tpu_torch.config import PolyTerm, RBFKernel
    from facedeform_tpu_torch.ops import cuda_eval
    from facedeform_tpu_torch.ops.falloff import falloff_weight
    from facedeform_tpu_torch.ops.fit import GROWING_KERNELS, RBFModel

    rng = np.random.default_rng(1)
    pts, frame = _ragged_points(dev, rng)
    d2_cap = torch.sum((pts - torch.tensor([0.0, 1.05, 0.0], device=dev)) ** 2, -1)
    radius = float(torch.quantile(d2_cap, 0.33).sqrt())          # 33% active
    fold, _ = falloff_weight(d2_cap, radius, 1.5)
    fold = (fold * (pts[:, 0] > -0.6).float()).contiguous()       # x a group gate
    zeros = torch.zeros_like(fold)
    worst, n_cases = 0.0, 0
    for n in (1000, 2500):
        for n_layers in (1, 4):
            for kernel in RBFKernel:
                full = _frames_model(n, n_layers, 17, kernel, rng, dev)
                tol = POS_TOL_GROWING if kernel in GROWING_KERNELS else POS_TOL_DECAYING
                group = [0.0, 0.0]
                for with_frame in (False, True):
                    fr = frame if with_frame else None
                    # the twin is per frame: compute it once for 17 frames
                    want_p, want_w = cuda_eval.evaluate_frames_reference(
                        full, pts, zeros, fold, 1.0, 1.0, kernel, PolyTerm.LINEAR, frame=fr)
                    for n_frames in (1, 8, 11, 17):
                        model = RBFModel(ctrl=full.ctrl, w_rbf=full.w_rbf[:n_frames],
                                         w_poly=full.w_poly[:n_frames], eps=full.eps)
                        got_p, got_w = cuda_eval.evaluate_cuda_frames(
                            model, pts, zeros, fold, 1.0, 1.0, kernel, PolyTerm.LINEAR,
                            frame=fr)
                        torch.cuda.synchronize()
                        dp = float(torch.max(torch.abs(got_p - want_p[:n_frames])))
                        dw = float(torch.max(torch.abs(got_w - want_w)))
                        _check(
                            tuple(got_p.shape) == (n_frames, pts.shape[0], 3)
                            and dp <= tol and dw <= FALLOFF_TOL
                            and bool(torch.equal(got_w, fold)),
                            f"frames {kernel.name} N={n} L={n_layers} F={n_frames} "
                            f"frame={with_frame}: |dpos| {dp:.3e} (tol {tol:g}), "
                            f"|dfalloff| {dw:.3e}, falloff == folded weight "
                            f"{bool(torch.equal(got_w, fold))}",
                        )
                        if tol == POS_TOL_DECAYING:
                            worst = max(worst, dp)
                        group = [max(group[0], dp), max(group[1], dw)]
                        n_cases += 1
                print(f"  frames N={n} L={n_layers} {kernel.name:20s} max|dpos| "
                      f"{group[0]:.3e} (tol {tol:g}) max|dfalloff| {group[1]:.3e}",
                      flush=True)
    print(f"frames kernel checks: {n_cases} cases within tolerance, falloff equal to "
          f"the folded weight; worst decaying |dpos| {worst:.3e}", flush=True)
    return worst


def _field64(model, pts, kernel):
    """Float64 displacement of a single-pose model, written out."""
    from facedeform_tpu_torch.ops.kernels import apply_kernel

    p = pts.double()
    d2 = ((p[:, None] - model.ctrl.double()[None]) ** 2).sum(-1)
    disp = sum(apply_kernel(kernel, d2, model.eps.double()[l]) @ model.w_rbf.double()[l]
               for l in range(model.w_rbf.shape[0]))
    ones = torch.ones(p.shape[0], 1, dtype=p.dtype, device=p.device)
    return disp + torch.cat([ones, p], 1) @ model.w_poly.double()


def check_jacobian_kernel(dev) -> float:
    """Phase 3c: the Jacobian kernel (single entry, F = 8 and F = 9) against
    its plain twin, and against a float64 central difference of the field
    on 64 vertices; returns the worst decaying relative |dJ|."""
    from facedeform_tpu_torch.config import PolyTerm, RBFKernel
    from facedeform_tpu_torch.ops import cuda_eval, cuda_jacobian
    from facedeform_tpu_torch.ops.fit import GROWING_KERNELS, RBFModel

    rng = np.random.default_rng(2)
    pts, _ = _ragged_points(dev, rng)
    idx = torch.linspace(0, pts.shape[0] - 1, 64, device=dev).long()
    h = 1e-5
    worst, n_cases = 0.0, 0
    for n in (1000, 2500):
        for n_layers in (1, 4):
            for kernel in RBFKernel:
                model = _frames_model(n, n_layers, 9, kernel, rng, dev)
                tol = JAC_TOL_GROWING if kernel in GROWING_KERNELS else JAC_TOL_DECAYING
                want = cuda_jacobian.jacobian_frames_reference(
                    model, pts, kernel, PolyTerm.LINEAR)
                got9 = cuda_jacobian.jacobian_cuda_frames(model, pts, kernel, PolyTerm.LINEAR)
                got8 = cuda_jacobian.jacobian_cuda_frames(
                    RBFModel(ctrl=model.ctrl, w_rbf=model.w_rbf[:8],
                             w_poly=model.w_poly[:8], eps=model.eps),
                    pts, kernel, PolyTerm.LINEAR)
                one = cuda_eval.frame_model(model, 0)
                got1 = cuda_jacobian.jacobian_cuda(one, pts, kernel, PolyTerm.LINEAR)
                torch.cuda.synchronize()
                scale = max(1.0, float(torch.max(torch.abs(want))))
                e8 = max(float(torch.max(torch.abs(got8 - want[:8]))),
                         float(torch.max(torch.abs(got9 - want)))) / scale
                e1 = float(torch.max(torch.abs(got1 - want[0]))) / scale
                # float64 central difference of the field, frame 0
                fd = torch.zeros((64, 3, 3), dtype=torch.float64, device=dev)
                for b in range(3):
                    step = torch.zeros(3, dtype=torch.float64, device=dev)
                    step[b] = h
                    p = pts[idx].double()
                    fd[:, :, b] = (_field64(one, p + step, kernel)
                                   - _field64(one, p - step, kernel)) / (2 * h)
                efd = float(torch.max(torch.abs(got1[idx].double() - fd))) / max(
                    1.0, float(torch.max(torch.abs(fd))))
                _check(e8 <= tol and e1 <= tol and efd <= JAC_FD_TOL,
                       f"jacobian {kernel.name} N={n} L={n_layers}: rel |dJ| F=8/9 "
                       f"{e8:.3e}, single {e1:.3e} (tol {tol:g}); vs float64 FD "
                       f"{efd:.3e} (tol {JAC_FD_TOL:g})")
                if tol == JAC_TOL_DECAYING:
                    worst = max(worst, e8, e1)
                n_cases += 3
                print(f"  jacobian N={n} L={n_layers} {kernel.name:20s} rel|dJ| F=8/9 "
                      f"{e8:.3e} single {e1:.3e} (tol {tol:g}), vs f64 FD {efd:.3e}",
                      flush=True)
    print(f"jacobian kernel checks: {n_cases} cases within tolerance (relative "
          f"{JAC_TOL_DECAYING:g} decaying / {JAC_TOL_GROWING:g} growing, float64 FD "
          f"{JAC_FD_TOL:g}); worst decaying {worst:.3e}", flush=True)
    return worst


def _oracle_disp(rest, deformed, pts, q=1.0, z=5.0):
    """Float64 QNN gaussian + linear tail: radii, saddle solve and field,
    written out independently of the port."""
    ctrl = rest.double()
    delta = deformed.double() - ctrl
    n = ctrl.shape[0]
    d2 = ((ctrl[:, None] - ctrl[None]) ** 2).sum(-1)
    nn_d = torch.sqrt(torch.min(d2 + torch.diag(torch.full((n,), float("inf"),
                                                           dtype=d2.dtype, device=d2.device)), 1).values)
    nn_d = torch.maximum(nn_d, 1e-4 * torch.clamp(nn_d.max(), min=1e-6))
    eps = torch.minimum(q * nn_d, z * nn_d.mean())
    p = torch.cat([torch.ones(n, 1, dtype=ctrl.dtype, device=ctrl.device), ctrl], 1)
    a = torch.zeros(n + 4, n + 4, dtype=ctrl.dtype, device=ctrl.device)
    a[:n, :n] = torch.exp(-d2 / eps[None] ** 2)
    a[:n, n:] = p
    a[n:, :n] = p.T
    a[n:, n:] = -1e-8 * torch.eye(4, dtype=ctrl.dtype, device=ctrl.device)
    b = torch.cat([delta, torch.zeros(4, 3, dtype=ctrl.dtype, device=ctrl.device)])
    x = torch.linalg.solve(a, b)
    q_pts = pts.double()
    dq = ((q_pts[:, None] - ctrl[None]) ** 2).sum(-1)
    pq = torch.cat([torch.ones(len(q_pts), 1, dtype=ctrl.dtype, device=ctrl.device), q_pts], 1)
    return torch.exp(-dq / eps[None] ** 2) @ x[:n] + pq @ x[n:]


def main_path(dev, label: str) -> dict:
    """Phase 4: the main path at the headline size, with launch counters."""
    from facedeform_tpu_torch import DeformConfig, DeformParams, Deformer
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points, uv_sphere
    from facedeform_tpu_torch.ops import cuda_eval
    from facedeform_tpu_torch.ops.fit import effective_kernel

    rng = np.random.default_rng(0)
    rest = fibonacci_points(1000)
    deformed = rest + 0.05 * rng.standard_normal((1000, 3)).astype(np.float32)
    n_loc = 4096
    cap = fibonacci_points(n_loc) * 0.15 + np.float32([0, 0.98, 0])
    cap_def = cap + 0.01 * rng.standard_normal((n_loc, 3)).astype(np.float32)
    mesh = uv_sphere(1000, 1000)
    pts = torch.as_tensor(mesh.points, device=dev)
    cap_d2 = torch.sum((pts - torch.tensor([0.0, 1.0, 0.0], device=dev)) ** 2, -1)

    cuda_eval.evaluate_cuda.launches = 0
    cuda_eval.evaluate_cuda_culled.launches = 0
    t0 = time.perf_counter()
    d = Deformer.fit(rest, deformed, DeformConfig(), DeformParams(), device=dev)
    auto_pts, auto_w = d.apply(pts)
    dense_pts, dense_w = d.apply(pts, backend="cuda")
    d_loc = Deformer.fit(cap, cap_def, DeformConfig(), DeformParams(), device=dev)
    loc_pts, _ = d_loc.apply(pts)
    gated_pts, gated_w = d.apply(pts, dist2=cap_d2, backend="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"dense": cuda_eval.evaluate_cuda.launches,
                "culled": cuda_eval.evaluate_cuda_culled.launches}
    print(f"main path: {wall:.3f} s wall (2 fits, 4 applies at {pts.shape[0]} "
          f"verts); launches {launches}  [{label}]", flush=True)
    _check(launches["culled"] > 0, "apply('auto') did not launch the culled kernel")
    _check(launches["dense"] > 0, "apply(backend='cuda') did not launch the dense kernel")

    for name, rep in (("fit@1k", d.report), ("fit@4k localized", d_loc.report)):
        be = float(rep.backward_error())
        print(f"{name}: backward error {be:.3e} (cond est {float(rep.cond_est):.3e})")
        _check(be <= BACKWARD_TOL, f"{name} backward error {be:.3e} > {BACKWARD_TOL:g}")
    for name, out in (("auto", auto_pts), ("cuda", dense_pts), ("localized", loc_pts),
                      ("gated", gated_pts)):
        _check(tuple(out.shape) == (pts.shape[0], 3) and bool(torch.isfinite(out).all()),
               f"{name} output not finite of shape (V, 3)")
    _check(bool((auto_w == 1).all()) and bool((dense_w == 1).all()),
           "uncaptured vertices must deform fully")
    culled_vs_dense = float(torch.max(torch.abs(auto_pts - dense_pts)))
    print(f"culled vs dense kernel at 1M x 1k: max |d| {culled_vs_dense:.3e}")
    _check(culled_vs_dense <= POS_TOL_DECAYING, "culled and dense kernels disagree")

    # capture gating: inactive vertices stay put; active ones match the
    # plain version with the same falloff
    inactive = gated_w == 0
    frac = 1.0 - float(inactive.float().mean())
    _check(bool(torch.equal(gated_pts[inactive], pts[inactive])),
           "inactive vertices moved")
    params = d.params.clamped()
    ref_pts, ref_w = cuda_eval.evaluate_reference(
        d.model, pts, cap_d2, torch.ones_like(cap_d2), params.radius,
        params.falloffrate, effective_kernel(d.cfg), d.cfg.term)
    g_err = float(torch.max(torch.abs(gated_pts - ref_pts)))
    print(f"capture-gated: {frac * 100:.1f}% active, max |d| vs plain {g_err:.3e}")
    _check(g_err <= POS_TOL_DECAYING and float(torch.max(torch.abs(gated_w - ref_w)))
           <= FALLOFF_TOL, "capture-gated output disagrees with the plain version")

    # float64 oracle on a 4096-vertex subset spread over the sphere
    idx = torch.linspace(0, pts.shape[0] - 1, 4096, device=dev).long()
    errs = {}
    for name, (r, dfm, out) in {
        "1M x 1k auto": (rest, deformed, auto_pts),
        "1M x 1k cuda": (rest, deformed, dense_pts),
        "localized 4k auto": (cap, cap_def, loc_pts),
    }.items():
        want = _oracle_disp(torch.as_tensor(r, device=dev), torch.as_tensor(dfm, device=dev),
                            pts[idx])
        errs[name] = float(torch.max(torch.abs((out[idx] - pts[idx]).double() - want)))
        print(f"oracle ({name}, 4096-vertex subset): max displacement error "
              f"{errs[name]:.3e} (budget {ORACLE_BUDGET:g})")
        _check(errs[name] <= ORACLE_BUDGET, f"{name} misses the oracle budget")
    return {"launches": launches, "model": d.model, "points": pts,
            "culled_vs_dense": culled_vs_dense}


def _sphere_frame(pts):
    """Tangent frame (u, v, n) of the unit UV sphere at its points: u along
    increasing longitude, v = n x u, n radial."""
    n = pts / torch.linalg.norm(pts, dim=-1, keepdim=True)
    lon = torch.atan2(pts[:, 2], pts[:, 0])
    u = torch.stack([-torch.sin(lon), torch.zeros_like(lon), torch.cos(lon)], -1)
    v = torch.linalg.cross(n, u)
    return u.contiguous(), v.contiguous(), n.contiguous()


def _project64(frame, disp):
    """The reference's oblique tangent projection in float64."""
    u, v, n = (f.double() / torch.linalg.norm(f.double(), dim=-1, keepdim=True)
               for f in frame)

    def dot_b(x):
        return ((x * u).sum(-1, keepdim=True) * u + (x * v).sum(-1, keepdim=True) * v
                + (x * n).sum(-1, keepdim=True) * n)

    a1, a2 = dot_b(u), dot_b(v)
    a1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True)
    a2 = a2 / torch.linalg.norm(a2, dim=-1, keepdim=True)
    return a1 * (disp * a1).sum(-1, keepdim=True) + a2 * (disp * a2).sum(-1, keepdim=True)


def main_path_frames(dev, label: str) -> dict:
    """Phase 5: slice B's main path, the animated shot at full width: 1M
    vertices x 1000 controls x 8 frames, with launch counters."""
    from facedeform_tpu_torch import DeformConfig, DeformParams, Deformer
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points, uv_sphere
    from facedeform_tpu_torch.ops import cuda_eval, cuda_jacobian, temporal
    from facedeform_tpu_torch.ops import jacobian as jac_mod
    from facedeform_tpu_torch.ops.fit import effective_kernel
    from facedeform_tpu_torch.parallel import batched
    from facedeform_tpu_torch.utils import errors

    rng = np.random.default_rng(0)
    n_ctrl, n_frames = 1000, 8
    rest = fibonacci_points(n_ctrl)
    raw = np.stack([rest + 0.05 * rng.standard_normal((n_ctrl, 3)).astype(np.float32)
                    for _ in range(n_frames)])
    frames = temporal.smooth_frames(raw, window=5)
    cfg = DeformConfig(tangent=True)       # default solve; tangent-projected eval
    params = DeformParams()
    pts = torch.as_tensor(uv_sphere(1000, 1000).points, device=dev)
    v = pts.shape[0]
    cap_d2 = torch.sum((pts - torch.tensor([0.0, 1.0, 0.0], device=dev)) ** 2, -1)
    gate = torch.ones(v, device=dev)
    frame = _sphere_frame(pts)

    counters = (cuda_eval.evaluate_cuda_frames, cuda_jacobian.jacobian_cuda,
                cuda_jacobian.jacobian_cuda_frames)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    model, resid = batched.fit_frames(rest, frames, cfg, params, device=dev)
    errors.check_frames(resid, rest, frames)
    out, w = batched.apply_frames(model, pts, cap_d2, gate, cfg, params, frame=frame)
    normals, stretch = batched.transport_frames(
        model, pts, (frame[2],), w, cfg, ("normal",), frame=frame, want_stretch=True)
    d0 = Deformer.fit(rest, frames[0], cfg, params, device=dev)
    jac0 = d0.jacobian(pts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"slice B main path: {wall:.3f} s wall (fit_frames of {n_frames} poses x "
          f"{n_ctrl} controls, apply_frames + transport_frames at {v} verts, "
          f"Deformer.jacobian); launches {launches}  [{label}]", flush=True)
    _check(launches["evaluate_cuda_frames"] > 0, "apply_frames did not launch the frames kernel")
    _check(launches["jacobian_cuda_frames"] > 0,
           "transport_frames did not launch the Jacobian kernel")
    _check(launches["jacobian_cuda"] > 0, "Deformer.jacobian did not launch the Jacobian kernel")

    print(f"fit_frames residual norms: max {float(resid.max()):.3e} (route: "
          f"{'per-pose' if model.w_rbf_lo is not None else 'shared factorization'})")
    _check(tuple(out.shape) == (n_frames, v, 3) and bool(torch.isfinite(out).all()),
           "apply_frames output not finite of shape (F, V, 3)")
    want_w = torch.clamp(1.0 - torch.clamp(cap_d2, max=1.0), min=0.0)  # radius 1, rate 1
    _check(float(torch.max(torch.abs(w - want_w))) <= FALLOFF_TOL, "apply_frames falloff")
    nrm_len = torch.linalg.norm(normals, dim=-1)
    _check(tuple(normals.shape) == (n_frames, v, 3)
           and float(torch.max(torch.abs(nrm_len - 1.0))) <= 1e-5,
           "transported normals not unit length")
    # a 0.05-noise rig on 0.11-spaced markers compresses some vertices to
    # near-singular F, so the smallest stretch may round to 0
    _check(tuple(stretch.shape) == (n_frames, v, 3) and bool(torch.isfinite(stretch).all())
           and bool((stretch >= 0).all()), "principal stretches not finite and >= 0")
    _check(tuple(jac0.shape) == (v, 3, 3) and bool(torch.isfinite(jac0).all()),
           "Deformer.jacobian output not finite of shape (V, 3, 3)")

    # each frame against the single-pose kernel path on a 4096-vertex subset
    idx = torch.linspace(0, v - 1, 4096, device=dev).long()
    sub_frame = tuple(f[idx] for f in frame)
    worst = 0.0
    for f in range(n_frames):
        d = d0 if f == 0 else Deformer.fit(rest, frames[f], cfg, params, device=dev)
        single, single_w = d.apply(pts[idx], dist2=cap_d2[idx], frame=sub_frame,
                                   backend="cuda")
        worst = max(worst, float(torch.max(torch.abs(out[f, idx] - single))))
        _check(bool(torch.equal(single_w, w[idx])), f"frame {f}: falloff differs")
    print(f"frames vs single-pose Deformer.apply(backend='cuda'), 4096-vertex subset: "
          f"max |d| {worst:.3e} (tol {FRAME_VS_SINGLE_TOL:g})")
    _check(worst <= FRAME_VS_SINGLE_TOL, "a frame disagrees with the single-pose path")

    # two frames against the float64 oracle (fit, eval, projection, falloff)
    for f in (0, n_frames - 1):
        disp = _oracle_disp(torch.as_tensor(rest, device=dev),
                            torch.as_tensor(frames[f], device=dev), pts[idx])
        want = _project64(sub_frame, disp) * want_w[idx].double()[:, None]
        err = float(torch.max(torch.abs((out[f, idx] - pts[idx]).double() - want)))
        print(f"oracle (frame {f}, 4096-vertex subset): max displacement error "
              f"{err:.3e} (budget {ORACLE_BUDGET:g})")
        _check(err <= ORACLE_BUDGET, f"frame {f} misses the oracle budget")

    # transported normals of frame 0 against the plain Jacobian's
    plain = jac_mod.transport_normals(
        jac_mod.displacement_jacobian(cuda_eval.frame_model(model, 0), pts[idx],
                                      effective_kernel(cfg), cfg.term),
        frame[2][idx], w[idx], cfg, sub_frame)
    # a normal's error grows as 1 / sigma_min(F) (the cofactor rule
    # re-normalizes cof(F) n), so it is held to the bound scaled by it
    sigma_min = torch.clamp(stretch[0, idx].amin(-1), max=1.0)
    diff = torch.abs(normals[0, idx] - plain).amax(-1)
    t_err = float(torch.max(diff * sigma_min))
    print(f"transported normals vs plain Jacobian, frame 0 subset: max |d| * "
          f"min(1, sigma_min) {t_err:.3e} (tol {TRANSPORT_TOL:g}), max |d| "
          f"{float(diff.max()):.3e}; stretches in [{float(stretch.min()):.4f}, "
          f"{float(stretch.max()):.4f}]")
    _check(t_err <= TRANSPORT_TOL, "transported normals disagree with the plain path")
    return {"launches": launches, "model": model, "rest": rest, "frames": frames,
            "points": pts, "cfg": cfg, "params": params}


def time_kernels(main: dict, label: str) -> list:
    """Phase 5a: each kernel and the plain version at the main path's
    shapes (1M verts x 1k controls, all active)."""
    from facedeform_tpu_torch.benchmark import stats, time_cuda
    from facedeform_tpu_torch.config import PolyTerm, RBFKernel
    from facedeform_tpu_torch.ops import cuda_eval

    model, pts = main["model"], main["points"]
    v = pts.shape[0]
    d2 = torch.zeros(v, device=pts.device)
    gate = torch.ones(v, device=pts.device)
    args = (model, pts, d2, gate, 1.0, 1.0, RBFKernel.GAUSSIAN, PolyTerm.LINEAR)
    fns = {
        "dense": lambda: cuda_eval.evaluate_cuda(*args),
        "culled": lambda: cuda_eval.evaluate_cuda_culled(*args),
        "plain": lambda: cuda_eval.evaluate_reference(*args),
    }
    times = {k: stats(t) for k, t in time_cuda(fns).items()}
    want, _ = cuda_eval.evaluate_reference(*args)
    errs = {k: float(torch.max(torch.abs(fns[k]()[0] - want))) for k in ("dense", "culled")}
    for k, (best, med, spread) in times.items():
        print(f"time {k}: {best:.4f} ms best, {med:.4f} median, spread "
              f"{spread * 100:.1f}% at {v} x {model.ctrl.shape[0]}  [{label}]")
    src = "facedeform_tpu_torch/csrc/eval.cu"
    return [
        {"name": "eval_dense", "route": "cuda", "source": src,
         "replaces": "facedeform_tpu/ops/pallas_eval.py:349",
         "launches": main["launches"]["dense"], "max_abs_err": errs["dense"],
         "ms": times["dense"][0], "plain_ms": times["plain"][0]},
        {"name": "eval_culled", "route": "cuda", "source": src,
         "replaces": "facedeform_tpu/ops/pallas_eval.py:868",
         "launches": main["launches"]["culled"], "max_abs_err": errs["culled"],
         "ms": times["culled"][0], "plain_ms": times["plain"][0]},
    ]


def _fmt(name, t, extra=""):
    best, med, spread = t
    return f"time {name}: {best:.4f} ms best, {med:.4f} median, spread {spread * 100:.1f}%{extra}"


def time_frames(main_b: dict, label: str) -> list:
    """Phase 6b: the frames and Jacobian kernels against their plain twins
    at the slice B main path's shapes (1M verts x 1k controls), F = 8, 11,
    16, 17, 32 per frame through apply_frames, and both fit_frames routes at
    (1k controls, F = 8) and (4k, F = 32)."""
    from facedeform_tpu_torch.benchmark import stats, time_cuda
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points
    from facedeform_tpu_torch.ops import cuda_eval, cuda_jacobian
    from facedeform_tpu_torch.ops import fit as fit_mod
    from facedeform_tpu_torch.ops.fit import RBFModel, effective_kernel
    from facedeform_tpu_torch.ops.jacobian import displacement_jacobian
    from facedeform_tpu_torch.parallel import batched

    model, pts, cfg, params = (main_b[k] for k in ("model", "points", "cfg", "params"))
    dev = pts.device
    v, n_frames = pts.shape[0], model.w_rbf.shape[0]
    kernel, term = effective_kernel(cfg), cfg.term
    d2 = torch.zeros(v, device=dev)
    gate = torch.ones(v, device=dev)
    args = (model, pts, d2, gate, 1.0, 1.0, kernel, term)
    singles = [cuda_eval.frame_model(model, f) for f in range(n_frames)]
    fns = {
        "frames": lambda: cuda_eval.evaluate_cuda_frames(*args),
        "dense x8": lambda: [cuda_eval.evaluate_cuda(m, *args[1:]) for m in singles],
        "frames plain": lambda: cuda_eval.evaluate_frames_reference(*args),
    }
    t = {k: stats(x) for k, x in time_cuda(fns, iters={
        "frames": 10, "dense x8": 10, "frames plain": 2}).items()}
    want, _ = cuda_eval.evaluate_frames_reference(*args)
    err_frames = float(torch.max(torch.abs(fns["frames"]()[0] - want)))
    for k, x in t.items():
        print(_fmt(k, x, f" at {v} x {model.ctrl.shape[0]} x {n_frames} frames  [{label}]"))
    print(f"frames kernel vs 8 dense launches: {t['dense x8'][0] / t['frames'][0]:.3f}x; "
          f"vs plain twin {t['frames plain'][0] / t['frames'][0]:.2f}x; max |d| vs twin "
          f"{err_frames:.3e}")

    # F = 8, 11, 16, 17, 32 through apply_frames: a cliff at the 16-frame chunk?
    rng = np.random.default_rng(3)
    rest = main_b["rest"]
    more = rest + 0.05 * rng.standard_normal((32,) + rest.shape).astype(np.float32)
    model32, _ = batched.fit_frames(rest, more, cfg, params, device=dev)
    for nf in (8, 11, 16, 17, 32):
        sub = RBFModel(ctrl=model32.ctrl, w_rbf=model32.w_rbf[:nf],
                       w_poly=model32.w_poly[:nf], eps=model32.eps)
        ms = stats(time_cuda({"apply": lambda: batched.apply_frames(
            sub, pts, d2, gate, cfg, params)}, iters=5)["apply"])
        print(_fmt(f"apply_frames F={nf}", ms,
                   f"; {ms[0] / nf:.4f} ms per frame  [{label}]"))

    # Jacobian: single entry and F = 8 against the plain displacement_jacobian
    one = singles[0]
    jfns = {
        "jacobian": lambda: cuda_jacobian.jacobian_cuda(one, pts, kernel, term),
        "jacobian F=8": lambda: cuda_jacobian.jacobian_cuda_frames(model, pts, kernel, term),
        "jacobian plain": lambda: displacement_jacobian(one, pts, kernel, term),
        "jacobian plain F=8": lambda: cuda_jacobian.jacobian_frames_reference(
            model, pts, kernel, term),
    }
    jt = {k: stats(x) for k, x in time_cuda(jfns, iters={
        "jacobian": 10, "jacobian F=8": 10, "jacobian plain": 2,
        "jacobian plain F=8": 1}).items()}
    want_j = cuda_jacobian.jacobian_frames_reference(model, pts, kernel, term)
    err_jac = float(torch.max(torch.abs(jfns["jacobian F=8"]() - want_j)))
    err_jac1 = float(torch.max(torch.abs(jfns["jacobian"]() - want_j[0])))
    for k, x in jt.items():
        print(_fmt(k, x, f" at {v} x {model.ctrl.shape[0]}  [{label}]"))
    print(f"jacobian max |dJ| vs plain: F=8 {err_jac:.3e}, single {err_jac1:.3e} "
          f"(max |J| {float(want_j.abs().max()):.3e})")

    # both fit_frames routes
    for n_ctrl, nf in ((1000, 8), (4096, 32)):
        r = fibonacci_points(n_ctrl)
        fr = r + 0.05 * rng.standard_normal((nf, n_ctrl, 3)).astype(np.float32)
        r_dev, fr_dev = torch.as_tensor(r, device=dev), torch.as_tensor(fr, device=dev)
        routes = {
            "per-pose": lambda: fit_mod.fit_frames_per_pose(r_dev, fr_dev, cfg, params),
            "shared": lambda: fit_mod.fit_frames_dense(r_dev, fr_dev, cfg, params),
        }
        small = n_ctrl <= 1000
        rt = {k: stats(x) for k, x in time_cuda(
            routes, rounds=5 if small else 3, iters=10 if small else 1).items()}
        rows = n_ctrl + cfg.n_poly
        chosen = ("shared" if batched._vmap_fit_bytes(rows, nf) > batched.vmap_fit_hbm_budget
                  else "per-pose")
        for k, x in rt.items():
            print(_fmt(f"fit_frames {k} route", x,
                       f" at {n_ctrl} controls x {nf} frames  [{label}]"))
        print(f"fit_frames at {n_ctrl} x {nf}: routing picks {chosen} "
              f"({batched._vmap_fit_bytes(rows, nf) / 1e9:.3f} GB estimated vs budget "
              f"{batched.vmap_fit_hbm_budget / 1e9:g} GB)")
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        fit_mod.fit_frames_per_pose(r_dev, fr_dev, cfg, params)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        print(f"fit_frames per-pose route peak device memory at {n_ctrl} x {nf}: "
              f"{peak / 1e9:.3f} GB (estimate {batched._vmap_fit_bytes(rows, nf) / 1e9:.3f} GB)")

    return [
        {"name": "eval_frames", "route": "cuda",
         "source": "facedeform_tpu_torch/csrc/frames.cu",
         "replaces": "facedeform_tpu/ops/pallas_eval.py:616",
         "launches": main_b["launches"]["evaluate_cuda_frames"], "max_abs_err": err_frames,
         "ms": t["frames"][0], "plain_ms": t["frames plain"][0]},
        {"name": "jacobian", "route": "cuda",
         "source": "facedeform_tpu_torch/csrc/jacobian.cu",
         "replaces": "facedeform_tpu/ops/pallas_jacobian.py:160",
         "launches": main_b["launches"]["jacobian_cuda"]
         + main_b["launches"]["jacobian_cuda_frames"],
         "max_abs_err": max(err_jac, err_jac1),
         "ms": jt["jacobian F=8"][0], "plain_ms": jt["jacobian plain F=8"][0]},
    ]


def _ptxas_summary(log: str) -> list:
    """One line per compiled kernel: name<template args>, registers, spills."""
    lines, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            base = re.search(r"([a-z]+_kernel)I", m.group(1))
            args = re.findall(r"L[ib](\d+)E", m.group(1))
            name = f"{base.group(1) if base else m.group(1)}<{','.join(args)}>"
            spill = ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line)
            lines.append(f"{name}: {regs.group(1) if regs else '?'} registers, {spill}")
            name = None
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU only",
              file=sys.stderr)
        return 1
    from facedeform_tpu_torch import benchmark
    from facedeform_tpu_torch.ops import cuda_eval

    dev = torch.device("cuda")
    label = benchmark.device_label()
    print(label, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    log = cuda_eval.build()
    print(f"build: {time.perf_counter() - t0:.2f} s  [{label}]", flush=True)
    for line in _ptxas_summary(log):
        print("  ptxas:", line)

    check_kernels(dev)
    check_frames_kernel(dev)
    check_jacobian_kernel(dev)
    main = main_path(dev, label)
    main_b = main_path_frames(dev, label)
    kernels = time_kernels(main, label) + time_frames(main_b, label)
    record = benchmark.run_headline()
    print("headline:", json.dumps(record), flush=True)

    print(json.dumps({"kernels": kernels}))
    print(label)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
