#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on a CUDA GPU.

    python3 chip_smoke.py

1. requires a CUDA device (exits non-zero without one) and prints the
   card's name and power limit;
2. builds the hand-written CUDA eval kernels from facedeform_tpu_torch/csrc;
3. holds each kernel against its plain PyTorch version on the card:
   dense over all 7 bases, L in {1, 4}, N in {1000, 2500}, a ragged
   V = 70002, with and without a tangent frame, strict_parity both ways,
   33% capture-active plus a group gate; culled for gaussian and Wendland;
4. runs the main path at the headline size: Deformer.fit of 1000 Fibonacci
   controls (default config), apply("auto") and apply(backend="cuda") on the
   1M-vertex UV sphere, the localized 4096-control rig and the
   capture-gated run, with launch counters read around it, and checks the
   displacement against a float64 oracle on a 4096-vertex subset;
5. times fit, each kernel and the plain path (facedeform_tpu_torch.benchmark);
6. prints a kernels JSON line, the card line, and as its last line
   {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero.
"""

from __future__ import annotations

import json
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
         "replaces": "facedeform_tpu/ops/pallas_eval.py:133",
         "launches": main["launches"]["dense"], "max_abs_err": errs["dense"],
         "ms": times["dense"][0], "plain_ms": times["plain"][0]},
        {"name": "eval_culled", "route": "cuda", "source": src,
         "replaces": "facedeform_tpu/ops/pallas_eval.py:680",
         "launches": main["launches"]["culled"], "max_abs_err": errs["culled"],
         "ms": times["culled"][0], "plain_ms": times["plain"][0]},
    ]


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
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    check_kernels(dev)
    main = main_path(dev, label)
    kernels = time_kernels(main, label)
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
