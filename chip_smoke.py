#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on a CUDA GPU.

    python3 chip_smoke.py

1. requires a CUDA device (exits non-zero without one) and prints the
   card's name and power limit;
2. builds the hand-written CUDA kernels from facedeform_tpu_torch/csrc (one
   nvcc per source, started together) and prints ptxas' register and
   spill counts per kernel;
3. holds each kernel against its plain PyTorch version on the card, all 7
   bases, a ragged V = 70002, with and without a tangent frame:
   - dense and culled eval: L in {1, 2, 3, 4, 6} (every layer count the
     kernels instantiate, 6 through the run-time-L kernel), N in {1000,
     2500, 1003} (1003 not a multiple of the pair loop's unroll),
     strict_parity both ways, 33% capture-active plus a group gate
     (culled for gaussian and Wendland; growing kernels with a LINEAR tail,
     centered, and a ZERO tail, uncentered);
   - the eval kernels' packing on the card (control_records,
     culled_tables) bit-equal to the plain twins and the slab table to the
     JAX package's, N in {100, 1000, 1003, 4096}, L in {1, 3, 6}, tails of
     0, 1 and 4 rows;
   - frames eval: F in {1, 2, 3, 8, 9, 11, 16, 17, 19, 32, 33} (every n8
     tile count the kernel instantiates; 33 = two balanced launches of 17
     and 16) at N in {1000, 2500, 1003} and L in {1, 4}, a 33%-active
     folded weight, every frame of every launch bit-equal to the same frame
     of the 33-frame shot, and its packing kernel (frames_stream) bit-equal
     to the plain twin;
   - Jacobian: single entry and F in {2, 3, 4, 8, 9} (every frames block
     NT in {1, 2, 3}; 9 crosses the 8-frame launch chunk) at N in
     {1000, 2500, 1003}, every frame of the F = 8 launch against its
     single-pose launch, plus a float64 central-difference check of J on
     64 vertices;
   - float64 precise eval: L in {1, 3}, strict_parity both ways, 33%
     capture-active plus a group gate, lo words present and absent, plus
     fitted TPS/MQ/linear/cubic models on which the f32 dense kernel must
     miss the bound (so the bound tells float64 from f32); its frames
     launches, TPS/MQ/linear/cubic x L in {1, 3} x lo words present and
     absent x F in {1, 2, 4, 8, 9} (9 crosses the 8-frame launch chunk),
     every frame equal to its single-pose launch bit for bit; its table-
     driven thin-plate log against float64 torch.log over [5e-324, 9e307]
     (4 ulp where |log s| >= 1, 4 x 2^-52 elsewhere);
   - the custom-VJP eval (dense kernel forward, plain backward): gradients
     w.r.t. w_rbf and points at 65536 x 1000, gaussian and TPS;
   - the partition-of-unity tile kernel on fitted 3000-control rigs: TPS,
     gaussian, MQ and Wendland x LINEAR, CONSTANT and ZERO tails, F in {1,
     2, 3, 4, 8, 16, 17} (every NT in {0, 1, 2, 3, 6}), far points
     (nearest-patch fallback) and coverage-shell points, every frame of the
     F = 16 launch against its single-pose launch, a rig with ragged patch
     widths, a single-patch rig, and one case against the plain f32
     evaluate_pu;
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
   two frames against a float64 oracle, the Jacobian kernel against its
   plain twin (on the subset and over all 1M) and a float64 Jacobian;
6. runs slice C's main path, growing kernels at full width: TPS and MQ
   Deformer.fit of 4096 Fibonacci controls (float64 assembly, GMRES-IR)
   and apply("auto") on the 1M-vertex sphere with a capture d2, a tangent
   frame and a group gate (one precise launch each), a 4-pose TPS shot
   through batched.fit_frames + apply_frames (ceil(4 / 8) = 1 precise
   frames launch) and one gradient through the custom-VJP eval, with
   launch counters read around it; each apply's whole output, each shot
   frame and the gradient against their plain twins, displacements
   against a float64 solve of the same systems, each shot frame against
   its single-pose launch (bit for bit) and the single-pose precise path;
   the shot refitted through the forced shared-factorization route, equal
   to the per-pose route's model bit for bit and within the budget of the
   float64 oracle;
6b. runs slice F's main path, partition-of-unity rigs (the JAX package's
   benchmark configs 9 and 10): PUDeformer.fit of 30k TPS controls and
   displacement on the 1M-vertex sphere (one PU launch) and at the
   controls, the whole output against the plain twin and the float64 plain
   tiles, the Jacobian against a float64 central difference; then a
   20k-control x 8-pose PUSeqDeformer: displacement_frames and apply_seq
   (capture d2, gate, tangent frame), one launch each, every frame against
   its single-pose kernel run, the shot against the twin;
6c. holds the Krylov route (solver="krylov") against the dense fit at 2000
   and 4096 controls for QNN (GMRES), KERNEL-gaussian and multilayer L3
   (block-Jacobi PMINRES) and TPS (|.|-block-Jacobi PMINRES), fields on a
   4096-point shell at the JAX package's Krylov tolerance (TPS: within
   1.5x the JAX route's own distance from the dense field on the same
   2000-control rig; at 4096 printed), each fit's health at its route's
   threshold, printing each fit's sweeps (iterations, matvecs) and walls;
6d. runs the large-rig main path: Fibonacci rigs through Deformer.fit with
   solver "auto" (QNN at 25k -> GMRES, KERNEL-gaussian at 50k -> PMINRES,
   TPS at 16k -> |.|-block-Jacobi PMINRES) and apply("auto") on the 1M
   sphere (the culled kernel, the precise kernel), each apply on a
   4096-vertex subset against its kernel's plain twin and a float64 dense
   solve of the same saddle system on the card (held to the Krylov
   tolerance for QNN and gaussian; TPS's distance printed, its backward
   error checked); a 4-pose TPS shot at 16k through fit_frames ->
   check_frames (the Krylov-CPD route) -> apply_frames (one precise frames
   launch), every frame's model equal to its single fit; launch counters
   read around it; per rig the preconditioner's setup, the fit's wall,
   iterations per sweep, the backward error and the matvec's time an
   iteration; then the dense route's fit at 8192 and 16384 controls
   against the Krylov route's (QNN and TPS: the crossover);
6e. runs the interactive-drag main path: the default config at 1000
   controls, Deformer.fit_with_plan, then 16 marker drags through
   plan.refit + apply on the 1M sphere (the culled kernel), each refit
   model equal to Deformer.fit of its pose bit for bit; a TPS plan at 4096
   controls (GMRES-IR against stored factors, the precise kernel) the same
   way; refit against fit in CUDA-event ms; then apply(spatial_perm=)
   against the natural order of a randomly permuted 1M sphere, with the
   Morton sort and the 1M-row gather timed alone;
8. runs the capture chain, the reference SOP's cook order at the main
   path's mesh (1,000,002 vertices): 8a capture with the main path's 1000
   Fibonacci markers (class = octant, maxedges 32, radius 0.1), dofalloff
   euclidean to points, to triangles (the markers' convex hull, 1996
   triangles) and geodesic; dist2 against a float64 brute force on the
   card, the native geodesic against scipy's dijkstra, the native flood's
   islands against the numpy fallback's, the native library required;
   8b Deformer.fit (default config, 1000 controls, falloff radius 0.05,
   under the markers' covering radius) and apply(dist2=) on "auto"
   (culled) and backend="cuda" (dense), and again with a group_mask parsed
   by grouppattern ("captured ^south"), against the plain twin; vertices
   beyond the radius must exist and have no weight, and inactive and
   off-group vertices stay unmoved bit for bit; 8c DBSE with 52
   bump blendshapes: lstsq and robust weights (2% outliers) recover known
   weights, parity weights against a float64 twin (the host packed QR
   timed on a subset first and the parity route cut to the largest vertex
   count under 30 s of it), lstsq batched over slice B's 8-pose shot
   against per-frame calls, morph_apply on 8b's gated output against its
   float64 formula; 8d the bake of that shot (fit_blendshapes, rank 8)
   against a float64 eigh, blendshape_meshes -> build_model giving back its
   weight curves; 8e select_markers of 2000 from 50,000 (the residual
   trace falling with k), reduce_rig, fit_reduced -> a reduced Deformer
   applied at 1M, and loocv.autotune at 2000 controls with its Rippa
   errors against 20 float64 leave-one-out refits on the card; launch
   counters read around it (#1 and #2 must run);
9. runs the node's cook, FaceDeformNode.cook, at phase 8's width (the 1M
   sphere, 1000 markers in 8 classes, 52 blendshapes): 9a a cold cook
   (capture, dofalloff, morphspace lstsq, update_normals,
   transform_attrs=["v"], output_stretch), a warm cook and 16 drag cooks
   (FitPlan refit), each cook's wall and stage split printed with the
   dense/culled autotune's choice and timings; 9b symmetrize="x" with
   pose-space deformation over 4 example poses and a cook at a fifth;
   9c solver="pu" at 30k controls, cold and warm; 9d a TPS cook at 4096
   controls; 9e two secondary meshes with recompute_normals; launch
   counters read around the cooks (#1, #2, #5, #6 and #7 must run); then
   a drag cook against a fresh node's cook of its pose, the RBF pass
   against Deformer.apply on the autotune's backend bit for bit, the
   transported N against the plain Jacobian route on 65536 vertices, a
   PSD cook at an example pose against its sculpt, the card's cook
   against the CPU's at 1602 vertices, and profiles of a warm and a drag
   cook;
10. runs the rig export and rig tools at phase 9's width: 10a the
   skinning bake (an 8-pose sweep cooked through the node,
   fit_skinning with 16 bones and 4 influences, with edges and again
   with smooth_lambda 0.1, the stage split and peak device memory, a
   rigid-cluster sweep recovered to 1e-4 of the bbox, lbs_apply against
   float64); 10b glTF (the skinned bake, the 1M mesh, the 52 shapes as
   morph targets, the 8 cooked frames: walls, sizes, round trips); 10c
   checkpoints of every kind (dense, TPS with lo words, dense sequence,
   PU 30k, PU sequence 20k x 8, PSD, skin, shapes), each reload
   bit-equal through the same kernel (#1/#2, #5, #3, #7) and a node cook
   from reloaded deformer and PSD files equal to the in-memory one; 10d
   inverse rig fits (the closed form at 1000 markers from a 20000-vertex
   subsample, recovered to 5e-3; the card's gradient route against the
   CPU's with a nonzero dist2, without and with a tangent frame, the
   first 5 Adam iterates within 1e-5; the 2-layer gradient path, 150
   Adam steps through the custom-VJP eval #4, below 0.2 of its start);
   10e the doctor at 1M with 8 posed rigs; 10f the Houdini adapter on
   tests/mock_hou.py, cold and warm, its P and fd_falloff bit-equal to
   a direct cook of the original meshes on a node of its own; launch
   counters read around it (#1, #2, #3, #4, #5 and #7 must run);
11. times fit, each kernel and its plain version (the dense and culled
   kernels also alone, by the profiler, and the culled kernel's computed
   against needed pairs), the frames kernel (also alone, by the profiler,
   and its packing kernel against its twin) against 8 dense launches,
   apply_frames at F = 8/11/16/17/32/33 per frame, both fit_frames routes,
   the precise kernel against its plain twin and the f32 dense kernel at
   1M x 4096 and 1M x 1000, its frames launch against 4 and 8 single-pose
   launches at 1M x 4096 in the same rounds, its single-pose launch per
   basis (TPS/MQ/linear/cubic), the float64-route fits at 4096 and the
   custom-VJP eval's forward + backward, the PU kernel against its twin at
   1M x 30k and 1M x 20k x 8 frames with the pairs it computes against
   the pairs it needs, the PU fits and host plan builds, and profiles of
   the 30k PU fit and the PU kernel (facedeform_tpu_torch.benchmark);
12. prints a kernels JSON line (per kernel its time, its plain version's,
   its bound from this run's inputs and which of bytes or operations binds
   it, the launches of phases 6d, 6e, 8, 9 and 10 by path, library_ms null: no single PyTorch call computes an RBF or PU
   field; the dense and culled kernels also their time alone, the culled
   kernel the pairs it computed, counted on the card, over the pairs it
   needs; the frames kernel its time alone, the larger of its tensor-core
   and CUDA-core bounds and the scalar kernel's CUDA-core formula; the eval
   and frames packing kernels beside them), the card line, and as its last
   line
   {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero.  Parts alone (no
final record): --precise-bases times the precise kernel per basis,
--pu-jac the PU and Jacobian kernels, --eval the dense and culled eval
kernels and --frames the frames eval kernel (1M x 1k x 8 and F = 1, 2, 16,
17, 32; apply_frames per frame at F = 8 to 33) at their main-path shapes,
each through entry points a parent commit has too, so that a parent
checkout (the script copied into it) is timed by the same code; --krylov
runs phases 6c, 6d and 6e alone, --capture phase 8 alone, --node phase 9
alone, --export phase 10 alone, --skin-bases phase 10a's fit_skinning with
its per-frame bases kept against recomputed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import sys
import time

import numpy as np
import torch

from facedeform_tpu_torch.ops import cuda_solve
from facedeform_tpu_torch.utils import profiling

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
# float64 precise kernel vs its float64 plain twin: both sum in double and
# round once, so positions differ by about an f32 ulp of disp * weight
PRECISE_POS_TOL = 2e-6
# evaluate_cuda_diff gradients vs autograd through the plain twin, max|dg|
# / max|g| (the JAX package's rtol; the cotangents differ by the forward's
# f32 rounding)
GRAD_RTOL = 1e-4
# growing-kernel shot frames vs single-pose precise applies: one
# factorization and one GMRES per pose in both, the same kernel
SHOT_VS_SINGLE_TOL = 1e-6
# PU tile kernel vs its plain twin, relative to max|disp|: both take exact
# f32 differences and the same phi, the contraction sums in another order
# (sequential FMAs vs a batched matmul); on a 3000-control rig the twin's
# own f32 noise against float64 reaches 2.8e-6 of max|disp| (TPS, CPU
# probe), so two orders may differ by about twice that
PU_TOL = 1e-5
# PU kernel vs the plain f32 evaluate_pu (d2 by the expansion identity),
# absolute: the JAX package's bound for Mosaic vs XLA (tests/test_pu.py)
PU_PLAIN_TOL = 1e-5
# f32 kernel vs the float64 plain tiles on an eps="auto" fit, absolute:
# the JAX package's f32-vs-double-float bound (tests/test_pu.py)
PU_F64_TOL = 5e-6
PU_BACKWARD_TOL = 1e-9    # PU fit health (tests/test_pu.py)
# PU Jacobian (plain f32) vs a float64 central difference (h = 1e-5) of
# the float64 field, relative to max|J|: 9e-6 measured on a 3000-control
# TPS rig (CPU probe)
PU_JAC_FD_TOL = 1e-4
# frames per PU check launch: every NT in {0, 1, 2, 3, 6}, 17 = 16 + 1
PU_CHECK_FRAMES = (1, 2, 3, 4, 8, 16, 17)
# the bump centers of slice F's 8-pose shot (the JAX package's config 10)
PU_SHOT_CENTERS = ((0, 1, 0), (1, 0, 0), (0, 0, 1), (0, -1, 0), (-1, 0, 0), (0, 0, -1),
                   (0.7, 0.7, 0), (0, 0.7, 0.7))
# host-clock rounds of the PU fits and host builds: their walls vary with
# the shared host, so the medians of interleaved rounds are what to read
PU_WALL_ROUNDS = 7
# A Krylov field against the dense or float64 one, err <= a + b * scale
# with scale the reference field's max |disp|.  Decaying kernels converge
# to the solvers' 1e-7: the JAX package's bound (tests/test_krylov.py).
KRYLOV_TOL_DECAYING = (5e-5, 1e-3)
# CPD kernels (TPS) stop at the f32 Krylov floor, which the JAX package
# documents as percent-level (a true relative residual of 4.9e-2 at 16k TPS
# controls, its docs/PERFORMANCE.md), and which grows with N: the JAX
# test's 5e-3 of scale holds up to ~1000 controls, but on phase 6c's
# 2000-control TPS rig the JAX route's own field sits 4.2247e-2 of scale
# from the dense field (facedeform_tpu on the CPU, measured again by
# tests/test_torch_krylov.py).  So the port's field is held to that, times
# KRYLOV_CPD_VS_JAX for the rounding that two f32 implementations'
# iterates differ by, which the ill-conditioning amplifies; where no JAX
# measurement exists (4096, 16k: a full-size JAX solve is no CPU job) the
# distance is printed and the route's health, its backward error, checked.
JAX_TPS_KRYLOV_REL_ERR = {2000: 4.2247e-2}
KRYLOV_CPD_VS_JAX = 1.5
KRYLOV_CPD_BACKWARD_TOL = 1e-3   # errors.KRYLOV_CPD_BACKWARD_RTOL
# phase 6c's control counts, and the large-rig main path's rigs: QNN and
# TPS as the JAX package's benchmark configs 6 and 8 (default params, 25k;
# radius 1, lam 0.01, 16k), the gaussian KERNEL rig at 50k with a radius of
# about two control spacings
KRYLOV_PARITY_N = (2000, 4096)
LARGE_QNN_N, LARGE_GAUSS_N, LARGE_TPS_N = 25_000, 50_000, 16_384
LARGE_GAUSS_RADIUS = 0.03
# the dense route's fit timed at these counts against the Krylov route's
CROSSOVER_N = (8192, 16_384)
DRAG_N, DRAGS = 1000, 16         # phase 6e's marker drags on the default config
TPS_PLAN_N, TPS_DRAGS = 4096, 4  # and on a TPS plan

# Peak rates of one H100 SXM (NVIDIA's data sheet) for the bound_ms of the
# kernels line: f32 and fp64 outside the tensor cores, fp64 on the tensor
# cores (DMMA, IEEE fp64: the rate a contraction of many columns can
# reach), TF32 on the tensor cores (dense; the PU and Jacobian kernels'
# 3xTF32 passes), device memory.  Operations are counted per pair from each
# kernel's source, a transcendental (exp, log, sqrt) as one operation and
# an FMA as two, so the operation bound is a lower bound.
PEAK_F32 = 67e12
PEAK_F64 = 34e12
PEAK_F64_TC = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _launch_counts(fns, since: dict) -> dict:
    """Kernel launches of each wrapper in fns (the counters
    launches.<wrapper>, utils/profiling.py) since the counters read
    `since`."""
    return {fn.__name__: profiling.counter(f"launches.{fn.__name__}")
            - since.get(f"launches.{fn.__name__}", 0) for fn in fns}


def _bound(n_bytes: float, *work: tuple[float, float]) -> dict:
    """bound_ms (the larger of bytes / memory rate and the operations'
    time) and which of the two binds.  Each (operations, peak) part of
    `work` runs on its own pipe (CUDA cores, tensor cores), and the pipes
    overlap, so the operations' time is the largest part's, not the sum."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = max(n_ops / peak for n_ops, peak in work) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _pairs_within(pts, ctrl, cutoff2, chunk=65536) -> int:
    """(vertex, control) pairs with |v - c|^2 <= cutoff2[c]: the pairs a
    culled evaluation needs."""
    n = 0
    for p in torch.split(pts, chunk):
        d2 = ((p[:, None, :] - ctrl[None]) ** 2).sum(-1)
        n += int((d2 <= cutoff2[None]).sum())
    return n


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


# Phase 3's dense/culled grid: every layer count the eval kernels
# instantiate (1-4 at compile time, 6 through the run-time-L kernel) and a
# control count that is not a multiple of their unroll (1003)
EVAL_CHECK_N = (1000, 2500, 1003)
EVAL_CHECK_L = (1, 2, 3, 4, 6)


def check_kernels(dev) -> dict:
    """Phase 3: every kernel against its plain version; returns the worst
    deviations per kernel."""
    from facedeform_tpu_torch.config import PolyTerm, RBFKernel
    from facedeform_tpu_torch.geometry.primitives import uv_sphere
    from facedeform_tpu_torch.ops import cuda_eval
    from facedeform_tpu_torch.ops.fit import GROWING_KERNELS, RBFModel

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
    for n in EVAL_CHECK_N:
        for n_layers in EVAL_CHECK_L:
            for kernel in RBFKernel:
                model = _synthetic_model(n, n_layers, kernel, rng, dev)
                tol = POS_TOL_GROWING if kernel in GROWING_KERNELS else POS_TOL_DECAYING
                # (route, term, model): a growing kernel with a ZERO tail runs
                # the dense kernel without its centering pass
                routes = [("dense", PolyTerm.LINEAR, model)]
                if kernel in GROWING_KERNELS:
                    routes.append(("dense", PolyTerm.ZERO, RBFModel(
                        ctrl=model.ctrl, w_rbf=model.w_rbf, eps=model.eps,
                        w_poly=model.w_poly[:0].contiguous())))
                if cuda_eval.kernel_is_cullable(kernel):
                    routes.append(("culled", PolyTerm.LINEAR, model))
                group = {}
                for with_frame in (False, True):
                    for strict in (False, True):
                        kw = dict(strict_parity=strict,
                                  frame=frame if with_frame else None)
                        for name, term, m in routes:
                            args = (m, pts, dist2, gate, radius, rate, kernel, term)
                            want_p, want_w = cuda_eval.evaluate_reference(*args, **kw)
                            fn = (cuda_eval.evaluate_cuda_culled if name == "culled"
                                  else cuda_eval.evaluate_cuda)
                            got_p, got_w = fn(*args, **kw)
                            torch.cuda.synchronize()
                            dp = float(torch.max(torch.abs(got_p - want_p)))
                            dw = float(torch.max(torch.abs(got_w - want_w)))
                            _check(
                                dp <= tol and dw <= FALLOFF_TOL,
                                f"{name} {kernel.name} {term.name} N={n} L={n_layers} "
                                f"frame={with_frame} strict={strict}: |dpos| {dp:.3e} "
                                f"(tol {tol:g}), |dfalloff| {dw:.3e}",
                            )
                            if tol == POS_TOL_DECAYING:
                                worst[name] = max(worst[name], dp)
                            g = group.setdefault(f"{name} {term.name}", [0.0, 0.0])
                            group[f"{name} {term.name}"] = [max(g[0], dp), max(g[1], dw)]
                            n_cases += 1
                print(f"  N={n} L={n_layers} {kernel.name:20s} " + ", ".join(
                    f"{name} max|dpos| {g[0]:.3e} (tol {tol:g}) max|dfalloff| "
                    f"{g[1]:.3e}" for name, g in group.items()), flush=True)
    print(f"kernel checks: {n_cases} cases within tolerance (positions "
          f"{POS_TOL_DECAYING:g} decaying / {POS_TOL_GROWING:g} growing, "
          f"falloff {FALLOFF_TOL:g}); worst decaying |dpos| dense "
          f"{worst['dense']:.3e}, culled {worst['culled']:.3e}", flush=True)
    return worst


def check_pack_kernels(dev) -> int:
    """Phase 3a: the eval kernels' per-call packing on the card
    (control_records: pack_kernel; culled_tables: morton_kernel, argsort,
    cull_pack_kernel) equal to their plain twins bit for bit, and the
    128-slab table to culled_slabs' (the JAX package's), at N in {100,
    1000, 1003, 4096}, L in {1, 3, 6}, tails of 0, 1 and 4 rows; returns
    the cases."""
    from facedeform_tpu_torch.config import RBFKernel
    from facedeform_tpu_torch.ops import cuda_eval
    from facedeform_tpu_torch.ops.fit import RBFModel

    rng = np.random.default_rng(3)
    n_cases = 0
    for n in (100, 1000, 1003, 4096):
        for n_layers in (1, 3, 6):
            for rows in (0, 1, 4):
                for kernel in (RBFKernel.GAUSSIAN, RBFKernel.WENDLAND_C2):
                    m = _synthetic_model(n, n_layers, kernel, rng, dev)
                    m = RBFModel(ctrl=m.ctrl, w_rbf=m.w_rbf, eps=m.eps,
                                 w_poly=m.w_poly[:rows].contiguous())
                    got = cuda_eval.culled_tables(m, kernel)
                    want = cuda_eval.culled_tables_reference(m, kernel)
                    _check(all(torch.equal(g, w) for g, w in zip(got, want)),
                           f"culled_tables N={n} L={n_layers} rows={rows} {kernel.name}: "
                           "the card's tables differ from the plain twin's")
                    _check(torch.equal(got[1], cuda_eval.culled_slabs(m, kernel)[3]),
                           "the slab table differs from culled_slabs'")
                    n_cases += 1
                got = cuda_eval.control_records(m)
                want = cuda_eval.control_records_reference(m)
                _check(all(torch.equal(g, w) for g, w in zip(got, want)),
                       f"control_records N={n} L={n_layers} rows={rows}: the card's records "
                       "differ from the plain twin's")
                n_cases += 1
    print(f"packing checks: {n_cases} cases bit-equal to the plain twins", flush=True)
    return n_cases


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


# Frame counts of a shot timed through apply_frames (phase 7, --frames):
# one launch up to 32 frames, 33 = 17 + 16
FRAMES_TIMED_F = (8, 11, 16, 17, 32, 33)
# Phase 3b's frames grid: every n8 tile count of the frames kernel (1 for
# F = 1 and 2, 2 (3), 3 (8), 4 (9), 6 (11, 16), 7 (17), 8 (19), 12 (32))
# and a shot of two balanced launches (33 = 17 + 16)
FRAMES_CHECK_F = (1, 2, 3, 8, 9, 11, 16, 17, 19, 32, 33)


def check_frames_kernel(dev) -> float:
    """Phase 3b: the frames eval kernel against its plain twin on a 33%-
    active folded weight (apply_frames' call: dist2 = 0, radius = rate = 1,
    gate = the weight), every frame of every launch bit-equal to the same
    frame of the 33-frame shot, and the packing kernel bit-equal to its
    plain twin; returns the worst decaying |dpos|."""
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
    n_shot = max(FRAMES_CHECK_F)
    worst, n_cases, n_packs = 0.0, 0, 0
    for n in EVAL_CHECK_N:
        for n_layers in (1, 4):
            for kernel in RBFKernel:
                full = _frames_model(n, n_layers, n_shot, kernel, rng, dev)
                tol = POS_TOL_GROWING if kernel in GROWING_KERNELS else POS_TOL_DECAYING
                group = [0.0, 0.0]
                for with_frame in (False, True):
                    fr = frame if with_frame else None
                    # the twin is per frame: compute it once for the whole shot
                    want_p, want_w = cuda_eval.evaluate_frames_reference(
                        full, pts, zeros, fold, 1.0, 1.0, kernel, PolyTerm.LINEAR, frame=fr)
                    shot, _ = cuda_eval.evaluate_cuda_frames(
                        full, pts, zeros, fold, 1.0, 1.0, kernel, PolyTerm.LINEAR, frame=fr)
                    for n_frames in FRAMES_CHECK_F:
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
                        for f0, nf, nt in cuda_eval.frames_launch_plan(n_frames):
                            part = slice(f0, f0 + nf)
                            _check(bool(torch.equal(got_p[part], shot[part])),
                                   f"frames {kernel.name} N={n} L={n_layers} F={n_frames} "
                                   f"frame={with_frame}: frames {f0}..{f0 + nf - 1} differ "
                                   f"from the {n_shot}-frame shot's")
                            if kernel == RBFKernel.GAUSSIAN and not with_frame:
                                got_s = cuda_eval.frames_stream(model, f0, nf, nt)
                                want_s = cuda_eval.frames_stream_reference(model, f0, nf, nt)
                                _check(all(torch.equal(a, b) for a, b in zip(got_s, want_s)),
                                       f"frames packing N={n} L={n_layers} launch "
                                       f"({f0}, {nf}, {nt}) differs from its plain twin")
                                n_packs += 1
                        if tol == POS_TOL_DECAYING:
                            worst = max(worst, dp)
                        group = [max(group[0], dp), max(group[1], dw)]
                        n_cases += 1
                print(f"  frames N={n} L={n_layers} {kernel.name:20s} max|dpos| "
                      f"{group[0]:.3e} (tol {tol:g}) max|dfalloff| {group[1]:.3e}",
                      flush=True)
    print(f"frames kernel checks: {n_cases} cases within tolerance, falloff equal to "
          f"the folded weight, every launch's frames bit-equal to the {n_shot}-frame "
          f"shot's; {n_packs} packing launches bit-equal to the plain twin; worst "
          f"decaying |dpos| "
          f"{worst:.3e}", flush=True)
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
    """Phase 3c: the Jacobian kernel (single entry and F in {2, 3, 4, 8, 9}:
    every NT in {1, 2, 3}, 9 = 8 + 1) against its plain twin at N in
    {1000, 2500, 1003 (ragged)}, every frame of the F = 8 launch against its
    single-pose launch, and the single entry against a float64 central
    difference of the field on 64 vertices; returns the worst decaying
    relative |dJ| (the 3xTF32 contraction's error against the twin)."""
    from facedeform_tpu_torch.config import PolyTerm, RBFKernel
    from facedeform_tpu_torch.ops import cuda_eval, cuda_jacobian
    from facedeform_tpu_torch.ops.fit import GROWING_KERNELS, RBFModel

    rng = np.random.default_rng(2)
    pts, _ = _ragged_points(dev, rng)
    idx = torch.linspace(0, pts.shape[0] - 1, 64, device=dev).long()
    h = 1e-5
    worst, worst_single, n_cases = 0.0, 0.0, 0
    for n in (1000, 2500, 1003):
        for n_layers in (1, 4):
            for kernel in RBFKernel:
                model = _frames_model(n, n_layers, 9, kernel, rng, dev)
                tol = JAC_TOL_GROWING if kernel in GROWING_KERNELS else JAC_TOL_DECAYING
                want = cuda_jacobian.jacobian_frames_reference(
                    model, pts, kernel, PolyTerm.LINEAR)
                got9 = cuda_jacobian.jacobian_cuda_frames(model, pts, kernel, PolyTerm.LINEAR)
                gots = {nf: cuda_jacobian.jacobian_cuda_frames(
                    RBFModel(ctrl=model.ctrl, w_rbf=model.w_rbf[:nf],
                             w_poly=model.w_poly[:nf], eps=model.eps),
                    pts, kernel, PolyTerm.LINEAR) for nf in (2, 3, 4, 8)}
                got8 = gots[8]
                one = cuda_eval.frame_model(model, 0)
                got1 = cuda_jacobian.jacobian_cuda(one, pts, kernel, PolyTerm.LINEAR)
                singles = [got1] + [cuda_jacobian.jacobian_cuda(
                    cuda_eval.frame_model(model, f), pts, kernel, PolyTerm.LINEAR)
                    for f in range(1, 8)]
                torch.cuda.synchronize()
                scale = max(1.0, float(torch.max(torch.abs(want))))
                e8 = max([float(torch.max(torch.abs(got9 - want)))]
                         + [float(torch.max(torch.abs(g - want[:nf]))) for nf, g in gots.items()]
                         ) / scale
                e1 = float(torch.max(torch.abs(got1 - want[0]))) / scale
                d_single = max(float(torch.max(torch.abs(got8[f] - singles[f])))
                               for f in range(8))
                _check(d_single <= FRAME_VS_SINGLE_TOL * scale,
                       f"jacobian {kernel.name} N={n} L={n_layers}: a frame of the F=8 launch "
                       f"differs from its single-pose launch by {d_single:.3e}")
                worst_single = max(worst_single, d_single / scale)
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
                n_cases += 7
                print(f"  jacobian N={n} L={n_layers} {kernel.name:20s} rel|dJ| F=2/3/4/8/9 "
                      f"{e8:.3e} single {e1:.3e} (tol {tol:g}), vs f64 FD {efd:.3e}; F=8 "
                      f"frames vs single-pose {d_single:.3e}", flush=True)
    print(f"jacobian kernel checks: {n_cases} cases within tolerance (relative "
          f"{JAC_TOL_DECAYING:g} decaying / {JAC_TOL_GROWING:g} growing, float64 FD "
          f"{JAC_FD_TOL:g}); worst decaying 3xTF32 error vs the twin {worst:.3e}; F=8 frames "
          f"vs single-pose launches max rel |dJ| {worst_single:.3e} (bit for bit: "
          f"{worst_single == 0.0})", flush=True)
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

    counters = (cuda_eval.evaluate_cuda, cuda_eval.evaluate_cuda_culled,
                cuda_eval.control_records, cuda_eval.culled_tables)
    since = profiling.counters()
    t0 = time.perf_counter()
    d = Deformer.fit(rest, deformed, DeformConfig(), DeformParams(), device=dev)
    auto_pts, auto_w = d.apply(pts)
    dense_pts, dense_w = d.apply(pts, backend="cuda")
    d_loc = Deformer.fit(cap, cap_def, DeformConfig(), DeformParams(), device=dev)
    loc_pts, _ = d_loc.apply(pts)
    gated_pts, gated_w = d.apply(pts, dist2=cap_d2, backend="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(("dense", "culled", "records", "tables"),
                        _launch_counts(counters, since).values()))
    print(f"main path: {wall:.3f} s wall (2 fits, 4 applies at {pts.shape[0]} "
          f"verts); launches {launches}  [{label}]", flush=True)
    _check(launches["culled"] > 0, "apply('auto') did not launch the culled kernel")
    _check(launches["dense"] > 0, "apply(backend='cuda') did not launch the dense kernel")
    _check(launches["records"] == launches["dense"] and launches["tables"] == launches["culled"],
           "each eval launch must pack its controls on the card once")

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
    from facedeform_tpu_torch.ops.fit import GROWING_KERNELS, effective_kernel
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

    counters = (cuda_eval.evaluate_cuda_frames, cuda_eval.frames_stream,
                cuda_jacobian.jacobian_cuda, cuda_jacobian.jacobian_cuda_frames)
    since = profiling.counters()
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
    launches = _launch_counts(counters, since)
    print(f"slice B main path: {wall:.3f} s wall (fit_frames of {n_frames} poses x "
          f"{n_ctrl} controls, apply_frames + transport_frames at {v} verts, "
          f"Deformer.jacobian); launches {launches}  [{label}]", flush=True)
    _check(launches["evaluate_cuda_frames"] > 0, "apply_frames did not launch the frames kernel")
    _check(launches["frames_stream"] == launches["evaluate_cuda_frames"],
           "apply_frames did not pack each frames launch on the card")
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

    # the Jacobian kernel (F = 8 and single) on the subset against its plain
    # twin at the kernel checks' tolerance and against a float64 Jacobian
    # of the same model at the f32-vs-float64 one
    kernel = effective_kernel(cfg)
    j64 = _jacobian64(model, pts[idx], kernel, cfg.term)
    twin = cuda_jacobian.jacobian_frames_reference(model, pts[idx], kernel, cfg.term).double()
    got8 = cuda_jacobian.jacobian_cuda_frames(model, pts[idx], kernel, cfg.term).double()
    got1 = cuda_jacobian.jacobian_cuda(cuda_eval.frame_model(model, 0), pts[idx], kernel,
                                       cfg.term).double()
    scale = max(1.0, float(j64.abs().max()))
    rel = lambda a, b: float((a - b).abs().max()) / scale  # noqa: E731
    tol = JAC_TOL_GROWING if kernel in GROWING_KERNELS else JAC_TOL_DECAYING
    e8, e1 = rel(got8, j64), rel(got1, j64[0])
    t8, t1 = rel(got8, twin), rel(got1, twin[0])
    print(f"jacobian kernel, 4096-vertex subset, of max(1, max|J|) = {scale:.3e}: vs the plain "
          f"twin F=8 {t8:.3e}, single {t1:.3e} (tol {tol:g}); vs float64 F=8 {e8:.3e}, single "
          f"{e1:.3e} (tol {JAC_FD_TOL:g}); the twin vs float64 {rel(twin, j64):.3e}")
    _check(max(t8, t1) <= tol, "the Jacobian kernel disagrees with its plain twin")
    _check(max(e8, e1) <= JAC_FD_TOL, "the Jacobian kernel strays from the float64 Jacobian")
    return {"launches": launches, "model": model, "rest": rest, "frames": frames,
            "points": pts, "cfg": cfg, "params": params}


def _kernel_alone_ms(fn, name: str, n: int = 20) -> float:
    """Device ms a call of the kernels whose name holds `name`, from a
    torch.profiler window over n calls of fn: the kernel alone, without the
    wrapper's other launches (packing, slab tables)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(  # noqa: E731
        e, "self_cuda_time_total", 0)
    total = sum(dev_us(e) for e in prof.key_averages() if name in e.key)
    _check(total > 0, f"the profiler saw no device time of {name}")
    return total / n / 1e3


def _boxes(x, size):
    """lo, hi (ceil(n / size), 3) of consecutive groups of `size` rows of x."""
    pad = -x.shape[0] % size
    lo = torch.nn.functional.pad(x, (0, 0, 0, pad), value=float("inf"))
    hi = torch.nn.functional.pad(x, (0, 0, 0, pad), value=float("-inf"))
    return lo.reshape(-1, size, 3).amin(1), hi.reshape(-1, size, 3).amax(1)


def _reach(lo_a, hi_a, lo_b, hi_b, cut2_b):
    """(na, nb): box b within its cutoff^2 of box a (the kernels' gap test)."""
    g = torch.clamp(torch.maximum(lo_b[None] - hi_a[:, None], lo_a[:, None] - hi_b[None]), min=0)
    return (g * g).sum(-1) <= cut2_b[None]


def _cull_pairs(pts, model, kernel) -> dict:
    """(vertex, control) pairs of a culled evaluation on these inputs, all
    vertices active: needed (within the control's cutoff), and, by a host
    model of each skip rule, computed (vertex slots x control slots) by
    the block rule of the JAX package's culled kernel (128-vertex blocks
    against 128-control slabs) and by the two-level rule (blocks of 512
    vertices against slabs, each warp of 128 against 32-control
    sub-slabs; 256/64 and 128/32 at two and one vertices a thread).  The
    tables come from culled_slabs, which a parent commit's package has
    too, so the rules of a parent and a change are modelled alike; the
    change's kernel also counts its pairs on the card (time_kernels)."""
    from facedeform_tpu_torch.ops import cuda_eval

    ctrl, _, inv_eps2, bbox = cuda_eval.culled_slabs(model, kernel)
    n = model.ctrl.shape[0]
    cut2 = cuda_eval._CULL_S_CUTOFF[kernel] / inv_eps2.amin(0)     # (NP,)
    cut2[n:] = 0.0  # padding rows: zero weight, the tables' eps of 1e-6
    needed = _pairs_within(pts, ctrl[:n], cut2[:n])
    slo, shi, scut = bbox[:, :3], bbox[:, 3:6], bbox[:, 6]
    blo, bhi = _boxes(pts, 128)
    out = {"needed": needed,
           "block rule 128/128": int(_reach(blo, bhi, slo, shi, scut).sum()) * 128 * 128}
    sub_lo, sub_hi = _boxes(ctrl, 32)
    sub_cut = cut2.reshape(-1, 32).amax(1)
    for block_v, warp_v in ((512, 128), (256, 64), (128, 32)):
        wlo, whi = _boxes(pts, warp_v)
        per = block_v // warp_v
        pad = -wlo.shape[0] % per
        blo = torch.nn.functional.pad(wlo, (0, 0, 0, pad), value=float("inf"))
        bhi = torch.nn.functional.pad(whi, (0, 0, 0, pad), value=float("-inf"))
        slab_ok = _reach(blo.reshape(-1, per, 3).amin(1), bhi.reshape(-1, per, 3).amax(1),
                         slo, shi, scut)                               # (blocks, NB)
        slab_ok = slab_ok.repeat_interleave(per, 0)[: wlo.shape[0]].repeat_interleave(4, 1)
        sub_ok = _reach(wlo, whi, sub_lo, sub_hi, sub_cut) & slab_ok   # (warps, 4 NB)
        out[f"two-level {block_v}/{warp_v}/32"] = int(sub_ok.sum()) * warp_v * 32
    return out


def _print_pairs(name: str, pairs: dict, label: str) -> None:
    need = pairs["needed"]
    print(f"culled pairs at {name}: {need} needed; computed (host model) " + ", ".join(
        f"{k} {v} ({v / need:.3f}x)" for k, v in pairs.items() if k != "needed")
        + f"  [{label}]")


def time_kernels(main: dict, label: str) -> list:
    """Phase 7a: each kernel and the plain version at the main path's
    shapes (1M verts x 1k controls, all active), the culled kernel also
    alone (profiler) and the pairs it computes, counted on the card, over
    the pairs it needs."""
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
        "records": lambda: cuda_eval.control_records(model),
        "records plain": lambda: cuda_eval.control_records_reference(model),
        "tables": lambda: cuda_eval.culled_tables(model, RBFKernel.GAUSSIAN),
        "tables plain": lambda: cuda_eval.culled_tables_reference(model, RBFKernel.GAUSSIAN),
    }
    times = {k: stats(t) for k, t in time_cuda(fns).items()}
    want, _ = cuda_eval.evaluate_reference(*args)
    errs = {k: float(torch.max(torch.abs(fns[k]()[0] - want))) for k in ("dense", "culled")}
    for k in ("records", "tables"):
        errs[k] = max(float(torch.max(torch.abs(g - w)))
                      for g, w in zip(fns[k](), fns[k + " plain"]()))
    for k, (best, med, spread) in times.items():
        print(f"time {k}: {best:.4f} ms best, {med:.4f} median, spread "
              f"{spread * 100:.1f}% at {v} x {model.ctrl.shape[0]}  [{label}]")
    alone = {k: _kernel_alone_ms(fns[k], f"{k}_kernel") for k in ("dense", "culled")}
    print(f"time kernels alone (profiler, 20 calls): dense {alone['dense']:.4f} ms, culled "
          f"{alone['culled']:.4f} ms  [{label}]")
    src = "facedeform_tpu_torch/csrc/eval.cu"
    n = model.ctrl.shape[0]
    n_layers = model.eps.shape[0]
    # per pair: d2 8, s 1, exp(-s) 2, 3 FMAs 6; bytes: points, dist2, gate,
    # out, falloff (36 B/vertex), ctrl, w, inv_eps2 (28 B/control)
    n_bytes = 36 * v + 28 * n + 48
    pairs = _cull_pairs(pts, model, RBFKernel.GAUSSIAN)
    _print_pairs(f"{v} x {n}", pairs, label)
    geom = cuda_eval.cull_geometry()
    rule = f"two-level {geom['block_verts']}/{geom['warp_verts']}/{geom['sub']}"
    count = torch.zeros(1, dtype=torch.int64, device=pts.device)
    cuda_eval.evaluate_cuda_culled(*args, pairs=count)
    counted = int(count.item())
    print(f"culled pairs at {v} x {n}: {counted} computed, counted on the card "
          f"({counted / pairs['needed']:.3f}x the needed; the host model of its rule "
          f"{rule}: {pairs[rule]})  [{label}]")
    _check(pairs["needed"] <= counted, "the culled kernel computed fewer pairs than it needs")
    # the packing moves bytes: the model in (ctrl, w, eps: 12 + 16 L B a
    # control; the tail 48 B), the records (16 (1 + L) B a control, padded
    # for the tables), the slab and sub-slab tables (160 B a slab) and the
    # tail out; 3 operations a 1/eps^2
    n_pad = -(-n // 128) * 128
    rec_bytes = (12 + 16 * n_layers) * n + 48 + 16 * (1 + n_layers) * n + 48
    tab_bytes = (12 + 16 * n_layers) * n + 48 + 16 * (1 + n_layers) * n_pad + 160 * (
        n_pad // 128) + 48
    return [
        {"name": "eval_dense", "route": "cuda", "source": src,
         "replaces": "facedeform_tpu/ops/pallas_eval.py:349",
         "launches": main["launches"]["dense"], "max_abs_err": errs["dense"],
         "ms": times["dense"][0], "kernel_alone_ms": alone["dense"],
         "plain_ms": times["plain"][0],
         **_bound(n_bytes, (17 * v * n, PEAK_F32)), "library_ms": None},
        {"name": "eval_culled", "route": "cuda", "source": src,
         "replaces": "facedeform_tpu/ops/pallas_eval.py:868",
         "launches": main["launches"]["culled"], "max_abs_err": errs["culled"],
         "ms": times["culled"][0], "kernel_alone_ms": alone["culled"],
         "plain_ms": times["plain"][0],
         "pairs_computed_over_needed": counted / pairs["needed"],
         **_bound(n_bytes, (17 * pairs["needed"], PEAK_F32)), "library_ms": None},
        # the per-call packing the JAX package leaves to XLA around its
        # pallas_calls (inv_eps2 and the tail; the Morton sort, gathers,
        # padding and slab table of the culled wrapper): no TPU kernel of
        # their own, so `replaces` names the pallas_call they feed
        {"name": "eval_records", "route": "cuda", "source": src,
         "replaces": "facedeform_tpu/ops/pallas_eval.py:349", "part_of": "eval_dense",
         "launches": main["launches"]["records"], "max_abs_err": errs["records"],
         "ms": times["records"][0], "plain_ms": times["records plain"][0],
         **_bound(rec_bytes, (3 * n_layers * n, PEAK_F32)), "library_ms": None},
        {"name": "culled_tables", "route": "cuda", "source": src,
         "replaces": "facedeform_tpu/ops/pallas_eval.py:868", "part_of": "eval_culled",
         "launches": main["launches"]["tables"], "max_abs_err": errs["tables"],
         "ms": times["tables"][0], "plain_ms": times["tables plain"][0],
         **_bound(tab_bytes, (3 * n_layers * n_pad, PEAK_F32)), "library_ms": None},
    ]


def time_eval(dev, label: str) -> dict:
    """--eval, part alone: the dense kernel at 1M x 1k gaussian all active,
    through the capture-gated apply (33.3% active) and as the custom-VJP
    eval's forward at 65536 x 1k; the culled kernel through its wrapper and
    alone (profiler) at 1M x 1k and through apply("auto") on the localized
    4096-control rig, each beside its dense apply; one call of the culled
    wrapper and of both applies under the profiler; computed / needed
    pairs of the culling rules (host model).  Best of 5
    interleaved rounds of 10 calls.  It calls only entry points the parent
    commit has too, so run from a parent checkout it times the parent's
    kernels by the same code.  Returns {name: (best, median, spread)}."""
    from facedeform_tpu_torch import DeformConfig, DeformParams, Deformer
    from facedeform_tpu_torch.benchmark import stats, time_cuda
    from facedeform_tpu_torch.config import PolyTerm, RBFKernel
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points, uv_sphere
    from facedeform_tpu_torch.ops import cuda_eval

    rng = np.random.default_rng(0)  # main_path's rigs
    rest = fibonacci_points(1000)
    deformed = rest + 0.05 * rng.standard_normal((1000, 3)).astype(np.float32)
    n_loc = 4096
    cap = fibonacci_points(n_loc) * 0.15 + np.float32([0, 0.98, 0])
    cap_def = cap + 0.01 * rng.standard_normal((n_loc, 3)).astype(np.float32)
    pts = torch.as_tensor(uv_sphere(1000, 1000).points, device=dev)
    v = pts.shape[0]
    cap_d2 = torch.sum((pts - torch.tensor([0.0, 1.0, 0.0], device=dev)) ** 2, -1)
    d = Deformer.fit(rest, deformed, DeformConfig(), DeformParams(), device=dev)
    d_loc = Deformer.fit(cap, cap_def, DeformConfig(), DeformParams(), device=dev)
    gauss, lin = RBFKernel.GAUSSIAN, PolyTerm.LINEAR
    zeros, ones = torch.zeros(v, device=dev), torch.ones(v, device=dev)
    args = (d.model, pts, zeros, ones, 1.0, 1.0, gauss, lin)
    sub = pts[:65536].contiguous()
    fns = {
        "dense 1M x 1k": lambda: cuda_eval.evaluate_cuda(*args),
        "apply cuda 1M x 1k": lambda: d.apply(pts, backend="cuda"),
        "apply cuda gated": lambda: d.apply(pts, dist2=cap_d2, backend="cuda"),
        "diff forward 65536 x 1k": lambda: cuda_eval.evaluate_cuda_diff(
            d.model, sub, zeros[:65536], ones[:65536], 1.0, 1.0, None, gauss, lin),
        "culled 1M x 1k": lambda: cuda_eval.evaluate_cuda_culled(*args),
        "localized apply auto": lambda: d_loc.apply(pts),
        "localized apply cuda": lambda: d_loc.apply(pts, backend="cuda"),
    }
    t = {k: stats(x) for k, x in time_cuda(fns, rounds=5, iters=10).items()}
    alone = {"dense kernel alone 1M x 1k": _kernel_alone_ms(fns["dense 1M x 1k"], "dense_kernel"),
             "culled kernel alone 1M x 1k": _kernel_alone_ms(fns["culled 1M x 1k"],
                                                             "culled_kernel"),
             "culled kernel alone localized": _kernel_alone_ms(fns["localized apply auto"],
                                                               "culled_kernel")}
    for k, x in t.items():
        print(_fmt(k, x, f"  [{label}]"))
    for k, x in alone.items():
        print(f"time {k}: {x:.4f} ms (profiler, 20 calls)  [{label}]")
    print(f"capture_gated_speedup {t['apply cuda 1M x 1k'][0] / t['apply cuda gated'][0]:.3f}x "
          f"({float((cap_d2 <= 1.0).float().mean()) * 100:.1f}% active); "
          f"localized_culled_speedup "
          f"{t['localized apply cuda'][0] / t['localized apply auto'][0]:.3f}x  [{label}]")
    for k in ("culled 1M x 1k", "apply cuda gated", "localized apply auto"):
        _profile(fns[k], f"{k} (one call)", top=6)
    _print_pairs(f"{v} x 1000", _cull_pairs(pts, d.model, gauss), label)
    _print_pairs(f"{v} x {n_loc} (localized)", _cull_pairs(pts, d_loc.model, gauss), label)
    want, _ = cuda_eval.evaluate_reference(*args)
    for k in ("dense 1M x 1k", "culled 1M x 1k"):
        e = float(torch.max(torch.abs(fns[k]()[0] - want)))
        print(f"{k}: max |kernel - plain| {e:.3e} (tol {POS_TOL_DECAYING:g})")
        _check(e <= POS_TOL_DECAYING, f"{k} disagrees with the plain version")
    print(json.dumps({"eval": {k: list(x) for k, x in t.items()}, **alone, "device": label}))
    return t


def _fmt(name, t, extra=""):
    best, med, spread = t
    return f"time {name}: {best:.4f} ms best, {med:.4f} median, spread {spread * 100:.1f}%{extra}"


def time_frames(main_b: dict, label: str) -> list:
    """Phase 7b: the frames and Jacobian kernels against their plain twins
    at the slice B main path's shapes (1M verts x 1k controls; the frames
    kernel also alone, by the profiler, and its packing kernel against its
    twin), F = 8, 11, 16, 17, 32, 33 per frame through apply_frames, and
    both fit_frames routes at (1k controls, F = 8) and (4k, F = 32)."""
    from facedeform_tpu_torch.benchmark import stats, time_cuda
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points
    from facedeform_tpu_torch.ops import cuda_eval, cuda_jacobian
    from facedeform_tpu_torch.ops import fit as fit_mod
    from facedeform_tpu_torch.ops.fit import GROWING_KERNELS, RBFModel, effective_kernel
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
        "packing": lambda: cuda_eval.frames_stream(model, *cuda_eval.frames_launch_plan(
            n_frames)[0]),
        "packing plain": lambda: cuda_eval.frames_stream_reference(
            model, *cuda_eval.frames_launch_plan(n_frames)[0]),
    }
    t = {k: stats(x) for k, x in time_cuda(fns, iters={
        "frames": 10, "dense x8": 10, "frames plain": 2, "packing": 10,
        "packing plain": 10}).items()}
    want, _ = cuda_eval.evaluate_frames_reference(*args)
    err_frames = float(torch.max(torch.abs(fns["frames"]()[0] - want)))
    err_pack = max(float(torch.max(torch.abs(g - w)))
                   for g, w in zip(fns["packing"](), fns["packing plain"]()))
    alone = _kernel_alone_ms(fns["frames"], "frames_kernel")
    for k, x in t.items():
        print(_fmt(k, x, f" at {v} x {model.ctrl.shape[0]} x {n_frames} frames  [{label}]"))
    print(f"time frames kernel alone (profiler, 20 calls): {alone:.4f} ms  [{label}]")
    print(f"frames kernel vs 8 dense launches: {t['dense x8'][0] / t['frames'][0]:.3f}x; "
          f"vs plain twin {t['frames plain'][0] / t['frames'][0]:.2f}x; max |d| vs twin "
          f"{err_frames:.3e}; packing max |d| vs twin {err_pack:.3e}")
    _check(err_frames <= (POS_TOL_GROWING if kernel in GROWING_KERNELS else POS_TOL_DECAYING),
           "the frames kernel disagrees with its plain twin at the main path's shape")
    _check(err_pack == 0.0, "the frames packing kernel differs from its plain twin")

    # F = 8, 11, 16, 17, 32, 33 through apply_frames: the balanced launches
    rng = np.random.default_rng(3)
    rest = main_b["rest"]
    more = rest + 0.05 * rng.standard_normal((33,) + rest.shape).astype(np.float32)
    model33, _ = batched.fit_frames(rest, more, cfg, params, device=dev)
    for nf in FRAMES_TIMED_F:
        sub = RBFModel(ctrl=model33.ctrl, w_rbf=model33.w_rbf[:nf],
                       w_poly=model33.w_poly[:nf], eps=model33.eps)
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
    scale = max(1.0, float(want_j.abs().max()))
    tol = JAC_TOL_GROWING if kernel in GROWING_KERNELS else JAC_TOL_DECAYING
    print(f"jacobian max |dJ| vs plain: F=8 {err_jac:.3e}, single {err_jac1:.3e} "
          f"(max |J| {float(want_j.abs().max()):.3e}; of max(1, max|J|) "
          f"{max(err_jac, err_jac1) / scale:.3e}, tol {tol:g})")
    _check(max(err_jac, err_jac1) <= tol * scale,
           "the Jacobian kernel disagrees with its plain twin at 1M")
    n = model.ctrl.shape[0]
    for name, nf, ms in (("F=8", n_frames, jt["jacobian F=8"][0]),
                         ("single", 1, jt["jacobian"][0])):
        b, old = _jac_bound(nf, v, n), _jac_bound(nf, v, n, tensor_cores=False)
        print(f"jacobian {name} at {v} x {n}: bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
              f"({b['bound_ms'] / ms * 100:.1f}% of the kernel's time; CUDA-core formula "
              f"{old['bound_ms']:.4f} ms, {old['bound_ms'] / ms * 100:.1f}%)  [{label}]")

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

    n = model.ctrl.shape[0]
    f = n_frames
    bound, old = _frames_bound(f, v, n), _frames_bound(f, v, n, tensor_cores=False)
    print(f"frames kernel at {v} x {n} x {f}: bound {bound['bound_ms']:.4f} ms by "
          f"{bound['bound_by']} ({bound['bound_ms'] / alone * 100:.1f}% of the kernel alone; "
          f"CUDA-core formula {old['bound_ms']:.4f} ms, {old['bound_ms'] / alone * 100:.1f}%)"
          f"  [{label}]")
    nt = cuda_eval.frames_launch_plan(f)[0][2]
    pack_bytes = 16 * n + 12 * f * n + 48 * f + 4 * (
        -(-n // 8) * cuda_eval.frames_step_floats(nt, 1) + 32 * nt)
    return [
        {"name": "eval_frames", "route": "cuda",
         "source": "facedeform_tpu_torch/csrc/frames.cu",
         "replaces": "facedeform_tpu/ops/pallas_eval.py:616",
         "launches": main_b["launches"]["evaluate_cuda_frames"], "max_abs_err": err_frames,
         "ms": t["frames"][0], "kernel_alone_ms": alone, "plain_ms": t["frames plain"][0],
         **bound, "library_ms": None},
        # the launch's operands, packed on the card (the JAX package leaves
        # the frames packing to XLA around its pallas_call): the model in,
        # the stream and tails out; 3 operations a 1/eps^2, 4 a split word
        {"name": "frames_stream", "route": "cuda",
         "source": "facedeform_tpu_torch/csrc/frames.cu",
         "replaces": "facedeform_tpu/ops/pallas_eval.py:616", "part_of": "eval_frames",
         "launches": main_b["launches"]["frames_stream"], "max_abs_err": err_pack,
         "ms": t["packing"][0], "plain_ms": t["packing plain"][0],
         **_bound(pack_bytes, (3 * n + 4 * 8 * nt * -(-n // 8) * 8, PEAK_F32)),
         "library_ms": None},
        {"name": "jacobian", "route": "cuda",
         "source": "facedeform_tpu_torch/csrc/jacobian.cu",
         "replaces": "facedeform_tpu/ops/pallas_jacobian.py:160",
         "launches": main_b["launches"]["jacobian_cuda_frames"], "max_abs_err": err_jac,
         "ms": jt["jacobian F=8"][0], "plain_ms": jt["jacobian plain F=8"][0],
         **_jac_bound(f, v, n), "library_ms": None},
        {"name": "jacobian_single", "route": "cuda",
         "source": "facedeform_tpu_torch/csrc/jacobian.cu",
         "replaces": "facedeform_tpu/ops/pallas_jacobian.py:160",
         "launches": main_b["launches"]["jacobian_cuda"], "max_abs_err": err_jac1,
         "ms": jt["jacobian"][0], "plain_ms": jt["jacobian plain"][0],
         **_jac_bound(1, v, n), "library_ms": None},
    ]


def time_frames_part(dev, label: str) -> dict:
    """--frames, part alone: the frames kernel at slice B's shot, 1M x 1k x
    8 frames (the fitted 8 poses of main_path_frames), and at F = 16, 17,
    32 (fitted poses of the same rig), through evaluate_cuda_frames and
    alone (profiler, every launch of a call summed), and apply_frames per
    frame at F = 8, 11, 16, 17, 32, 33; also F = 1 and 2.  Best of 5
    interleaved rounds of 10 calls.  It calls only
    entry points the parent commit has too, so run from a parent checkout
    it times the parent's kernel by the same code.  Returns {name: (best,
    median, spread)}."""
    from facedeform_tpu_torch import DeformConfig, DeformParams
    from facedeform_tpu_torch.benchmark import stats, time_cuda
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points, uv_sphere
    from facedeform_tpu_torch.ops import cuda_eval, temporal
    from facedeform_tpu_torch.ops.fit import RBFModel, effective_kernel
    from facedeform_tpu_torch.parallel import batched

    rng = np.random.default_rng(0)  # main_path_frames' shot
    rest = fibonacci_points(1000)
    raw = np.stack([rest + 0.05 * rng.standard_normal((1000, 3)).astype(np.float32)
                    for _ in range(8)])
    cfg, params = DeformConfig(tangent=True), DeformParams()
    model, _ = batched.fit_frames(rest, temporal.smooth_frames(raw, window=5), cfg, params,
                                  device=dev)
    more = rest + 0.05 * np.random.default_rng(3).standard_normal(
        (33,) + rest.shape).astype(np.float32)
    model33, _ = batched.fit_frames(rest, more, cfg, params, device=dev)
    pts = torch.as_tensor(uv_sphere(1000, 1000).points, device=dev)
    v = pts.shape[0]
    zeros, ones = torch.zeros(v, device=dev), torch.ones(v, device=dev)
    kernel, term = effective_kernel(cfg), cfg.term

    def first(nf, m=model33):
        return RBFModel(ctrl=m.ctrl, w_rbf=m.w_rbf[:nf], w_poly=m.w_poly[:nf], eps=m.eps)

    def frames(m):
        return lambda: cuda_eval.evaluate_cuda_frames(m, pts, zeros, ones, 1.0, 1.0, kernel,
                                                      term)

    fns = {"frames 1M x 1k x 8": frames(model)}
    fns.update({f"frames F={nf}": frames(first(nf)) for nf in (1, 2, 16, 17, 32)})
    fns.update({f"apply_frames F={nf}": (lambda m: lambda: batched.apply_frames(
        m, pts, zeros, ones, cfg, params))(first(nf)) for nf in FRAMES_TIMED_F})
    t = {k: stats(x) for k, x in time_cuda(fns, rounds=5, iters=10).items()}
    for k, x in t.items():
        extra = (f"; {x[0] / int(k.split('=')[1]):.4f} ms per frame"
                 if k.startswith("apply_frames") else "")
        print(_fmt(k, x, f"{extra}  [{label}]"))
    alone = {f"{k} kernel alone": _kernel_alone_ms(fns[k], "frames_kernel")
             for k in ("frames 1M x 1k x 8", "frames F=16", "frames F=17", "frames F=32")}
    for k, x in alone.items():
        print(f"time {k}: {x:.4f} ms (profiler, 20 calls)  [{label}]")
    for k, m in (("frames 1M x 1k x 8", model), ("frames F=17", first(17))):
        want, _ = cuda_eval.evaluate_frames_reference(m, pts, zeros, ones, 1.0, 1.0, kernel, term)
        e = float(torch.max(torch.abs(fns[k]()[0] - want)))
        print(f"{k}: max |kernel - plain| {e:.3e} (tol {POS_TOL_DECAYING:g})")
        _check(e <= POS_TOL_DECAYING, f"{k} disagrees with the plain version")
    print(json.dumps({"frames": {k: list(x) for k, x in t.items()}, **alone,
                      "device": label}))
    return t


def _with_lo(model, rng, dev):
    """model with seeded lo words below half an ulp of its weights."""
    from facedeform_tpu_torch.ops.fit import RBFModel

    def lo(w):
        u = rng.uniform(-1.0, 1.0, tuple(w.shape)).astype(np.float32)
        return (w * torch.as_tensor(u, device=dev) * 2.0 ** -25).contiguous()

    return RBFModel(ctrl=model.ctrl, w_rbf=model.w_rbf, w_poly=model.w_poly, eps=model.eps,
                    w_rbf_lo=lo(model.w_rbf), w_poly_lo=lo(model.w_poly))


def _fitted_model(n, kernel, rng, dev):
    """Deformer.fit of n Fibonacci controls moved by 0.05 N(0, 1) (KERNEL
    mode, radius 1, lam 0.01, linear tail) with its lo words: weights ~10
    against displacements ~0.1, the cancellation the precise path exists
    for, where an f32 evaluation misses PRECISE_POS_TOL by far."""
    from facedeform_tpu_torch import DeformConfig, DeformParams, Deformer
    from facedeform_tpu_torch.config import PolyTerm, RBFModelType
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points

    rest = fibonacci_points(n)
    deformed = rest + 0.05 * rng.standard_normal((n, 3)).astype(np.float32)
    cfg = DeformConfig(model=RBFModelType.KERNEL, kernel=kernel, term=PolyTerm.LINEAR,
                       solver="direct")
    return Deformer.fit(rest, deformed, cfg, DeformParams(radius=1.0, lam=0.01),
                        device=dev).model


def _without_lo(model):
    from facedeform_tpu_torch.ops.fit import RBFModel

    return RBFModel(ctrl=model.ctrl, w_rbf=model.w_rbf, w_poly=model.w_poly, eps=model.eps)


def check_precise_kernel(dev) -> float:
    """Phase 3d: the float64 precise kernel against its plain twin on
    synthetic models (all 7 bases, L in {1, 3}, N in {1000, 2500}) and on
    fitted growing-kernel models (N in {1000, 2500}), at ragged V = 70002,
    with and without a tangent frame, strict_parity both ways, 33%
    capture-active plus a group gate, lo words present and absent.  On the
    fitted models the bound is shown to tell float64 from f32: the f32
    dense kernel misses it on every model, dropping the lo words on some;
    returns the worst |dpos|."""
    from facedeform_tpu_torch.config import PolyTerm, RBFKernel
    from facedeform_tpu_torch.ops import cuda_eval, cuda_precise
    from facedeform_tpu_torch.ops.fit import GROWING_KERNELS

    rng = np.random.default_rng(4)
    pts, frame = _ragged_points(dev, rng)
    v = pts.shape[0]
    dist2 = torch.sum((pts - torch.tensor([0.0, 1.05, 0.0], device=dev)) ** 2, -1)
    radius = float(torch.quantile(dist2, 0.33).sqrt())       # 33% active
    dist2[::97] = -1.0                                       # strict-parity sentinel
    gate = (pts[:, 0] > -0.6).float()                        # a group gate
    cases = []                                               # (name, kernel, models, fitted)
    for n in (1000, 2500):
        for n_layers in (1, 3):
            for kernel in RBFKernel:
                base = _synthetic_model(n, n_layers, kernel, rng, dev)
                cases.append((f"N={n} L={n_layers} {kernel.name}", kernel,
                              (base, _with_lo(base, rng, dev)), False))
        for kernel in GROWING_KERNELS:
            fitted = _fitted_model(n, kernel, rng, dev)
            cases.append((f"fitted N={n} {kernel.name}", kernel,
                          (fitted, _without_lo(fitted)), True))
    worst, n_cases, worst_no_lo = [0.0, 0.0], 0, 0.0
    for name, kernel, models, fitted in cases:
        group = [0.0, 0.0]
        for model in models:
            for with_frame in (False, True):
                for strict in (False, True):
                    args = (model, pts, dist2, gate, radius, 1.5, kernel, PolyTerm.LINEAR)
                    kw = dict(strict_parity=strict, frame=frame if with_frame else None)
                    want_p, want_w = cuda_precise.evaluate_precise_reference(*args, **kw)
                    got_p, got_w = cuda_precise.evaluate_cuda_precise(*args, **kw)
                    torch.cuda.synchronize()
                    dp = float(torch.max(torch.abs(got_p - want_p)))
                    dw = float(torch.max(torch.abs(got_w - want_w)))
                    still = got_w == 0
                    pinned = bool(torch.equal(got_p[still], pts[still]))
                    _check(
                        dp <= PRECISE_POS_TOL and dw <= FALLOFF_TOL and pinned,
                        f"precise {name} lo={model.w_rbf_lo is not None} frame={with_frame} "
                        f"strict={strict}: |dpos| {dp:.3e} (tol {PRECISE_POS_TOL:g}), "
                        f"|dfalloff| {dw:.3e}, zero-weight rows pinned {pinned}",
                    )
                    group = [max(group[0], dp), max(group[1], dw)]
                    n_cases += 1
        worst = [max(worst[0], group[0]), max(worst[1], group[1])]
        extra = ""
        if fitted:
            # the whole field, every vertex active: f32 arithmetic (the f32
            # dense kernel) and dropping the lo words against the twin
            full = (pts, torch.zeros(v, device=dev), torch.ones(v, device=dev), 1.0, 1.0,
                    kernel, PolyTerm.LINEAR)
            want, _ = cuda_precise.evaluate_precise_reference(models[0], *full)
            f32 = float(torch.max(torch.abs(cuda_eval.evaluate_cuda(models[0], *full)[0] - want)))
            no_lo = float(torch.max(torch.abs(
                cuda_precise.evaluate_precise_reference(models[1], *full)[0] - want)))
            worst_no_lo = max(worst_no_lo, no_lo)
            _check(f32 > PRECISE_POS_TOL,
                   f"precise {name}: the f32 dense kernel lies within {PRECISE_POS_TOL:g} of "
                   f"the float64 twin ({f32:.3e}), so the bound cannot tell f32 from float64")
            extra = f"; f32 dense kernel {f32:.3e}, lo words dropped {no_lo:.3e} off"
        print(f"  precise {name:28s} max|dpos| {group[0]:.3e} max|dfalloff| "
              f"{group[1]:.3e}{extra}", flush=True)
    _check(worst_no_lo > PRECISE_POS_TOL,
           f"dropping the lo words moves no fitted field past {PRECISE_POS_TOL:g} "
           f"({worst_no_lo:.3e}), so the bound cannot tell a kernel that ignores them")
    print(f"precise kernel checks: {n_cases} cases within tolerance (positions "
          f"{PRECISE_POS_TOL:g}, falloff {FALLOFF_TOL:g}, zero-weight rows equal to the "
          f"input); worst |dpos| {worst[0]:.3e}, |dfalloff| {worst[1]:.3e}; on the fitted "
          f"models the f32 dense kernel misses the bound on every model and dropping the "
          f"lo words on at least one (worst {worst_no_lo:.3e})", flush=True)
    return worst[0]


def check_precise_frames_kernel(dev) -> float:
    """Phase 3d (frames): the precise kernel's frames launches against the
    frames twin, TPS/MQ/linear/cubic x L in {1, 3} x lo words present and
    absent x F in {1, 2, 4, 8, 9} (9 crosses the 8-frame launch chunk), at
    ragged V = 70002 x 1000 controls with a tangent frame, 33% capture-
    active plus a group gate; every frame of every launch equal to the
    single-pose launch of that frame bit for bit.  Returns the worst
    |dpos|."""
    from facedeform_tpu_torch.config import PolyTerm
    from facedeform_tpu_torch.ops import cuda_eval, cuda_precise
    from facedeform_tpu_torch.ops.fit import GROWING_KERNELS

    rng = np.random.default_rng(8)
    pts, frame = _ragged_points(dev, rng)
    dist2 = torch.sum((pts - torch.tensor([0.0, 1.05, 0.0], device=dev)) ** 2, -1)
    radius = float(torch.quantile(dist2, 0.33).sqrt())       # 33% active
    gate = (pts[:, 0] > -0.6).float()                        # a group gate
    worst, n_cases = 0.0, 0
    for kernel in GROWING_KERNELS:
        for n_layers in (1, 3):
            base = _frames_model(1000, n_layers, 9, kernel, rng, dev)
            for model in (base, _with_lo(base, rng, dev)):
                args = (pts, dist2, gate, radius, 1.5, kernel, PolyTerm.LINEAR)
                want_p, want_w = cuda_precise.evaluate_precise_frames_reference(
                    model, *args, frame=frame)
                singles = [cuda_precise.evaluate_cuda_precise(
                    cuda_eval.frame_model(model, f), *args, frame=frame) for f in range(9)]
                group = 0.0
                for n_frames in (1, 2, 4, 8, 9):
                    got_p, got_w = cuda_precise.evaluate_cuda_precise_frames(
                        cuda_eval.frame_model(model, slice(0, n_frames)), *args, frame=frame)
                    torch.cuda.synchronize()
                    dp = float(torch.max(torch.abs(got_p - want_p[:n_frames])))
                    dw = float(torch.max(torch.abs(got_w - want_w)))
                    equal = all(bool(torch.equal(got_p[f], singles[f][0]))
                                for f in range(n_frames)) and bool(
                        torch.equal(got_w, singles[0][1]))
                    _check(tuple(got_p.shape) == (n_frames, pts.shape[0], 3)
                           and dp <= PRECISE_POS_TOL and dw <= FALLOFF_TOL and equal,
                           f"precise frames {kernel.name} L={n_layers} F={n_frames} "
                           f"lo={model.w_rbf_lo is not None}: |dpos| {dp:.3e} (tol "
                           f"{PRECISE_POS_TOL:g}), |dfalloff| {dw:.3e}, every frame equal to "
                           f"its single-pose launch {equal}")
                    group = max(group, dp)
                    n_cases += 1
                worst = max(worst, group)
                print(f"  precise frames {kernel.name:12s} L={n_layers} lo="
                      f"{model.w_rbf_lo is not None!s:5s} F 1/2/4/8/9: max|dpos| {group:.3e}, "
                      f"frames equal to single-pose launches", flush=True)
    print(f"precise frames checks: {n_cases} cases within {PRECISE_POS_TOL:g} of the frames "
          f"twin, every frame bit for bit its single-pose launch; worst |dpos| {worst:.3e}",
          flush=True)
    return worst


def check_device_log(dev) -> dict:
    """Phase 3d (log): the precise kernel's thin-plate log (its device
    function, through a probe launch) against float64 torch.log on the
    card and the numpy model of it: within 4 ulp of log s where |log s| >=
    1, 4 x 2^-52 absolute elsewhere, over a log-spaced sweep of [1e-30,
    1e8] and the edge cases (powers of two, 1 +- a few ulp, subnormals, the
    table's range edges).  Returns the worst errors."""
    from facedeform_tpu_torch.ops import cuda_precise

    f64 = dict(dtype=torch.float64, device=dev)
    j = torch.arange(256, **f64)
    edges = torch.cat([1.0 + (j - 0.5) / 256, 0.5 + (j - 0.5) / 512,
                       torch.tensor([0.75 - 2.0 ** -10, 1.5 - 2.0 ** -9, 1.0 - 2.0 ** -10,
                                     1.0 + 2.0 ** -9], **f64)])
    inf = torch.full_like(edges, float("inf"))
    edges = torch.cat([edges, torch.nextafter(edges, -inf), torch.nextafter(edges, inf)])
    tiny = torch.tensor(5e-324, **f64)
    s = torch.cat([
        torch.logspace(-30, 8, 4_000_001, **f64),
        2.0 ** torch.arange(-1074, 1024, **f64),
        1.0 + torch.arange(-64, 65, **f64) * 2.0 ** -53,
        tiny * torch.cat([torch.arange(1, 4096, **f64), 2.0 ** torch.arange(12, 52, **f64)]),
        edges, edges * 2.0 ** 40, edges * 2.0 ** -70,
    ])
    got = cuda_precise.device_log(s)
    ref = torch.log(s)
    err = torch.abs(got - ref)
    big = torch.abs(ref) >= 1.0
    ulp = torch.nextafter(torch.abs(ref), torch.full_like(ref, float("inf"))) - torch.abs(ref)
    rel = float((err[big] / ulp[big]).max())
    absolute = float((err[~big] / 2.0 ** -52).max())
    model = torch.as_tensor(cuda_precise.device_log_model(s.cpu().numpy()), device=dev)
    vs_model = float(torch.max(torch.abs(got - model)))
    print(f"device log: {s.numel()} values in [5e-324, 9e307]: max {rel:.2f} ulp of torch.log "
          f"where |log s| >= 1 (tol 4), max {absolute:.2f} x 2^-52 elsewhere (tol 4); "
          f"max |device - numpy model| {vs_model:.3e}", flush=True)
    _check(rel <= 4.0 and absolute <= 4.0 and bool(torch.isfinite(got).all()),
           "the device log misses its accuracy contract")
    return {"ulp": rel, "abs": absolute, "vs_model": vs_model}


def _grads(fn, model, pts, kernel, dist2=None, gate=None, cot=None):
    """(d sum(out^2) / d(w_rbf, points), out) through fn (evaluate_cuda_diff's
    argument order), radius = rate = 1; all vertices active unless a
    capture dist2 / gate is given.  cot replaces the cotangent 2 out."""
    from facedeform_tpu_torch.config import PolyTerm
    from facedeform_tpu_torch.ops.fit import RBFModel

    w = model.w_rbf.detach().clone().requires_grad_()
    p = pts.detach().clone().requires_grad_()
    v = pts.shape[0]
    dist2 = torch.zeros(v, device=pts.device) if dist2 is None else dist2
    gate = torch.ones(v, device=pts.device) if gate is None else gate
    out, _ = fn(RBFModel(ctrl=model.ctrl, w_rbf=w, w_poly=model.w_poly, eps=model.eps), p,
                dist2, gate, 1.0, 1.0, None, kernel, PolyTerm.LINEAR)
    cot = 2.0 * out.detach() if cot is None else cot
    return torch.autograd.grad(out, (w, p), grad_outputs=cot), out.detach()


def _grad_rel_errs(got, want) -> list:
    """Normwise relative gradient errors max|dg| / max|g|, one per input."""
    return [float(torch.max(torch.abs(g - h)) / torch.max(torch.abs(h)))
            for g, h in zip(got, want)]


def _plain_diff(model, points, dist2, gate, radius, rate, frame, kernel, term):
    from facedeform_tpu_torch.ops import cuda_eval

    return cuda_eval.evaluate_reference(model, points, dist2, gate, radius, rate, kernel,
                                        term, frame=frame)


def check_diff_kernel(dev) -> float:
    """Phase 3e: evaluate_cuda_diff (dense kernel forward, plain backward)
    against autograd through the plain twin at 65536 x 1000, gaussian and
    TPS: gradients w.r.t. w_rbf and points; returns the worst normwise
    relative error max|dg| / max|g|."""
    from facedeform_tpu_torch.config import RBFKernel
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points
    from facedeform_tpu_torch.ops import cuda_eval

    rng = np.random.default_rng(5)
    pts = torch.as_tensor(fibonacci_points(65536) * 1.05, device=dev)
    worst = 0.0
    for kernel in (RBFKernel.GAUSSIAN, RBFKernel.THIN_PLATE):
        model = _synthetic_model(1000, 1, kernel, rng, dev)
        got, _ = _grads(cuda_eval.evaluate_cuda_diff, model, pts, kernel)
        want, _ = _grads(_plain_diff, model, pts, kernel)
        torch.cuda.synchronize()
        errs = _grad_rel_errs(got, want)
        _check(max(errs) <= GRAD_RTOL and all(bool(torch.isfinite(g).all()) for g in got),
               f"diff {kernel.name}: relative |dgrad| w_rbf {errs[0]:.3e}, points "
               f"{errs[1]:.3e} (tol {GRAD_RTOL:g})")
        worst = max(worst, *errs)
        print(f"  diff {kernel.name:20s} 65536 x 1000: max|dg|/max|g| w_rbf {errs[0]:.3e}, "
              f"points {errs[1]:.3e}", flush=True)
    print(f"diff (custom-VJP) checks: gradients within {GRAD_RTOL:g} normwise of autograd "
          f"through the plain twin; worst {worst:.3e}", flush=True)
    return worst


def _oracle_kernel_disp(rest, deformed, pts, kernel, eps, lam):
    """Float64 KERNEL-mode fit (global radius, ridge, linear tail, the
    -1e-8 tail block) and field, written out independently of the port."""
    ctrl = rest.double()
    n = ctrl.shape[0]
    d2 = ((ctrl[:, None] - ctrl[None]) ** 2).sum(-1)
    ones = torch.ones(n, 1, dtype=ctrl.dtype, device=ctrl.device)
    p = torch.cat([ones, ctrl], 1)
    a = torch.zeros(n + 4, n + 4, dtype=ctrl.dtype, device=ctrl.device)
    a[:n, :n] = _phi64(kernel, d2, eps) + lam * torch.eye(n, dtype=ctrl.dtype,
                                                          device=ctrl.device)
    a[:n, n:] = p
    a[n:, :n] = p.T
    a[n:, n:] = -1e-8 * torch.eye(4, dtype=ctrl.dtype, device=ctrl.device)
    b = torch.cat([deformed.double() - ctrl, torch.zeros(4, 3, dtype=ctrl.dtype,
                                                          device=ctrl.device)])
    x = torch.linalg.solve(a, b)
    q = pts.double()
    dq = ((q[:, None] - ctrl[None]) ** 2).sum(-1)
    pq = torch.cat([torch.ones(len(q), 1, dtype=q.dtype, device=q.device), q], 1)
    return _phi64(kernel, dq, eps) @ x[:n] + pq @ x[n:]


def main_path_precise(dev, label: str) -> dict:
    """Phase 6: slice C's main path at full width, growing kernels: TPS and
    MQ Deformer.fit of 4096 controls and apply("auto") on the 1M-vertex
    sphere with a capture d2, a tangent frame and a group gate; a 4-pose
    TPS shot through batched.deform_frames; one gradient through
    evaluate_cuda_diff; with launch counters read around it, float64
    oracles and single-pose cross-checks."""
    from facedeform_tpu_torch import DeformConfig, DeformParams, Deformer
    from facedeform_tpu_torch.config import PolyTerm, RBFKernel, RBFModelType
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points, uv_sphere
    from facedeform_tpu_torch.ops import cuda_eval, cuda_precise
    from facedeform_tpu_torch.parallel import batched

    rng = np.random.default_rng(0)
    n_ctrl, n_frames = 4096, 4
    rest = fibonacci_points(n_ctrl)
    deformed = rest + 0.05 * rng.standard_normal((n_ctrl, 3)).astype(np.float32)
    shot = rest + 0.05 * rng.standard_normal((n_frames, n_ctrl, 3)).astype(np.float32)
    params = DeformParams(radius=1.0, lam=0.01)
    cfgs = {k: DeformConfig(model=RBFModelType.KERNEL, kernel=k, term=PolyTerm.LINEAR,
                            solver="direct", tangent=True)
            for k in (RBFKernel.THIN_PLATE, RBFKernel.MULTIQUADRIC)}
    pts = torch.as_tensor(uv_sphere(1000, 1000).points, device=dev)
    v = pts.shape[0]
    cap_d2 = torch.sum((pts - torch.tensor([0.0, 1.0, 0.0], device=dev)) ** 2, -1)
    mask = pts[:, 0] > -0.6
    frame = _sphere_frame(pts)
    n_diff = 65536

    counters = (cuda_precise.evaluate_cuda_precise, cuda_precise.evaluate_cuda_precise_frames,
                cuda_eval.evaluate_cuda_diff)
    since = profiling.counters()
    per_apply = {}
    deformers, outs = {}, {}
    t0 = time.perf_counter()
    for kernel, cfg in cfgs.items():
        before = profiling.counters()
        deformers[kernel] = Deformer.fit(rest, deformed, cfg, params, device=dev)
        outs[kernel] = deformers[kernel].apply(pts, dist2=cap_d2, frame=frame, group_mask=mask)
        per_apply[kernel.name] = _launch_counts(
            (cuda_precise.evaluate_cuda_precise,), before)["evaluate_cuda_precise"]
    shot_model, _ = batched.fit_frames(rest, shot, cfgs[RBFKernel.THIN_PLATE], params,
                                       device=dev)
    shot_out, shot_w = batched.apply_frames(shot_model, pts, cap_d2, mask.float(),
                                            cfgs[RBFKernel.THIN_PLATE], params, frame=frame)
    tps = deformers[RBFKernel.THIN_PLATE]
    grad_args = (tps.model, pts[:n_diff], RBFKernel.THIN_PLATE, cap_d2[:n_diff],
                 mask[:n_diff].float())
    grads, grad_out = _grads(cuda_eval.evaluate_cuda_diff, *grad_args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts(counters, since)
    print(f"slice C main path: {wall:.3f} s wall (TPS and MQ fits of {n_ctrl} controls, "
          f"apply('auto') at {v} verts, a {n_frames}-pose TPS shot, one gradient at "
          f"{n_diff} verts); launches {launches}, precise per apply('auto') {per_apply}  "
          f"[{label}]", flush=True)
    _check(all(c == 1 for c in per_apply.values()),
           f"apply('auto') must launch the precise kernel exactly once: {per_apply}")
    fb = cuda_precise.PRECISE_FRAMES_PER_LAUNCH
    _check(launches["evaluate_cuda_precise"] == 2,
           "only the two apply('auto') calls take single-pose precise launches")
    _check(launches["evaluate_cuda_precise_frames"] == -(-n_frames // fb),
           f"the {n_frames}-pose shot must take ceil({n_frames} / {fb}) precise frames launches")
    _check(launches["evaluate_cuda_diff"] == 1,
           "the gradient must launch evaluate_cuda_diff's kernel exactly once")
    _check(all(bool(torch.isfinite(g).all()) for g in grads), "gradients not finite")
    # the forward is kernel #1's output; the backward is the plain twin's
    # VJP on the same inputs at that output's cotangent.  (Against autograd
    # of the plain forward, the f32 forward's own error on this fitted TPS
    # model, ~2e-4 from float64, would be what is compared.)
    fwd_equal = bool(torch.equal(grad_out, cuda_eval.evaluate_cuda(
        tps.model, pts[:n_diff].contiguous(), cap_d2[:n_diff].contiguous(),
        mask[:n_diff].float(), 1.0, 1.0, RBFKernel.THIN_PLATE, PolyTerm.LINEAR)[0]))
    plain, _ = _grads(_plain_diff, *grad_args, cot=2.0 * grad_out)
    grad_errs = _grad_rel_errs(grads, plain)
    print(f"main-path gradient (TPS {n_diff} x {n_ctrl}, capture d2 and group gate): forward "
          f"equal to the dense kernel's {fwd_equal}; vs the plain twin's VJP at the same "
          f"cotangent max|dg|/max|g| w_rbf {grad_errs[0]:.3e}, points {grad_errs[1]:.3e} "
          f"(tol {GRAD_RTOL:g})")
    _check(fwd_equal and max(grad_errs) <= GRAD_RTOL,
           "the main-path gradient disagrees with the plain twin")

    idx = torch.linspace(0, v - 1, 4096, device=dev).long()
    sub_frame = tuple(f[idx] for f in frame)
    w64 = torch.clamp(1.0 - torch.clamp(cap_d2[idx].double(), 0.0, 1.0), min=0.0) * mask[idx]
    errs = {}
    for kernel, d in deformers.items():
        be = float(d.report.backward_error())
        out, w = outs[kernel]
        print(f"{kernel.name} fit@{n_ctrl}: backward error {be:.3e} (cond est "
              f"{float(d.report.cond_est):.3e})")
        _check(be <= BACKWARD_TOL, f"{kernel.name} backward error {be:.3e} > {BACKWARD_TOL:g}")
        _check(tuple(out.shape) == (v, 3) and bool(torch.isfinite(out).all()),
               f"{kernel.name} output not finite of shape (V, 3)")
        _check(bool(torch.equal(out[~mask], pts[~mask])), f"{kernel.name}: gated rows moved")
        # the kernel's whole output against its plain twin on the same inputs
        cfg, prm = d.cfg, d.params.clamped()
        want_p, want_w = cuda_precise.evaluate_precise_reference(
            d.model, pts, cap_d2, mask.float(), prm.radius, prm.falloffrate, kernel, cfg.term,
            strict_parity=cfg.strict_parity, frame=frame)
        dp = float(torch.max(torch.abs(out - want_p)))
        dw = float(torch.max(torch.abs(w - want_w)))
        print(f"{kernel.name} apply('auto') at {v} x {n_ctrl} vs the plain twin: max |dpos| "
              f"{dp:.3e} (tol {PRECISE_POS_TOL:g}), max |dfalloff| {dw:.3e} "
              f"(tol {FALLOFF_TOL:g})")
        _check(dp <= PRECISE_POS_TOL and dw <= FALLOFF_TOL,
               f"{kernel.name} apply('auto') disagrees with the plain twin")
        disp = _oracle_kernel_disp(torch.as_tensor(rest, device=dev),
                                   torch.as_tensor(deformed, device=dev), pts[idx], kernel,
                                   1.0, 0.01)
        want = _project64(sub_frame, disp) * w64[:, None]
        errs[kernel.name] = float(torch.max(torch.abs((out[idx] - pts[idx]).double() - want)))
        print(f"oracle ({kernel.name} 1M x {n_ctrl}, 4096-vertex subset): max displacement "
              f"error {errs[kernel.name]:.3e} (budget {ORACLE_BUDGET:g})")
        _check(errs[kernel.name] <= ORACLE_BUDGET, f"{kernel.name} misses the oracle budget")

    # each shot frame against the single-pose precise kernel path
    _check(tuple(shot_out.shape) == (n_frames, v, 3) and bool(torch.isfinite(shot_out).all()),
           "shot output not finite of shape (F, V, 3)")
    # ... first the single-pose launch of the same frame's weights, bit for bit
    zeros = torch.zeros(v, device=dev)
    equal = [bool(torch.equal(shot_out[f], cuda_precise.evaluate_cuda_precise(
        cuda_eval.frame_model(shot_model, f), pts, zeros, shot_w, 1.0, 1.0,
        RBFKernel.THIN_PLATE, PolyTerm.LINEAR, frame=frame)[0])) for f in range(n_frames)]
    print(f"TPS shot at {v} x {n_ctrl} x {n_frames}: "
          f"{launches['evaluate_cuda_precise_frames']} frames launch(es) of up to {fb} frames; "
          f"every frame equal to its single-pose launch bit for bit: {equal}")
    _check(all(equal), "a shot frame differs from its single-pose precise launch")
    worst, worst_twin = 0.0, 0.0
    cfg = cfgs[RBFKernel.THIN_PLATE]
    prm = params.clamped()
    for f in range(n_frames):
        d = Deformer.fit(rest, shot[f], cfg, params, device=dev)
        single, single_w = d.apply(pts[idx], dist2=cap_d2[idx], frame=sub_frame,
                                   group_mask=mask[idx], backend="cuda_precise")
        worst = max(worst, float(torch.max(torch.abs(shot_out[f, idx] - single))))
        _check(bool(torch.equal(single_w, shot_w[idx])), f"shot frame {f}: falloff differs")
        twin, _ = cuda_precise.evaluate_precise_reference(
            d.model, pts[idx], cap_d2[idx], mask[idx].float(), prm.radius, prm.falloffrate,
            RBFKernel.THIN_PLATE, cfg.term, strict_parity=cfg.strict_parity, frame=sub_frame)
        worst_twin = max(worst_twin, float(torch.max(torch.abs(shot_out[f, idx] - twin))))
    print(f"TPS shot frames vs single-pose Deformer.apply(backend='cuda_precise'), "
          f"4096-vertex subset: max |d| {worst:.3e} (tol {SHOT_VS_SINGLE_TOL:g}); vs the "
          f"single-pose model's plain twin {worst_twin:.3e} (tol {PRECISE_POS_TOL:g})")
    _check(worst <= SHOT_VS_SINGLE_TOL, "a shot frame disagrees with the single-pose path")
    _check(worst_twin <= PRECISE_POS_TOL, "a shot frame disagrees with the plain twin")

    # the shared-factorization route forced (budget 0): the per-pose route's
    # model, lo words included, bit for bit; every frame against the oracle
    budget = batched.vmap_fit_hbm_budget
    batched.vmap_fit_hbm_budget = 0.0
    try:
        shared, _ = batched.fit_frames(rest, shot, cfg, params, device=dev)
    finally:
        batched.vmap_fit_hbm_budget = budget
    same = {k: getattr(shared, k) is not None and bool(torch.equal(getattr(shared, k),
                                                                   getattr(shot_model, k)))
            for k in ("ctrl", "w_rbf", "w_poly", "eps", "w_rbf_lo", "w_poly_lo")}
    sh_out, _ = batched.apply_frames(shared, pts[idx], cap_d2[idx], mask[idx].float(), cfg,
                                     params, frame=sub_frame)
    err_sh = 0.0
    for f in range(n_frames):
        disp = _oracle_kernel_disp(torch.as_tensor(rest, device=dev),
                                   torch.as_tensor(shot[f], device=dev), pts[idx],
                                   RBFKernel.THIN_PLATE, 1.0, 0.01)
        want = _project64(sub_frame, disp) * w64[:, None]
        err_sh = max(err_sh, float(torch.max(torch.abs((sh_out[f] - pts[idx]).double() - want))))
    print(f"TPS shot through the forced shared route: model equal to the per-pose route's bit "
          f"for bit {same}; oracle, 4096-vertex subset, every frame: max displacement error "
          f"{err_sh:.3e} (budget {ORACLE_BUDGET:g})")
    _check(all(same.values()) and err_sh <= ORACLE_BUDGET,
           "the shared route's growing-kernel shot differs from the per-pose route or the oracle")
    return {"launches": launches, "deformers": deformers, "points": pts, "rest": rest,
            "deformed": deformed, "params": params, "cfgs": cfgs, "shot_equal": all(equal)}


def time_precise(main_c: dict, label: str) -> list:
    """Phase 7c: the precise kernel against its plain twin and against the
    f32 dense kernel on the same TPS model, at 1M x 4096 and 1M x 1000;
    Deformer.fit at 4096 (TPS, MQ); #4 forward + backward against autograd
    through the plain twin at 65536 x 1000."""
    from facedeform_tpu_torch import Deformer
    from facedeform_tpu_torch.benchmark import stats, time_cuda
    from facedeform_tpu_torch.config import PolyTerm, RBFKernel
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points
    from facedeform_tpu_torch.ops import cuda_eval, cuda_precise
    from facedeform_tpu_torch.ops import fit as fit_mod

    pts, params, cfgs = main_c["points"], main_c["params"], main_c["cfgs"]
    dev = pts.device
    v = pts.shape[0]
    d2 = torch.zeros(v, device=dev)
    gate = torch.ones(v, device=dev)
    tps = RBFKernel.THIN_PLATE
    cfg = cfgs[tps]
    rng = np.random.default_rng(6)
    r1k = fibonacci_points(1000)
    d1k = Deformer.fit(r1k, r1k + 0.05 * rng.standard_normal((1000, 3)).astype(np.float32),
                       cfg, params, device=dev)
    res = {}
    for n_ctrl, model in ((4096, main_c["deformers"][tps].model), (1000, d1k.model)):
        args = (model, pts, d2, gate, 1.0, 1.0, tps, PolyTerm.LINEAR)
        fns = {"precise": lambda: cuda_precise.evaluate_cuda_precise(*args),
               "f32 dense": lambda: cuda_eval.evaluate_cuda(*args),
               "precise plain": lambda: cuda_precise.evaluate_precise_reference(*args)}
        t = {k: stats(x) for k, x in time_cuda(fns, rounds=3, iters={
            "precise": 5, "f32 dense": 5, "precise plain": 1}).items()}
        want, _ = cuda_precise.evaluate_precise_reference(*args)
        err = float(torch.max(torch.abs(fns["precise"]()[0] - want)))
        _check(err <= PRECISE_POS_TOL,
               f"precise kernel at {v} x {n_ctrl}: |dpos| {err:.3e} vs the plain twin")
        for k, x in t.items():
            print(_fmt(f"{k} (TPS)", x, f" at {v} x {n_ctrl}  [{label}]"))
        print(f"precise kernel at {v} x {n_ctrl}: {t['precise plain'][0] / t['precise'][0]:.2f}x "
              f"the plain twin, {t['precise'][0] / t['f32 dense'][0]:.3f}x the f32 dense "
              f"kernel's time; max |d| vs twin {err:.3e}")
        res[n_ctrl] = (t, err)

    # the shot's frames launches against F single-pose launches, in the
    # same interleaved rounds, on a fitted 8-pose TPS shot at 1M x 4096
    from facedeform_tpu_torch.parallel import batched

    rest = main_c["rest"]
    poses = rest + 0.05 * rng.standard_normal((8,) + rest.shape).astype(np.float32)
    shot8, _ = batched.fit_frames(rest, poses, cfg, params, device=dev)
    eval_args = (pts, d2, gate, 1.0, 1.0, tps, PolyTerm.LINEAR)
    shot_t = {}
    for nf in (4, 8):
        sub = cuda_eval.frame_model(shot8, slice(0, nf))
        singles = [cuda_eval.frame_model(sub, f) for f in range(nf)]
        fns = {f"frames x{nf}": lambda sub=sub: cuda_precise.evaluate_cuda_precise_frames(
                   sub, *eval_args),
               f"single x{nf}": lambda singles=singles: [
                   cuda_precise.evaluate_cuda_precise(m, *eval_args) for m in singles]}
        if nf == 4:
            fns["frames plain x4"] = lambda sub=sub: (
                cuda_precise.evaluate_precise_frames_reference(sub, *eval_args))
        else:
            # the same 8 frames as two FB = 4 launches: is FB = 8 worth its registers?
            halves = tuple(cuda_eval.frame_model(sub, slice(f, f + 4)) for f in (0, 4))
            fns["frames 2 x4"] = lambda halves=halves: [
                cuda_precise.evaluate_cuda_precise_frames(h, *eval_args) for h in halves]
        shot_t.update({k: stats(x) for k, x in time_cuda(fns, rounds=3, iters={
            f"frames x{nf}": 3, f"single x{nf}": 2, "frames plain x4": 1,
            "frames 2 x4": 3}).items()})
        print(_fmt(f"precise frames launch, {nf} poses (TPS)", shot_t[f"frames x{nf}"],
                   f" at {v} x 4096 x {nf}  [{label}]"))
        print(_fmt(f"{nf} single-pose precise launches (TPS)", shot_t[f"single x{nf}"],
                   f" at {v} x 4096  [{label}]"))
        print(f"precise frames launch vs {nf} single-pose launches: "
              f"{shot_t[f'frames x{nf}'][0] / shot_t[f'single x{nf}'][0]:.3f}x the time "
              f"(best of each)  [{label}]", flush=True)
    print(_fmt("8 poses as two 4-frame launches (TPS)", shot_t["frames 2 x4"],
               f" at {v} x 4096 x 8  [{label}]"))
    print(_fmt("precise frames plain twin, 4 poses (TPS)", shot_t["frames plain x4"],
               f" at {v} x 4096 x 4  [{label}]"))
    sub4 = cuda_eval.frame_model(shot8, slice(0, 4))
    want4, _ = cuda_precise.evaluate_precise_frames_reference(sub4, *eval_args)
    e_frames = float(torch.max(torch.abs(
        cuda_precise.evaluate_cuda_precise_frames(sub4, *eval_args)[0] - want4)))
    _check(e_frames <= PRECISE_POS_TOL,
           f"precise frames launch at {v} x 4096 x 4: |dpos| {e_frames:.3e} vs the twin")
    time_precise_bases(dev, label)

    r_dev = torch.as_tensor(main_c["rest"], device=dev)
    f_dev = torch.as_tensor(main_c["deformed"], device=dev)
    fits = {f"fit {k.name}": (lambda c=c: fit_mod.fit(r_dev, f_dev, c, params))
            for k, c in cfgs.items()}
    for k, x in time_cuda(fits, rounds=3, iters=1).items():
        print(_fmt(k, stats(x), f" at {r_dev.shape[0]} controls (float64 assembly, "
                                f"GMRES-IR)  [{label}]"))

    # #4: forward + backward at 65536 x 1000, gaussian
    from facedeform_tpu_torch.ops.fit import RBFModel

    sub = pts[:65536].contiguous()
    gmodel = RBFModel(ctrl=d1k.model.ctrl, w_rbf=d1k.model.w_rbf,
                      w_poly=d1k.model.w_poly, eps=d1k.model.eps * 0.3)
    gauss = RBFKernel.GAUSSIAN
    zeros_d, ones_d = torch.zeros(sub.shape[0], device=dev), torch.ones(sub.shape[0], device=dev)
    dfns = {"diff fwd+bwd": lambda: _grads(cuda_eval.evaluate_cuda_diff, gmodel, sub, gauss),
            "plain fwd+bwd": lambda: _grads(_plain_diff, gmodel, sub, gauss),
            # the forward alone: kernel #1 (no input needs a gradient)
            "diff forward": lambda: cuda_eval.evaluate_cuda_diff(
                gmodel, sub, zeros_d, ones_d, 1.0, 1.0, None, gauss, PolyTerm.LINEAR)}
    dt = {k: stats(x) for k, x in time_cuda(dfns, rounds=3, iters=3).items()}
    got, want = dfns["diff fwd+bwd"]()[0], dfns["plain fwd+bwd"]()[0]
    err_diff = max(float(torch.max(torch.abs(g - h))) for g, h in zip(got, want))
    rel_diff = _grad_rel_errs(got, want)
    print(f"diff at 65536 x 1000 (gaussian): max |dg| {err_diff:.3e}, max|dg|/max|g| "
          f"w_rbf {rel_diff[0]:.3e}, points {rel_diff[1]:.3e} (tol {GRAD_RTOL:g})")
    _check(max(rel_diff) <= GRAD_RTOL, "timed diff gradients disagree with the plain twin")
    for k, x in dt.items():
        print(_fmt(k, x, f" (gaussian) at 65536 x 1000  [{label}]"))
    t4k, e4k = res[4096]
    n_d, v_d = 1000, sub.shape[0]
    # the forward is #1's kernel: its operations and bytes (time_kernels)
    fwd = _bound(36 * v_d + 28 * n_d + 48, (17 * v_d * n_d, PEAK_F32))
    print(f"diff at 65536 x 1000: the kernel forward {dt['diff forward'][0]:.4f} ms (bound "
          f"{fwd['bound_ms']:.4f} ms by {fwd['bound_by']}), the plain backward "
          f"{dt['diff fwd+bwd'][0] - dt['diff forward'][0]:.4f} ms (fwd+bwd minus forward, "
          f"best of each)  [{label}]")
    return [
        # fp64, per pair: d2 8, s 1, TPS phi 5, 3 FMAs 6; bytes: points,
        # dist2, gate, out, falloff; ctrl, w hi + lo, eps
        {"name": "eval_precise", "route": "cuda",
         "source": "facedeform_tpu_torch/csrc/precise.cu",
         "replaces": "facedeform_tpu/ops/pallas_precise.py:231",
         "launches": main_c["launches"]["evaluate_cuda_precise"], "max_abs_err": e4k,
         "ms": t4k["precise"][0], "plain_ms": t4k["precise plain"][0],
         **_bound(36 * v + 40 * 4096, (20 * v * 4096, PEAK_F64)), "library_ms": None},
        # fp64, per pair: d2, s and phi once (14 as above) at the fp64
        # rate, the contraction's 3 FMAs a frame (6F) at the fp64 tensor-core
        # rate, since a (V x N) . (N x 3F) product of F >= 4 can run as
        # DMMA; bytes: points, dist2, gate, falloff, (F, V, 3) out; ctrl,
        # eps, F frames of w hi + lo, F tails
        {"name": "eval_precise_frames", "route": "cuda",
         "source": "facedeform_tpu_torch/csrc/precise.cu",
         "replaces": "facedeform_tpu/ops/pallas_precise.py:231",
         "launches": main_c["launches"]["evaluate_cuda_precise_frames"],
         "max_abs_err": e_frames, "ms": shot_t["frames x4"][0],
         "plain_ms": shot_t["frames plain x4"][0],
         **_bound((24 + 12 * 4) * v + (16 + 24 * 4) * 4096 + 96 * 4,
                  (14 * v * 4096, PEAK_F64), (6 * 4 * v * 4096, PEAK_F64_TC)),
         "library_ms": None},
        # forward 17 per pair, backward ~22 (w: 3 FMAs; points: w.cot, phi',
        # scale, 3 FMAs); bytes: the forward's, the cotangent, both gradients
        {"name": "eval_diff", "route": "cuda",
         "source": "facedeform_tpu_torch/csrc/eval.cu",
         "replaces": "facedeform_tpu/ops/pallas_eval.py:920",
         "launches": main_c["launches"]["evaluate_cuda_diff"], "max_abs_err": err_diff,
         "ms": dt["diff fwd+bwd"][0], "plain_ms": dt["plain fwd+bwd"][0],
         **_bound(60 * v_d + 40 * n_d, (39 * v_d * n_d, PEAK_F32)), "library_ms": None},
    ]


def time_precise_bases(dev, label: str) -> dict:
    """Phase 7c: the single-pose precise launch at 1M x 4096 for TPS, MQ,
    linear and cubic (Deformer.fit of 4096 Fibonacci controls per basis,
    KERNEL mode, every vertex active), in interleaved rounds; the TPS -
    linear gap is the log's cost.  Returns {basis: (best, median, spread)}."""
    from facedeform_tpu_torch import DeformConfig, DeformParams, Deformer
    from facedeform_tpu_torch.benchmark import stats, time_cuda
    from facedeform_tpu_torch.config import PolyTerm, RBFModelType
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points, uv_sphere
    from facedeform_tpu_torch.ops import cuda_precise
    from facedeform_tpu_torch.ops.fit import GROWING_KERNELS

    rng = np.random.default_rng(7)
    n_ctrl = 4096
    rest = fibonacci_points(n_ctrl)
    deformed = rest + 0.05 * rng.standard_normal((n_ctrl, 3)).astype(np.float32)
    pts = torch.as_tensor(uv_sphere(1000, 1000).points, device=dev)
    v = pts.shape[0]
    d2, gate = torch.zeros(v, device=dev), torch.ones(v, device=dev)
    fns = {}
    for kernel in GROWING_KERNELS:
        cfg = DeformConfig(model=RBFModelType.KERNEL, kernel=kernel, term=PolyTerm.LINEAR,
                           solver="direct")
        model = Deformer.fit(rest, deformed, cfg, DeformParams(radius=1.0, lam=0.01),
                             device=dev).model
        fns[kernel.name] = (lambda m=model, k=kernel: cuda_precise.evaluate_cuda_precise(
            m, pts, d2, gate, 1.0, 1.0, k, PolyTerm.LINEAR))
    t = {k: stats(x) for k, x in time_cuda(fns, rounds=5, iters=5).items()}
    for k, x in t.items():
        print(_fmt(f"precise {k}", x, f" at {v} x {n_ctrl}, one pose  [{label}]"))
    print(f"precise TPS - LINEAR (the log's cost): "
          f"{t['THIN_PLATE'][0] - t['LINEAR'][0]:.4f} ms  [{label}]", flush=True)
    return t


def _bump_rig(n, centers=((0, 1, 0),)):
    """fibonacci_points(n) and, per center c, the displacement
    0.1 exp(-3 |x - c|^2) y (the JAX package's PU benchmark rigs,
    benchmarks/run_all.py configs 9 and 10): (rest, (F, n, 3) poses)."""
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points

    rest = fibonacci_points(n)
    frames = np.stack([
        rest + (0.1 * np.exp(-3 * np.sum((rest - np.float32(c)) ** 2, -1, keepdims=True))
                ).astype(np.float32) * np.float32([0, 1, 0])
        for c in centers])
    return rest, frames


def _unit_dirs(n, rng):
    d = rng.standard_normal((n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def check_pu_kernel(dev) -> float:
    """Phase 3f: the PU tile kernel against its plain twin on fitted models:
    TPS, gaussian, MQ and Wendland bases x LINEAR, CONSTANT and ZERO tails,
    F in {1, 2, 3, 4, 8, 16, 17} (every NT in {0, 1, 2, 3, 6}; 17 takes two
    launches), at a ragged V = 70002 + 200 far points (radius 1.6, forced
    nearest-patch fallback) + one point in each patch's coverage-margin
    shell (0.99995 R), every frame of the F = 16 launch against its
    single-pose launch; plus a rig with ragged patch widths (P not a
    multiple of 8), a single-patch rig, and one case against the plain f32
    evaluate_pu.  Returns the worst relative |d| (the 3xTF32 contraction's
    error against the twin)."""
    from facedeform_tpu_torch.config import PolyTerm, RBFKernel
    from facedeform_tpu_torch.geometry.primitives import uv_sphere
    from facedeform_tpu_torch.ops import cuda_pu, pu

    rng = np.random.default_rng(8)
    worst_single, all_same2 = 0.0, True
    sphere = uv_sphere(250, 280).points                       # V = 70002, ragged
    rest, frames = _bump_rig(3000, _unit_dirs(17, rng))
    patches = pu.build_patches(rest)
    ray = np.float32([0.6, 0.8, 0.0])
    shell = (patches.centers + ray * patches.radii[:, None] * 0.99995).astype(np.float32)
    pts_np = np.concatenate([sphere, _unit_dirs(200, rng) * 1.6, shell])
    pts = torch.as_tensor(pts_np, device=dev)
    tplan = cuda_pu.plan_eval_tiles(patches, pts_np)
    n_forced = int((tplan.forced_patch >= 0).sum())
    worst, n_cases = 0.0, 0
    grid = [(k, t) for k in (RBFKernel.THIN_PLATE, RBFKernel.GAUSSIAN, RBFKernel.MULTIQUADRIC,
                             RBFKernel.WENDLAND_C2)
            for t in (PolyTerm.LINEAR, PolyTerm.CONSTANT, PolyTerm.ZERO)]
    for kernel, term in grid:
        models, rep = pu.fit_pu_frames(rest, frames, kernel, term, lam=1e-5, patches=patches,
                                       device=dev)
        _check(float(rep.backward_error()) < PU_BACKWARD_TOL,
               f"pu fit {kernel.name} {term.name}: backward error {float(rep.backward_error()):.3e}")
        args = (pts, tplan, kernel)
        want = cuda_pu.evaluate_pu_tiles_reference(models, *args)
        scale = float(want.abs().max())
        errs, got16 = [], None
        for n_frames in PU_CHECK_FRAMES:  # nf = 1: the one-pose (CUDA-core) path
            got = cuda_pu.evaluate_pu_tiles_frames(models[:n_frames], *args)
            torch.cuda.synchronize()
            e = float((got - want[:n_frames]).abs().max()) / scale
            _check(tuple(got.shape) == (n_frames, len(pts_np), 3) and e <= PU_TOL,
                   f"pu {kernel.name} {term.name} F={n_frames}: |d| / max|disp| {e:.3e} "
                   f"(tol {PU_TOL:g})")
            errs.append(e)
            n_cases += 1
            if n_frames == 16:
                got16 = got
        # every frame of the F = 16 launch against its single-pose launch
        # (CUDA cores), and bit for bit against the F = 2 launch of it and
        # the next frame (the same tensor-core passes)
        d_single = max(float((got16[f] - cuda_pu.evaluate_pu_tiles(models[f], *args)).abs().max())
                       for f in range(16))
        same2 = all(bool(torch.equal(got16[f], cuda_pu.evaluate_pu_tiles_frames(
            models[f:f + 2], *args)[0])) for f in range(15))
        _check(d_single <= FRAME_VS_SINGLE_TOL and same2,
               f"pu {kernel.name} {term.name}: a frame of the F=16 launch differs from its "
               f"single-pose launch by {d_single:.3e}; equal to its F=2 launch {same2}")
        worst_single = max(worst_single, d_single)
        all_same2 = all_same2 and same2
        worst = max(worst, *errs)
        print(f"  pu {kernel.name:12s} {term.name:8s} K={len(patches.radii)} P={patches.idx.shape[1]} "
              f"|d|/max|disp| F={'/'.join(map(str, PU_CHECK_FRAMES))} "
              + " ".join(f"{e:.2e}" for e in errs)
              + f"; F=16 frames vs single-pose max |d| {d_single:.3e}, vs F=2 launches "
              f"bit for bit {same2}", flush=True)
    # ragged patch widths: P and the live counts not multiples of 8
    pr = pu.build_patches(rest, width_bucket=1)
    planr = cuda_pu.plan_eval_tiles(pr, pts_np)
    mr, _ = pu.fit_pu_frames(rest, frames[:4], RBFKernel.THIN_PLATE, lam=1e-5, patches=pr,
                             device=dev)
    argsr = (pts, planr, RBFKernel.THIN_PLATE)
    wantr = cuda_pu.evaluate_pu_tiles_reference(mr, *argsr)
    er = max(float((cuda_pu.evaluate_pu_tiles_frames(mr[:nf], *argsr) - wantr[:nf]).abs().max())
             for nf in (1, 3)) / float(wantr.abs().max())
    _check(pr.idx.shape[1] % 8 != 0 and er <= PU_TOL,
           f"pu ragged P={pr.idx.shape[1]}: {er:.3e}")
    worst = max(worst, er)
    n_cases += 2
    # a single-patch rig (N <= patch_size: K = 1, every far point forced)
    r1, f1 = _bump_rig(150, ((0, 1, 0), (1, 0, 0), (0, 0, 1)))
    p1 = pu.build_patches(r1)
    m1, _ = pu.fit_pu_frames(r1, f1, RBFKernel.THIN_PLATE, lam=1e-5, patches=p1, device=dev)
    plan1 = cuda_pu.plan_eval_tiles(p1, pts_np)
    args1 = (pts, plan1, RBFKernel.THIN_PLATE)
    want1 = cuda_pu.evaluate_pu_tiles_reference(m1, *args1)
    got1 = cuda_pu.evaluate_pu_tiles_frames(m1, *args1)
    e1 = float((got1 - want1).abs().max()) / float(want1.abs().max())
    _check(len(p1.radii) == 1 and e1 <= PU_TOL, f"pu single patch: {e1:.3e}")
    worst = max(worst, e1)
    n_cases += 1
    # against the plain f32 composition (JAX's Mosaic-vs-XLA bound)
    models, _ = pu.fit_pu_frames(rest, frames[:1], RBFKernel.THIN_PLATE, lam=1e-5,
                                 patches=patches, device=dev)
    eplan = pu.plan_eval(patches, pts_np)
    plain = pu.evaluate_pu(models[0], pts, eplan.tiles_patch, eplan.tiles_vidx, eplan.forced,
                           RBFKernel.THIN_PLATE, PolyTerm.LINEAR, eplan.num_points,
                           precise=False)
    got = cuda_pu.evaluate_pu_tiles(models[0], pts, tplan, RBFKernel.THIN_PLATE)
    e_plain = float((got - plain).abs().max())
    _check(e_plain <= PU_PLAIN_TOL, f"pu kernel vs plain evaluate_pu: {e_plain:.3e}")
    print(f"pu kernel checks: {n_cases} cases within {PU_TOL:g} of max|disp| (worst 3xTF32 "
          f"error vs the twin {worst:.3e}; {n_forced} forced-fallback points, ragged P="
          f"{pr.idx.shape[1]} {er:.3e}, single-patch rig {e1:.3e}); vs plain f32 evaluate_pu "
          f"max |d| {e_plain:.3e} (tol {PU_PLAIN_TOL:g}); F=16 frames vs single-pose launches "
          f"max |d| {worst_single:.3e} (tol {FRAME_VS_SINGLE_TOL:g}), vs F=2 launches bit for "
          f"bit {all_same2}", flush=True)
    return worst


def _pu_field64(model, x, chunk=32):
    """The float64 PU field of a TPS + linear-tail model at float64 points
    (n, 3), written out: every patch whose support holds the point (0.9999
    margin), else the nearest relative to its radius; the controls' f32
    patch-centered coordinates as fitted, the points' offsets in float64
    (a smooth function of x for central differences)."""
    c = model.centers.double()
    rad = model.radii.double()
    lc = ((model.ctrl - model.centers[:, None]) * model.valid[..., None]).double()
    val = model.valid.double()
    w = model.w_hi.double() + model.w_lo.double()
    pl = model.poly_hi.double() + model.poly_lo.double()
    ie2 = 1.0 / model.eps.double() ** 2
    outs = []
    for xs in torch.split(x, chunk):
        xl = xs[:, None, :] - c[None]                               # (n, K, 3)
        t = torch.linalg.norm(xl, dim=-1) / rad
        wk = torch.clamp(1 - t, min=0) ** 4 * (4 * t + 1)
        near = torch.nn.functional.one_hot(torch.argmin(t, 1), c.shape[0]).double()
        wk = torch.where((t <= 0.9999).any(1)[:, None], wk, near)
        s = ((xl[:, :, None, :] - lc[None]) ** 2).sum(-1) * ie2[None, :, None]
        phi = torch.where(s > 0, 0.5 * s * torch.log(torch.clamp(s, min=1e-300)),
                          torch.zeros_like(s)) * val[None]
        sk = (torch.einsum("nkp,kpc->nkc", phi, w) + pl[None, :, 0]
              + torch.einsum("nkb,kbc->nkc", xl, pl[:, 1:4]))
        outs.append((wk[..., None] * sk).sum(1) / wk.sum(1, keepdim=True))
    return torch.cat(outs)


def _pu_pairs(model, pts, tplan, dev) -> tuple[int, int, int]:
    """(needed, per block, per warp): the live (point, control) pairs the
    tile kernel needs over the plan's items (the points whose partition
    weight is non-zero times the patch's live controls), and the pairs it
    computes when an item is skipped only where no point of its 256-point
    block needs it (a block-level skip: 256 x n_live) or where no point of
    a 32-point warp does (the kernel's warp-level skip: 32 x n_live rounded
    up to k-steps of 8 per warp that needs it)."""
    ip, iv, forced, perm, _, _ = tplan.device_arrays(dev)
    v, tv = tplan.num_points, tplan.tile_v
    pz = torch.zeros((forced.shape[0], 3), device=dev)
    pz[:v] = pts[perm.long()]
    live = model.valid.sum(1)
    p_ = model.valid.shape[1]
    n_live = ((model.valid > 0).long() * torch.arange(1, p_ + 1, device=dev)).amax(1)
    needed = block = warp = 0
    for s in range(0, ip.shape[0], 4096):
        k, vt = ip[s:s + 4096].long(), iv[s:s + 4096].long()
        lanes = vt[:, None] * tv + torch.arange(tv, device=dev)[None]
        d2 = ((pz[lanes] - model.centers[k][:, None]) ** 2).sum(-1)
        hit = ((d2 < model.radii[k][:, None] ** 2) | (forced[lanes] == k[:, None])) & (lanes < v)
        needed += int((hit.sum(1) * live[k]).sum())
        block += int((hit.any(1) * tv * n_live[k]).sum())
        warps = hit.reshape(hit.shape[0], tv // 32, 32).any(2).sum(1)
        warp += int((warps * 32 * (-(-n_live[k] // 8) * 8)).sum())
    return needed, block, warp


def _pu_bound(f, v, vp, k_, p_, n_items, pairs, tensor_cores: bool) -> dict:
    """The PU kernel's bound: per needed pair 3 differences, d2 5, s 1, TPS
    phi 5, x valid 1 at the f32 rate, and the contraction: on the tensor
    cores (a shot) 3 passes x 2 x the 3F columns it needs at the TF32 rate,
    beside the rest (their pipes overlap), or on the CUDA cores (one pose;
    the CUDA-core formula) 3F FMAs a pair at the f32 rate; bytes: points,
    perm, forced ids, items, offsets, ctrl, valid, (K, P, 3F) weights,
    tails, geometry, (F, V, 3) out."""
    n_bytes = (16 * v + 4 * vp + 4 * n_items + 4 * (vp // 256 + 1) + 16 * k_ * p_
               + 12 * f * k_ * p_ + 48 * f * k_ + 36 * k_ + 12 * f * v)
    if not tensor_cores:
        return _bound(n_bytes, ((15 + 6 * f) * pairs, PEAK_F32))
    return _bound(n_bytes, (15 * pairs, PEAK_F32), (6 * 3 * f * pairs, PEAK_TF32))


def _frames_bound(f, v, n, tensor_cores: bool = True) -> dict:
    """The frames kernel's bound at L = 1: per pair d2 8, s 1, exp(-s) 2 at
    the f32 rate, and the contraction on the tensor cores, 3 passes x 2 x
    the 3F columns it needs at the TF32 rate, beside the rest (their pipes
    overlap); or the CUDA-core formula (tensor_cores=False, the scalar
    kernel's): d2 8, s 1, exp 2 and 3F FMAs at the f32 rate; bytes:
    points, dist2, gate, falloff, (F, V, 3) out; ctrl, inv_eps2, (N, 3F)
    weights, tails."""
    n_bytes = 24 * v + 12 * f * v + 16 * n + 12 * f * n + 48 * f
    if not tensor_cores:
        return _bound(n_bytes, ((11 + 6 * f) * v * n, PEAK_F32))
    return _bound(n_bytes, (11 * v * n, PEAK_F32), (6 * 3 * f * v * n, PEAK_TF32))


def _jac_bound(f, v, n, tensor_cores: bool = True) -> dict:
    """The Jacobian kernel's bound at L = 1: per pair d2 8, s 1, phi' 2,
    the three D_b = phi' (c - x)_b 3 at the f32 rate, and the contraction
    on the tensor cores, 3 passes x 2 x the 9F (b, frame, a) columns it
    needs at the TF32 rate, beside the rest (their pipes overlap); or the
    CUDA-core formula (tensor_cores=False, the scalar kernel's): d2 8, s 1, phi'
    2, g 2 and per frame 3 x (mul, add, 3 FMAs) = 24 at the f32 rate;
    bytes: points, (F, V, 3, 3) out, ctrl, inv_eps2, (N, 3F) weights."""
    n_bytes = 12 * v + 36 * f * v + 16 * n + 12 * f * n
    if not tensor_cores:
        return _bound(n_bytes, ((13 + 24 * f) * v * n, PEAK_F32))
    return _bound(n_bytes, (14 * v * n, PEAK_F32), (6 * 9 * f * v * n, PEAK_TF32))


def main_path_pu(dev, label: str) -> dict:
    """Phase 6b: slice F's main path, one pose, at the JAX package's
    config 9: a 30k-control TPS rig (eps="auto", lam 1e-5),
    PUDeformer.fit on the card, displacement on the 1M-vertex sphere
    (one PU launch) and at the controls (one more), with launch counters
    read around it; the whole output against the plain twin, the float64
    plain tiles of the same model, and the Jacobian at 65536 vertices
    against a float64 central difference."""
    from facedeform_tpu_torch.config import RBFKernel
    from facedeform_tpu_torch.geometry.primitives import uv_sphere
    from facedeform_tpu_torch.ops import cuda_pu, pu

    rest, frames = _bump_rig(30000)
    disp = frames[0] - rest
    pts_np = uv_sphere(1000, 1000).points
    pts = torch.as_tensor(pts_np, device=dev)
    v = pts.shape[0]

    since = profiling.counters()
    t0 = time.perf_counter()
    d = pu.PUDeformer.fit(rest, frames[0], kernel=RBFKernel.THIN_PLATE, lam=1e-5, device=dev)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    out = d.displacement(pts)
    torch.cuda.synchronize()
    t_disp = time.perf_counter() - t0 - t_fit
    launches_mesh = _launch_counts((cuda_pu.evaluate_pu_tiles,), since)["evaluate_pu_tiles"]
    at_ctrl = d.displacement(rest)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts((cuda_pu.evaluate_pu_tiles,), since)["evaluate_pu_tiles"]
    k_, p_ = d.patches.idx.shape
    print(f"slice F main path (config 9): {wall:.3f} s wall (PUDeformer.fit of {len(rest)} "
          f"controls {t_fit:.3f} s: K={k_} patches of P={p_}; displacement at {v} verts incl. "
          f"the host plan {t_disp:.3f} s; displacement at the controls); PU launches "
          f"{launches_mesh} for the mesh, {launches} in all  [{label}]", flush=True)
    _check(launches_mesh == 1 and launches == 2,
           f"the PU path must launch the tile kernel once per displacement: {launches_mesh}, "
           f"{launches}")
    rep = d.report
    be = float(rep.backward_error())
    finite = all(bool(torch.isfinite(t).all()) for t in (rep.residual_norm, rep.rhs_norm,
                                                          rep.scale_norm, rep.col_backward))
    print(f"PU fit@{len(rest)}: backward error {be:.3e}, col_backward "
          f"{[f'{float(c):.2e}' for c in rep.col_backward]}")
    _check(finite and be < PU_BACKWARD_TOL, f"PU fit backward error {be:.3e}")
    _check(tuple(out.shape) == (v, 3) and bool(torch.isfinite(out).all()),
           "PU displacement not finite of shape (V, 3)")
    interp = float((at_ctrl - torch.as_tensor(disp, device=dev)).abs().max())
    print(f"PU interpolation error at the {len(rest)} controls (kernel): {interp:.3e} "
          f"(budget {ORACLE_BUDGET:g})")
    _check(interp < ORACLE_BUDGET, "PU interpolation at the controls misses the budget")

    # the whole output against the plain twin on the same plan
    t0 = time.perf_counter()
    tplan = cuda_pu.plan_eval_tiles(d.patches, pts_np)
    t_plan = time.perf_counter() - t0
    want = cuda_pu.evaluate_pu_tiles_reference((d.model,), pts, tplan, d.kernel)[0]
    err_twin = float((out - want).abs().max())
    scale = float(want.abs().max())
    n_tiles = len(tplan.item_offsets) - 1
    print(f"PU kernel at {v} x {len(rest)} vs the plain twin: max |d| {err_twin:.3e} "
          f"({err_twin / scale:.3e} of max|disp|, tol {PU_TOL:g}); host tile plan "
          f"{t_plan:.3f} s ({len(tplan.item_patch)} items over {n_tiles} tiles, "
          f"{len(tplan.item_patch) / n_tiles:.2f} per tile, "
          f"{int((tplan.forced_patch >= 0).sum())} forced)")
    _check(err_twin <= PU_TOL * scale, "PU main path disagrees with the plain twin")

    # the same model through the float64 plain tiles (host plan_eval)
    t0 = time.perf_counter()
    f64 = d.displacement(pts, precise=True, backend="plain")
    torch.cuda.synchronize()
    t_f64 = time.perf_counter() - t0
    err64 = float((out - f64).abs().max())
    print(f"PU f32 kernel vs float64 plain tiles at {v} verts: max |d| {err64:.3e} (tol "
          f"{PU_F64_TOL:g}; float64 route incl. its host plan {t_f64:.3f} s)")
    _check(err64 <= PU_F64_TOL, "the f32 PU kernel strays from the float64 tiles")

    # the Jacobian at 65536 vertices, 256 of them against float64 differences
    idx = torch.linspace(0, v - 1, 65536, device=dev).long()
    jac = d.jacobian(pts[idx])
    sub = pts[idx[::256]].double()
    h = 1e-5
    fd = torch.zeros((sub.shape[0], 3, 3), dtype=torch.float64, device=dev)
    for b in range(3):
        step = torch.zeros(3, dtype=torch.float64, device=dev)
        step[b] = h
        fd[:, :, b] = (_pu_field64(d.model, sub + step) - _pu_field64(d.model, sub - step)) / (2 * h)
    e_jac = float((jac[::256].double() - fd).abs().max()) / float(fd.abs().max())
    print(f"PU jacobian at {len(idx)} verts: finite {bool(torch.isfinite(jac).all())}; vs "
          f"float64 central difference on {sub.shape[0]}: {e_jac:.3e} of max|J| "
          f"{float(fd.abs().max()):.3e} (tol {PU_JAC_FD_TOL:g})")
    _check(bool(torch.isfinite(jac).all()) and e_jac <= PU_JAC_FD_TOL,
           "the PU Jacobian disagrees with the float64 central difference")
    return {"launches": launches, "deformer": d, "points": pts, "points_np": pts_np,
            "tplan": tplan, "rest": rest, "disp": disp, "err_twin": err_twin}


def main_path_pu_shot(dev, label: str) -> dict:
    """Phase 6c: slice F's shot at the JAX package's config 10: 20k
    controls x 8 bump poses, PUSeqDeformer.fit (one shared factorization),
    displacement_frames and apply_seq (capture d2, group gate, tangent
    frame) on the 1M-vertex sphere with launch counters read around them;
    every frame against a single-pose kernel run of its model, the whole
    shot against the plain twin, apply_seq against its plain composition,
    interpolation at the controls."""
    from facedeform_tpu_torch.config import DeformConfig, DeformParams, RBFKernel
    from facedeform_tpu_torch.geometry.primitives import uv_sphere
    from facedeform_tpu_torch.ops import cuda_pu, pu
    from facedeform_tpu_torch.ops.falloff import falloff_weight
    from facedeform_tpu_torch.ops.tangent import project_to_tangents

    rest, frames = _bump_rig(20000, PU_SHOT_CENTERS)
    n_frames = len(PU_SHOT_CENTERS)
    pts_np = uv_sphere(1000, 1000).points
    pts = torch.as_tensor(pts_np, device=dev)
    v = pts.shape[0]
    cap_d2 = torch.sum((pts - torch.tensor([0.0, 1.0, 0.0], device=dev)) ** 2, -1)
    gate = (pts[:, 0] > -0.6).float()
    frame = _sphere_frame(pts)
    cfg, params = DeformConfig(tangent=True), DeformParams(radius=1.2, falloffrate=1.5)

    since = profiling.counters()
    t0 = time.perf_counter()
    seq = pu.PUSeqDeformer.fit(rest, frames, kernel=RBFKernel.THIN_PLATE, lam=1e-5, device=dev)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    out = seq.displacement_frames(pts)
    pos, w = seq.apply_seq(pts, cap_d2, gate, cfg, params, frame=frame)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts((cuda_pu.evaluate_pu_tiles_frames,), since)[
        "evaluate_pu_tiles_frames"]
    print(f"slice F shot (config 10): {wall:.3f} s wall (PUSeqDeformer.fit of {n_frames} poses "
          f"x {len(rest)} controls {t_fit:.3f} s, displacement_frames + apply_seq at {v} "
          f"verts); PU launches {launches}  [{label}]", flush=True)
    _check(launches == 2, f"displacement_frames and apply_seq must launch once each: {launches}")
    be = float(seq.report.backward_error())
    print(f"PU shot fit: backward error {be:.3e}, worst column "
          f"{float(seq.report.col_backward.max()):.3e}")
    _check(be < PU_BACKWARD_TOL, "PU shot fit backward error")
    _check(tuple(out.shape) == (n_frames, v, 3) and bool(torch.isfinite(out).all())
           and tuple(pos.shape) == (n_frames, v, 3) and bool(torch.isfinite(pos).all()),
           "PU shot output not finite of shape (F, V, 3)")

    tplan = cuda_pu.plan_eval_tiles(seq.patches, pts_np)
    models = tuple(p.model for p in seq.puds)
    want = cuda_pu.evaluate_pu_tiles_reference(models, pts, tplan, seq.kernel)
    scale = float(want.abs().max())
    err_twin = float((out - want).abs().max())
    worst = 0.0
    for f in range(n_frames):
        single = seq.puds[f].displacement(pts, plan=tplan)
        worst = max(worst, float((out[f] - single).abs().max()))
    fw, _ = falloff_weight(cap_d2, params.radius, params.falloffrate)
    fw = fw * gate
    plain = pts[None] + torch.stack([project_to_tangents(*frame, want[f])
                                     for f in range(n_frames)]) * fw[None, :, None]
    err_seq = float((pos - plain).abs().max())
    at_ctrl = seq.displacement_frames(rest)
    interp = float((at_ctrl - torch.as_tensor(frames - rest[None], device=dev)).abs().max())
    print(f"PU shot at {v} x {len(rest)} x {n_frames}: vs the plain twin max |d| {err_twin:.3e} "
          f"({err_twin / scale:.3e} of max|disp|); frames vs single-pose kernel runs max |d| "
          f"{worst:.3e} (tol {FRAME_VS_SINGLE_TOL:g}; bit for bit {worst == 0.0}); apply_seq "
          f"vs its plain composition "
          f"{err_seq:.3e}, falloff equal {bool(torch.equal(w, fw))}; interpolation at the "
          f"controls {interp:.3e}")
    _check(err_twin <= PU_TOL * scale, "the PU shot disagrees with the plain twin")
    _check(worst <= FRAME_VS_SINGLE_TOL, "a PU shot frame disagrees with its single-pose run")
    _check(err_seq <= PU_TOL * scale and bool(torch.equal(w, fw)),
           "apply_seq disagrees with its plain composition")
    _check(interp < ORACLE_BUDGET, "PU shot interpolation at the controls misses the budget")
    return {"launches": launches, "seq": seq, "points": pts, "tplan": tplan, "rest": rest,
            "frames": frames, "err_twin": err_twin}


def _profile(fn, label: str, top: int = 10) -> None:
    """torch.profiler of one call: device rows by device time, the device's
    busy share of the wall, and whether MAGMA kernels ran.  The rows are
    the events that ran on the CUDA device (kernels, memcpy, memset),
    kept by their kind and not by name, so no range annotated on the host
    (utils/profiling.stage, record_function) counts as device work; busy
    is the union of their intervals, and a busy time past the wall fails
    the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_us, reach = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > reach:
            busy_us += hi - max(lo, reach)
            reach = hi
    busy = busy_us / 1e3
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    magma = [k for k, _ in rows if "magma" in k.lower()]
    print(f"profile {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms (idle share "
          f"{1 - busy / wall:.3f}); MAGMA kernels: {len(magma)} "
          f"({', '.join(sorted(set(magma))[:4]) or 'none'})")
    for name, (us, n) in rows[:top]:
        print(f"  {us / 1e3:10.3f} ms  x{n:<5d} {name[:110]}")
    _check(busy <= wall, f"profile {label}: device busy {busy:.3f} ms exceeds the wall "
           f"{wall:.3f} ms: a range was counted as device work")


def time_pu(main_f: dict, shot: dict, label: str) -> list:
    """Phase 7d: the PU kernel against its plain twin at 1M x 30k (one
    pose) and 1M x 20k x 8 frames; host-clock walls of the fits
    (PUDeformer.fit at 30k beside its parts; fit_pu_frames at 20k x 8
    beside 8 fit_pu), the host builds, a cached-plan displacement, the
    kernel's call and its operand packing; profiles of the 30k fit, the
    kernel's call and the cached-plan displacement."""
    from facedeform_tpu_torch.benchmark import stats, time_cuda
    from facedeform_tpu_torch.config import RBFKernel
    from facedeform_tpu_torch.ops import cuda_pu, pu

    d, pts, tplan = main_f["deformer"], main_f["points"], main_f["tplan"]
    dev = pts.device
    v = pts.shape[0]
    seq, splan = shot["seq"], shot["tplan"]
    models = tuple(p.model for p in seq.puds)
    one = lambda: cuda_pu.evaluate_pu_tiles(d.model, pts, tplan, d.kernel)  # noqa: E731
    fns = {
        "pu kernel": one,
        "pu twin": lambda: cuda_pu.evaluate_pu_tiles_reference((d.model,), pts, tplan, d.kernel),
        "pu kernel F=8": lambda: cuda_pu.evaluate_pu_tiles_frames(models, pts, splan, seq.kernel),
        "pu twin F=8": lambda: cuda_pu.evaluate_pu_tiles_reference(models, pts, splan, seq.kernel),
    }
    t = {k: stats(x) for k, x in time_cuda(fns, rounds=3, iters={
        "pu kernel": 10, "pu twin": 1, "pu kernel F=8": 5, "pu twin F=8": 1}).items()}
    n30, n20 = len(main_f["rest"]), len(shot["rest"])
    for k, x in t.items():
        shape = f"{v} x {n20} x 8 frames" if "F=8" in k else f"{v} x {n30}"
        print(_fmt(k, x, f" at {shape}  [{label}]"))
    pairs1 = _pu_pairs(d.model, pts, tplan, dev)
    pairs8 = _pu_pairs(models[0], pts, splan, dev)
    k1, p1 = d.model.valid.shape
    k8, p8 = models[0].valid.shape
    shape1 = (v, len(tplan.forced_patch), k1, p1, len(tplan.item_patch), pairs1[0])
    shape8 = (v, len(splan.forced_patch), k8, p8, len(splan.item_patch), pairs8[0])
    b1, b8 = _pu_bound(1, *shape1, tensor_cores=False), _pu_bound(8, *shape8, tensor_cores=True)
    for name, (needed, block, warp), b, old, ms, plain_ms in (
            (f"{v} x {n30}", pairs1, b1, b1,
             t["pu kernel"][0], t["pu twin"][0]),
            (f"{v} x {n20} x 8 frames", pairs8, b8, _pu_bound(8, *shape8, tensor_cores=False),
             t["pu kernel F=8"][0], t["pu twin F=8"][0])):
        print(f"PU kernel at {name}: {needed} needed pairs ({needed / ms / 1e6:.1f} Gpairs/s); "
              f"computed with the warp skip {warp} ({warp / needed:.3f}x needed), with a block skip "
              f"{block} ({block / needed:.3f}x); bound {b['bound_ms']:.4f} ms by "
              f"{b['bound_by']} ({b['bound_ms'] / ms * 100:.1f}% of the kernel's time; CUDA-core "
              f"formula {old['bound_ms']:.4f} ms, {old['bound_ms'] / ms * 100:.1f}%); the twin "
              f"takes {plain_ms / ms:.2f}x  [{label}]")

    # fits, host builds and the cached-plan displacement: host-clock walls
    # around work ending in a synchronize, one warm-up each, then rounds
    # interleaved across them so a fit and its parts see the same host
    rest, disp = main_f["rest"], main_f["disp"]
    srest, sframes = shot["rest"], shot["frames"]
    tps = RBFKernel.THIN_PLATE
    fit30 = lambda: pu.fit_pu(rest, rest + disp, tps, lam=1e-5,  # noqa: E731
                              patches=d.patches, device=dev)
    walls = {
        "PUDeformer.fit 30k": lambda: pu.PUDeformer.fit(rest, rest + disp, kernel=tps, lam=1e-5,
                                                        device=dev),
        "build_patches 30k (host)": lambda: pu.build_patches(rest),
        "fit_pu 30k (patches given)": fit30,
        "build_patches + fit_pu 30k (one call)": lambda: pu.fit_pu(
            rest, rest + disp, tps, lam=1e-5, patches=pu.build_patches(rest), device=dev),
        "fit_pu_frames 20k x 8": lambda: pu.fit_pu_frames(srest, sframes, tps, lam=1e-5,
                                                          patches=seq.patches, device=dev),
        "fit_pu x 8 at 20k": lambda: [pu.fit_pu(srest, f, tps, lam=1e-5, patches=seq.patches,
                                                device=dev) for f in sframes],
        "plan_eval_tiles 1M (host)": lambda: cuda_pu.plan_eval_tiles(d.patches,
                                                                      main_f["points_np"]),
        "PUDeformer.displacement 1M (plan cached)": lambda: d.displacement(pts),
        # the cache hit alone (build is not called): the points' copy to the
        # host and the blake2b digest that keys the cache
        "plan-cache lookup 1M (host copy + digest)": lambda: d.make_plan(pts),
        "evaluate_pu_tiles 1M x 30k": one,
        "operand packing 30k (_pack_frames_operands)": lambda: cuda_pu._pack_frames_operands(
            (d.model,)),
    }
    ts = {k: [] for k in walls}
    for fn in walls.values():
        fn()
    for _ in range(PU_WALL_ROUNDS):
        for k, fn in walls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts[k].append((time.perf_counter() - t0) * 1e3)
    for k, x in ts.items():
        print(_fmt(k, stats(x), f" wall, {PU_WALL_ROUNDS} interleaved rounds  [{label}]"))
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    fit30()
    torch.cuda.synchronize()
    print(f"fit_pu 30k peak device memory {(torch.cuda.max_memory_allocated(dev) - base) / 1e9:.3f}"
          f" GB (K={k1}, P={p1})")
    _profile(fit30, "fit_pu 30k")
    _profile(one, f"pu kernel {v} x {n30}", top=3)
    _profile(lambda: d.displacement(pts), f"PUDeformer.displacement {v} (plan cached)", top=3)
    src = "facedeform_tpu_torch/csrc/pu.cu"
    return [
        {"name": "pu_tiles", "route": "cuda", "source": src,
         "replaces": "facedeform_tpu/ops/pallas_pu.py:412",
         "launches": main_f["launches"], "max_abs_err": main_f["err_twin"],
         "ms": t["pu kernel"][0], "plain_ms": t["pu twin"][0], **b1, "library_ms": None},
        {"name": "pu_tiles_frames", "route": "cuda", "source": src,
         "replaces": "facedeform_tpu/ops/pallas_pu.py:412",
         "launches": shot["launches"], "max_abs_err": shot["err_twin"],
         "ms": t["pu kernel F=8"][0], "plain_ms": t["pu twin F=8"][0], **b8,
         "library_ms": None},
    ]


def time_pu_jac(dev, label: str) -> dict:
    """--pu-jac, part alone: the PU tile kernel at 1M x 30k (config 9, one
    pose) and 1M x 20k x 8 frames (config 10) and the Jacobian kernel at 1M
    x 1k, single pose and F = 8 (slice B's shot), each through the wrapper
    the main path calls, best of 5 interleaved rounds of 10 launches.  It
    calls only entry points the parent commit has too, so run from a parent
    checkout it times the parent's kernels by the same code.  Returns
    {name: (best, median, spread)}."""
    from facedeform_tpu_torch import DeformConfig, DeformParams
    from facedeform_tpu_torch.benchmark import stats, time_cuda
    from facedeform_tpu_torch.config import RBFKernel
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points, uv_sphere
    from facedeform_tpu_torch.ops import cuda_eval, cuda_jacobian, cuda_pu, pu, temporal
    from facedeform_tpu_torch.ops.fit import effective_kernel
    from facedeform_tpu_torch.parallel import batched

    tps = RBFKernel.THIN_PLATE
    pts_np = uv_sphere(1000, 1000).points
    pts = torch.as_tensor(pts_np, device=dev)
    rest, frames = _bump_rig(30000)
    d = pu.PUDeformer.fit(rest, frames[0], kernel=tps, lam=1e-5, device=dev)
    tplan = cuda_pu.plan_eval_tiles(d.patches, pts_np)
    srest, sframes = _bump_rig(20000, PU_SHOT_CENTERS)
    seq = pu.PUSeqDeformer.fit(srest, sframes, kernel=tps, lam=1e-5, device=dev)
    splan = cuda_pu.plan_eval_tiles(seq.patches, pts_np)
    models = tuple(p.model for p in seq.puds)
    # slice B's shot (main_path_frames)
    rng = np.random.default_rng(0)
    brest = fibonacci_points(1000)
    raw = np.stack([brest + 0.05 * rng.standard_normal((1000, 3)).astype(np.float32)
                    for _ in range(8)])
    cfg = DeformConfig(tangent=True)
    model, _ = batched.fit_frames(brest, temporal.smooth_frames(raw, window=5), cfg,
                                  DeformParams(), device=dev)
    kernel, term = effective_kernel(cfg), cfg.term
    one = cuda_eval.frame_model(model, 0)
    fns = {
        "pu 1M x 30k": lambda: cuda_pu.evaluate_pu_tiles(d.model, pts, tplan, d.kernel),
        "pu 1M x 20k x 8": lambda: cuda_pu.evaluate_pu_tiles_frames(models, pts, splan,
                                                                    seq.kernel),
        "jacobian 1M x 1k": lambda: cuda_jacobian.jacobian_cuda(one, pts, kernel, term),
        "jacobian 1M x 1k x 8": lambda: cuda_jacobian.jacobian_cuda_frames(model, pts, kernel,
                                                                          term),
    }
    t = {k: stats(x) for k, x in time_cuda(fns, rounds=5, iters=10).items()}
    for k, x in t.items():
        print(_fmt(k, x, f"  [{label}]"))
    # the 8-frame shapes as two launches of 4 frames (smaller accumulators,
    # more blocks an SM): the frames-per-launch choice
    jac_step, pu_step = cuda_jacobian.JAC_FRAMES_PER_LAUNCH, cuda_pu.FRAMES_PER_LAUNCH
    cuda_jacobian.JAC_FRAMES_PER_LAUNCH = cuda_pu.FRAMES_PER_LAUNCH = 4
    try:
        t4 = {k: stats(x) for k, x in time_cuda(
            {k: fns[k] for k in ("pu 1M x 20k x 8", "jacobian 1M x 1k x 8")},
            rounds=5, iters=10).items()}
    finally:
        cuda_jacobian.JAC_FRAMES_PER_LAUNCH, cuda_pu.FRAMES_PER_LAUNCH = jac_step, pu_step
    for k, x in t4.items():
        print(_fmt(k + " as 2 launches of 4 frames", x, f"  [{label}]"))
    for name, m, plan in (("1M x 30k", d.model, tplan), ("1M x 20k x 8", models[0], splan)):
        needed, block, warp = _pu_pairs(m, pts, plan, dev)
        print(f"PU pairs at {name}: {needed} needed; computed {warp} with a warp skip "
              f"({warp / needed:.3f}x), {block} with a block skip ({block / needed:.3f}x)")
    # each timed output against its plain twin; the Jacobians also against a
    # float64 one on a 65536-vertex subset, relative to max(1, max|J|)
    for name, ms, twin in (
            ("pu 1M x 30k", (d.model,), lambda: cuda_pu.evaluate_pu_tiles_reference(
                (d.model,), pts, tplan, d.kernel)[0]),
            ("pu 1M x 20k x 8", models, lambda: cuda_pu.evaluate_pu_tiles_reference(
                models, pts, splan, seq.kernel))):
        want = twin()
        e = float((fns[name]() - want).abs().max()) / float(want.abs().max())
        print(f"{name}: |kernel - twin| / max|disp| {e:.3e} (tol {PU_TOL:g})")
    idx = torch.linspace(0, pts.shape[0] - 1, 65536, device=dev).long()
    j64 = _jacobian64(model, pts[idx], kernel, term)
    scale = max(1.0, float(j64.abs().max()))
    twin = cuda_jacobian.jacobian_frames_reference(model, pts[idx], kernel, term)
    got8 = fns["jacobian 1M x 1k x 8"]()[:, idx]
    got1 = fns["jacobian 1M x 1k"]()[idx]
    rel = lambda a, b: float((a.double() - b).abs().max()) / scale  # noqa: E731
    print(f"jacobian 1M x 1k, 65536-vertex subset, relative to max(1, max|J|) = {scale:.3e}: "
          f"kernel F=8 vs float64 {rel(got8, j64):.3e}, single {rel(got1, j64[0]):.3e}; plain "
          f"twin vs float64 {rel(twin, j64):.3e}; kernel F=8 vs twin "
          f"{rel(got8, twin.double()):.3e} (tol {JAC_TOL_DECAYING:g})")
    print(json.dumps({"pu_jac": {k: list(x) for k, x in t.items()}, "device": label}))
    return t


def _jacobian64(model, pts, kernel, term, chunk=4096):
    """Float64 Jacobian of a frames-stacked model, written out: J[a][b] =
    sum_lj g w_a (x - c)_b + the linear tail, g = 2 phi'(s) / eps^2;
    (F, V, 3, 3)."""
    from facedeform_tpu_torch.config import PolyTerm
    from facedeform_tpu_torch.ops.kernels import phi_prime_s

    c, w, eps = model.ctrl.double(), model.w_rbf.double(), model.eps.double()
    outs = []
    for p in torch.split(pts.double(), chunk):
        d = p[:, None] - c[None]                                    # (v, N, 3)
        d2 = (d * d).sum(-1)
        jac = 0.0
        for layer in range(eps.shape[0]):
            ie = 1.0 / (eps[layer] * eps[layer])
            g = 2.0 * phi_prime_s(kernel, d2 * ie) * ie
            jac = jac + torch.einsum("vn,fna,vnb->fvab", g, w[:, layer], d)
        outs.append(jac)
    jac = torch.cat(outs, dim=1)
    if PolyTerm(term) == PolyTerm.LINEAR and model.w_poly.shape[1] >= 4:
        jac = jac + model.w_poly.double()[:, 1:4].transpose(1, 2)[:, None]
    return jac


# ------------------------------------------------------------ Krylov route
def _krylov_ok(kind: str, n: int, err: float, scale: float):
    """(err within the route's bound, the bound); the bound is None for a
    CPD field with no JAX measurement at n (printed, not checked)."""
    if kind != "cpd":
        a, b = KRYLOV_TOL_DECAYING
        return err <= a + b * scale, a + b * scale
    if n not in JAX_TPS_KRYLOV_REL_ERR:
        return True, None
    bound = KRYLOV_CPD_VS_JAX * JAX_TPS_KRYLOV_REL_ERR[n] * scale
    return err <= bound, bound


def _bound_txt(bound) -> str:
    return "not checked: no JAX measurement" if bound is None else f"bound {bound:.3e}"


class _KrylovProbe:
    """Records what ops/fit's Krylov route does inside the `with` block:
    each preconditioner's setup seconds (block inverses or eigh) and each
    solver sweep's matvecs and seconds.  fit() calls these functions through
    the ops.krylov module, so wrapping the module's attributes sees them;
    they are restored on exit.  PMINRES runs (warm start) + iterations + 1
    matvecs, GMRES (warm start) + restarts x (32 + 2) + 1."""

    SOLVERS = ("gmres", "pminres")
    SETUPS = ("make_block_jacobi", "make_abs_block_jacobi")

    def __enter__(self):
        from facedeform_tpu_torch.ops import krylov

        self.mod = krylov
        self.saved = {k: getattr(krylov, k) for k in self.SOLVERS + self.SETUPS}
        self.setup_s, self.sweeps = [], []

        def timed_setup(real):
            def wrapped(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real(*a, **kw)
                torch.cuda.synchronize()
                self.setup_s.append(time.perf_counter() - t0)
                return out
            return wrapped

        def counted_solver(name, real):
            def wrapped(matvec, b, *a, **kw):
                calls = [0]

                def counted(x):
                    calls[0] += 1
                    return matvec(x)

                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real(counted, b, *a, **kw)
                torch.cuda.synchronize()
                warm = int(kw.get("x0") is not None)
                n_mv = calls[0]
                iters = (n_mv - 1 - warm) if name == "pminres" else (n_mv - 1 - warm) // 34
                self.sweeps.append({"solver": name, "matvecs": n_mv, "iterations": iters,
                                    "warm": bool(warm), "s": time.perf_counter() - t0})
                return out
            return wrapped

        for k in self.SETUPS:
            setattr(krylov, k, timed_setup(self.saved[k]))
        for k in self.SOLVERS:
            setattr(krylov, k, counted_solver(k, self.saved[k]))
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(self.mod, k, fn)
        return False

    def summary(self) -> str:
        unit = {"pminres": "iterations", "gmres": "restarts of 32"}
        sweeps = ", ".join(f"{s['iterations']} {unit[s['solver']]} ({s['matvecs']} matvecs, "
                           f"{s['s']:.3f} s{', warm' if s['warm'] else ''})"
                           for s in self.sweeps)
        return (f"setup {sum(self.setup_s):.3f} s; {len(self.sweeps)} sweeps: {sweeps}")


def _phi64(kernel, d2, eps):
    """TPS, MQ or gaussian phi of squared distances in float64, written
    out; eps broadcasts over the control axis."""
    from facedeform_tpu_torch.config import RBFKernel

    s = d2 / (eps * eps)
    if kernel == RBFKernel.THIN_PLATE:
        return torch.where(s > 0, 0.5 * s * torch.log(torch.clamp(s, min=1e-300)),
                           torch.zeros_like(s))
    if kernel == RBFKernel.GAUSSIAN:
        return torch.exp(-s)
    _check(kernel == RBFKernel.MULTIQUADRIC, f"no oracle phi for {kernel.name}")
    return torch.sqrt(1.0 + s)


def _sqdist64(x, y):
    dx, dy, dz = (x[:, None, i] - y[None, :, i] for i in range(3))
    return dx * dx + dy * dy + dz * dz


def _saddle_field64(ctrl, eps, lam, kernel, delta, pts, chunk=2048):
    """Float64 dense solve of a one-layer saddle system (linear tail, the
    -1e-8 tail block, phi(|c_i - c_j| / eps_j) + lam_i on the diagonal),
    assembled in row chunks on the card and LU-solved there, then its field
    at pts: (V, 3) float64.  The 50k-control system is 20 GB, its LU
    another 20."""
    c = ctrl.double()
    n = c.shape[0]
    e = torch.broadcast_to(torch.as_tensor(eps, device=c.device).double(), (n,))
    a = torch.empty((n + 4, n + 4), dtype=torch.float64, device=c.device)
    for rows in torch.split(torch.arange(n, device=c.device), chunk):
        a[rows[0]:rows[-1] + 1, :n] = _phi64(kernel, _sqdist64(c[rows], c), e)
    a[:n, :n].diagonal().add_(torch.broadcast_to(torch.as_tensor(lam, device=c.device)
                                                 .double(), (n,)))
    p = torch.cat([torch.ones(n, 1, dtype=c.dtype, device=c.device), c], 1)
    a[:n, n:] = p
    a[n:, :n] = p.T
    a[n:, n:] = -1e-8 * torch.eye(4, dtype=c.dtype, device=c.device)
    lu, piv, _ = torch.linalg.lu_factor_ex(a)
    del a
    b = torch.cat([delta.double(), torch.zeros(4, 3, dtype=c.dtype, device=c.device)])
    x = torch.linalg.lu_solve(lu, piv, b)
    del lu
    q = pts.double()
    pq = torch.cat([torch.ones(len(q), 1, dtype=q.dtype, device=q.device), q], 1)
    out = [_phi64(kernel, _sqdist64(qc, c), e) @ x[:n] for qc in torch.split(q, 512)]
    return torch.cat(out) + pq @ x[n:]


def _krylov_cfg(model, kernel, solver, layers=1):
    from facedeform_tpu_torch import DeformConfig

    return DeformConfig(model=model, kernel=kernel, layers=layers, solver=solver)


def check_krylov_parity(dev, label: str) -> float:
    """Phase 6c: forced solver="krylov" against the dense fit at 2000 and
    4096 controls for QNN, KERNEL-gaussian, multilayer L3 and TPS, fields
    compared on a 4096-point shell at the Krylov bounds above (_krylov_ok),
    the fits' health at their routes' thresholds.  Returns the worst err /
    bound."""
    from facedeform_tpu_torch import DeformParams, Deformer
    from facedeform_tpu_torch.config import RBFKernel, RBFModelType
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points

    cases = [
        ("QNN", RBFModelType.QNN, RBFKernel.GAUSSIAN, 1, DeformParams(), "decaying"),
        ("KERNEL-gaussian", RBFModelType.KERNEL, RBFKernel.GAUSSIAN, 1,
         DeformParams(radius=0.15, lam=0.01), "decaying"),
        # the first layer ~5.5 control spacings wide at 4096: at radius 0.6
        # (~11) its PMINRES stops at maxiter 256 short of the health check
        # (backward error 1.3e-6 after 2 sweeps; PERF.md, PR 9)
        ("multilayer L3", RBFModelType.MULTILAYER, RBFKernel.GAUSSIAN, 3,
         DeformParams(radius=0.3, lam=0.05), "decaying"),
        ("TPS", RBFModelType.KERNEL, RBFKernel.THIN_PLATE, 1,
         DeformParams(radius=1.0, lam=0.01), "cpd"),
    ]
    rng = np.random.default_rng(3)
    pts = torch.as_tensor(fibonacci_points(4096) * 1.02, device=dev)
    worst = 0.0
    for n in KRYLOV_PARITY_N:
        rest = fibonacci_points(n)
        deformed = rest + 0.05 * rng.standard_normal((n, 3)).astype(np.float32)
        for name, model, kernel, layers, params, kind in cases:
            out, wall, probe = {}, {}, None
            for solver in ("direct", "krylov"):
                cfg = _krylov_cfg(model, kernel, solver, layers)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if solver == "krylov":
                    with _KrylovProbe() as probe:
                        d = Deformer.fit(rest, deformed, cfg, params, device=dev)
                else:
                    d = Deformer.fit(rest, deformed, cfg, params, device=dev)
                torch.cuda.synchronize()
                wall[solver] = time.perf_counter() - t0
                out[solver] = (d.displacement(pts).double(), d)
            ref, dk = out["direct"][0], out["krylov"][1]
            err = float(torch.max(torch.abs(out["krylov"][0] - ref)))
            scale = float(torch.max(torch.abs(ref)))
            ok, bound = _krylov_ok(kind, n, err, scale)
            _check(dk.model.w_rbf_lo is None, f"{name}: a Krylov model carries lo words")
            _check(float(dk.report.backward_error()) <= (
                KRYLOV_CPD_BACKWARD_TOL if kind == "cpd" else BACKWARD_TOL),
                f"{name} at {n}: Krylov backward error")
            print(f"krylov parity {name} at {n}: max |d field| {err:.3e} = {err / scale:.3e} of "
                  f"scale vs direct ({_bound_txt(bound)}, scale {scale:.3e}); backward error "
                  f"{float(dk.report.backward_error()):.3e}; fit {wall['krylov']:.3f} s krylov, "
                  f"{wall['direct']:.3f} s direct; {probe.summary()}  [{label}]", flush=True)
            _check(ok, f"{name} at {n}: the Krylov field misses the dense one")
            if bound is not None:
                worst = max(worst, err / bound)
    return worst


def _large_rig(dev, name, cfg, params, n, rng, pts, idx, label):
    """One rig of the large-rig main path: Deformer.fit (solver "auto")
    and apply("auto") on the sphere, the displacement on the subset
    against the kernel's plain twin and a float64 dense solve of the same
    saddle system, the matvec's time."""
    from facedeform_tpu_torch import Deformer
    from facedeform_tpu_torch.benchmark import stats, time_cuda
    from facedeform_tpu_torch.config import RBFModelType
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points
    from facedeform_tpu_torch.ops import fit as fit_mod
    from facedeform_tpu_torch.ops import krylov
    from facedeform_tpu_torch.ops.evaluate import evaluate
    from facedeform_tpu_torch.ops.precise_eval import evaluate_precise

    rest = fibonacci_points(n)
    deformed = rest + 0.03 * rng.standard_normal((n, 3)).astype(np.float32)
    _check(fit_mod.uses_krylov(cfg, n), f"{name}: {n} controls must take the Krylov route")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _KrylovProbe() as probe:
        d = Deformer.fit(rest, deformed, cfg, params, device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    out, w = d.apply(pts)
    torch.cuda.synchronize()
    kernel = fit_mod.effective_kernel(cfg)
    kind = "decaying" if not fit_mod.krylov_cpd(cfg, n) else "cpd"
    be = float(d.report.backward_error())
    # the matvec a Krylov iteration applies, on this rig, 3 columns
    eps = d.model.eps[0]
    lam = 0.0 if cfg.model == RBFModelType.QNN else params.clamped().lam
    mv = krylov.make_saddle_matvec(d.model.ctrl, kernel, cfg.term, eps, lam)
    x = torch.randn(n + cfg.n_poly, 3, device=dev)
    mv_ms = stats(time_cuda({"mv": lambda: mv(x)}, rounds=3, iters=3)["mv"])[0]
    _check(tuple(out.shape) == (pts.shape[0], 3) and bool(torch.isfinite(out).all()),
           f"{name}: apply output not finite of shape (V, 3)")
    _check(bool((w == 1).all()), f"{name}: uncaptured vertices must deform fully")
    # the kernel apply("auto") took against its plain twin on this model
    disp = (out[idx] - pts[idx]).double()
    twin_fn, twin_tol = ((evaluate_precise, PRECISE_POS_TOL) if kind == "cpd"
                         else (evaluate, POS_TOL_DECAYING))
    twin = twin_fn(d.model, pts[idx], kernel, cfg.term).double()
    twin_err = float(torch.max(torch.abs(disp - twin)))
    want = _saddle_field64(d.model.ctrl, eps, lam, kernel,
                           torch.as_tensor(deformed, device=dev) - d.model.ctrl, pts[idx])
    err = float(torch.max(torch.abs(disp - want)))
    scale = float(torch.max(torch.abs(want)))
    ok, bound = _krylov_ok(kind, n, err, scale)
    print(f"large rig {name} {n} controls: fit {fit_s:.3f} s wall ({probe.summary()}); "
          f"backward error {be:.3e}; matvec {mv_ms:.4f} ms an iteration (plain torch, "
          f"{n + cfg.n_poly} x 3); apply('auto') at {pts.shape[0]} verts, 4096-vertex subset: "
          f"vs the plain twin max |d disp| {twin_err:.3e} (tol {twin_tol:g}); vs a float64 "
          f"dense solve of the same system {err:.3e} = {err / scale:.3e} of scale "
          f"({_bound_txt(bound)}, scale {scale:.3e})  [{label}]", flush=True)
    _check(be <= (KRYLOV_CPD_BACKWARD_TOL if kind == "cpd" else BACKWARD_TOL),
           f"{name}: backward error {be:.3e}")
    _check(twin_err <= twin_tol, f"{name}: apply('auto') disagrees with the plain twin")
    _check(ok, f"{name}: the Krylov field misses the float64 solve")
    return {"fit_s": fit_s, "setup_s": sum(probe.setup_s), "sweeps": probe.sweeps,
            "backward_error": be, "matvec_ms": mv_ms, "err": err, "bound": bound,
            "rest": rest, "deformer": d}


def main_path_large_rigs(dev, label: str) -> dict:
    """Phase 6d: the large-rig main path.  Fibonacci rigs on the 1M
    sphere through Deformer.fit with solver "auto" (QNN at 25k -> GMRES,
    KERNEL-gaussian at 50k -> PMINRES, TPS at 16k -> |.|-block-Jacobi
    PMINRES), apply("auto") (the culled kernel #2, the precise kernel #5),
    then a 4-pose TPS shot at 16k through fit_frames -> check_frames (the
    Krylov-CPD route) -> apply_frames (#5's frames launch), with launch
    counters read around it; applies against their kernels' plain twins
    and float64 dense solves on the card; then the dense route's fit at
    8192 and 16384 controls against the Krylov route's (the crossover)."""
    from facedeform_tpu_torch import DeformConfig, DeformParams, Deformer
    from facedeform_tpu_torch.config import RBFKernel, RBFModelType
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points, uv_sphere
    from facedeform_tpu_torch.ops import cuda_eval, cuda_precise
    from facedeform_tpu_torch.ops import fit as fit_mod
    from facedeform_tpu_torch.ops.precise_eval import evaluate_precise
    from facedeform_tpu_torch.parallel import batched
    from facedeform_tpu_torch.utils import errors

    torch.cuda.empty_cache()      # the 50k float64 check takes 40 GB at once
    rng = np.random.default_rng(9)
    pts = torch.as_tensor(uv_sphere(1000, 1000).points, device=dev)
    v = pts.shape[0]
    idx = torch.linspace(0, v - 1, 4096, device=dev).long()
    rigs = {
        "QNN": (DeformConfig(), DeformParams(), LARGE_QNN_N),
        "KERNEL-gaussian": (DeformConfig(model=RBFModelType.KERNEL),
                            DeformParams(radius=LARGE_GAUSS_RADIUS, lam=0.01), LARGE_GAUSS_N),
        "TPS": (DeformConfig(model=RBFModelType.KERNEL, kernel=RBFKernel.THIN_PLATE),
                DeformParams(radius=1.0, lam=0.01), LARGE_TPS_N),
    }
    counters = (cuda_eval.evaluate_cuda, cuda_eval.evaluate_cuda_culled,
                cuda_eval.control_records, cuda_eval.culled_tables,
                cuda_precise.evaluate_cuda_precise, cuda_precise.evaluate_cuda_precise_frames,
                cuda_solve.lu_solve_cuda)
    since = profiling.counters()
    t0 = time.perf_counter()
    results = {name: _large_rig(dev, name, cfg, params, n, rng, pts, idx, label)
               for name, (cfg, params, n) in rigs.items()}
    # the 4-pose TPS shot on the 16k rig
    cfg, params, n = rigs["TPS"]
    rest = results["TPS"]["rest"]
    shot = rest + 0.03 * rng.standard_normal((4, n, 3)).astype(np.float32)
    torch.cuda.synchronize()
    t_shot = time.perf_counter()
    shot_model, resid, report = batched.fit_frames(rest, shot, cfg, params, device=dev,
                                                   want_report=True)
    errors.check_frames(resid, rest, shot, cfg=cfg, report=report)
    ones = torch.ones(v, device=dev)
    shot_out, _ = batched.apply_frames(shot_model, pts, torch.zeros(v, device=dev), ones, cfg,
                                       params)
    torch.cuda.synchronize()
    shot_s = time.perf_counter() - t_shot
    wall = time.perf_counter() - t0
    launches = _launch_counts(counters, since)
    print(f"large-rig main path: {wall:.3f} s wall (3 Krylov fits, 3 applies and 3 float64 "
          f"checks at {v} verts, a 4-pose TPS shot in {shot_s:.3f} s); launches {launches}  "
          f"[{label}]", flush=True)
    _check(launches["evaluate_cuda_culled"] == 2 and launches["culled_tables"] == 2,
           "the QNN and gaussian applies must each launch the culled kernel once")
    _check(launches["evaluate_cuda_precise"] == 1,
           "the TPS apply must launch the precise kernel once")
    _check(launches["evaluate_cuda_precise_frames"] == 1,
           "the 4-pose shot must take one precise frames launch")
    _check(launches["evaluate_cuda"] == 0, "no path here takes the dense kernel")
    back = report.backward_error()
    rhs = torch.linalg.norm(torch.as_tensor(shot - rest[None]), dim=(1, 2))
    ratio = (resid.cpu().double() / rhs).tolist()
    print(f"TPS shot {n} x 4 through fit_frames: per-frame backward error "
          f"{[f'{b:.3e}' for b in back.tolist()]}, residual / rhs "
          f"{[f'{r:.3e}' for r in ratio]}; check_frames on the Krylov-CPD route passed  "
          f"[{label}]")
    _check(shot_model.w_rbf_lo is None, "a Krylov shot carries lo words")
    for f in range(4):
        single, _ = fit_mod.fit(torch.as_tensor(rest, device=dev),
                                torch.as_tensor(shot[f], device=dev), cfg.solve_view(), params)
        _check(bool(torch.equal(single.w_rbf, shot_model.w_rbf[f]))
               and bool(torch.equal(single.w_poly, shot_model.w_poly[f])),
               f"shot frame {f} differs from its single Krylov fit")
    # frame 0 against the precise kernel's plain twin and a float64 solve
    twin = evaluate_precise(cuda_eval.frame_model(shot_model, 0), pts[idx],
                            RBFKernel.THIN_PLATE, cfg.term).double()
    disp0 = (shot_out[0, idx] - pts[idx]).double()
    twin_err = float(torch.max(torch.abs(disp0 - twin)))
    want = _saddle_field64(shot_model.ctrl, shot_model.eps[0], 0.01, RBFKernel.THIN_PLATE,
                           torch.as_tensor(shot[0], device=dev) - shot_model.ctrl, pts[idx])
    err = float(torch.max(torch.abs(disp0 - want)))
    scale = float(torch.max(torch.abs(want)))
    _, bound = _krylov_ok("cpd", n, err, scale)
    print(f"TPS shot frame 0, 4096-vertex subset: vs the plain twin max |d disp| "
          f"{twin_err:.3e} (tol {PRECISE_POS_TOL:g}); vs a float64 dense solve {err:.3e} = "
          f"{err / scale:.3e} of scale ({_bound_txt(bound)}); every frame's model equals its "
          f"single fit bit for bit  [{label}]")
    _check(bool(torch.isfinite(shot_out).all()) and twin_err <= PRECISE_POS_TOL,
           "the TPS shot's frames launch disagrees with the plain twin")

    # the dense/Krylov crossover: the same rigs at 8192 and 16384
    crossover = {}
    for name in ("QNN", "TPS"):
        cfg, params, _ = rigs[name]
        for n in CROSSOVER_N:
            rest = fibonacci_points(n)
            deformed = rest + 0.03 * rng.standard_normal((n, 3)).astype(np.float32)
            for solver in ("direct", "krylov"):
                c = dataclasses.replace(cfg, solver=solver)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                d = Deformer.fit(rest, deformed, c, params, device=dev)
                torch.cuda.synchronize()
                crossover[(name, n, solver)] = time.perf_counter() - t1
                del d
                torch.cuda.empty_cache()
            print(f"crossover {name} at {n}: fit {crossover[(name, n, 'direct')]:.3f} s direct, "
                  f"{crossover[(name, n, 'krylov')]:.3f} s krylov (host clock, one fit each)  "
                  f"[{label}]", flush=True)
    return {"launches": launches, "rigs": {k: {kk: vv for kk, vv in r.items()
                                               if kk not in ("rest", "deformer")}
                                           for k, r in results.items()},
            "shot_s": shot_s, "crossover": crossover}


def main_path_drag(dev, label: str) -> dict:
    """Phase 6e: the interactive drag.  The default config at 1000
    controls: Deformer.fit_with_plan, then DRAGS marker drags through
    plan.refit + apply on the 1M sphere (the culled kernel), each refit
    model bit-equal to Deformer.fit of its pose; a TPS plan at 4096
    controls (GMRES-IR against stored factors, the precise kernel), the
    same way; refit against fit in CUDA-event ms; then apply(spatial_perm=)
    against the natural order on a randomly permuted sphere."""
    from facedeform_tpu_torch import DeformConfig, DeformParams, Deformer
    from facedeform_tpu_torch.benchmark import stats, time_cuda
    from facedeform_tpu_torch.config import RBFKernel, RBFModelType
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points, uv_sphere
    from facedeform_tpu_torch.ops import cuda_eval, cuda_precise
    from facedeform_tpu_torch.ops.morton import spatial_order

    rng = np.random.default_rng(11)
    pts = torch.as_tensor(uv_sphere(1000, 1000).points, device=dev)
    v = pts.shape[0]
    fields = ("ctrl", "w_rbf", "w_poly", "eps", "w_rbf_lo", "w_poly_lo")

    def same(a, b):
        return all(bool(torch.equal(getattr(a, f), getattr(b, f))) for f in fields)

    def event_ms(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def drags(rest, n_drags):
        """Marker drags: each moves 10 markers of the last pose by ~0.01."""
        pose = rest.copy()
        for _ in range(n_drags):
            pose = pose.copy()
            moved = rng.choice(len(rest), 10, replace=False)
            pose[moved] += 0.01 * rng.standard_normal((10, 3)).astype(np.float32)
            yield pose

    counters = (cuda_eval.evaluate_cuda, cuda_eval.evaluate_cuda_culled,
                cuda_eval.control_records, cuda_eval.culled_tables,
                cuda_precise.evaluate_cuda_precise,
                cuda_solve.lu_solve_cuda)
    out = {}
    for name, cfg, params, n, n_drags in (
            ("default", DeformConfig(), DeformParams(), DRAG_N, DRAGS),
            ("TPS", DeformConfig(model=RBFModelType.KERNEL, kernel=RBFKernel.THIN_PLATE),
             DeformParams(radius=1.0, lam=0.01), TPS_PLAN_N, TPS_DRAGS)):
        rest = fibonacci_points(n)
        _, plan = Deformer.fit_with_plan(rest, next(drags(rest, 1)), cfg, params, device=dev)
        torch.cuda.synchronize()
        since = profiling.counters()
        refit_ms, apply_ms, fit_ms, equal = [], [], [], []
        t0 = time.perf_counter()
        for pose in drags(rest, n_drags):
            d, ms = event_ms(lambda: plan.refit(pose))
            refit_ms.append(ms)
            (moved, _), ms = event_ms(lambda: d.apply(pts))
            apply_ms.append(ms)
            _check(bool(torch.isfinite(moved).all()), f"{name}: a drag's apply is not finite")
            ref, ms = event_ms(lambda: Deformer.fit(rest, pose, cfg, params, device=dev))
            fit_ms.append(ms)
            equal.append(same(d.model, ref.model))
        wall = time.perf_counter() - t0
        launches = _launch_counts(counters, since)
        r, a, f = (stats(x) for x in (refit_ms, apply_ms, fit_ms))
        print(f"drag {name} {n}: {n_drags} drags in {wall:.3f} s wall; refit {r[0]:.4f} ms best, "
              f"{r[1]:.4f} median; fit of the same poses {f[0]:.4f} ms best, {f[1]:.4f} "
              f"median ({f[1] / r[1]:.2f}x the refit); apply at {v} verts {a[0]:.4f} ms best, "
              f"{a[1]:.4f} median (CUDA events); refit == fit bit for bit: {all(equal)}; "
              f"launches {launches}  [{label}]", flush=True)
        _check(all(equal), f"{name}: a refit model differs from Deformer.fit of its pose")
        solves = profiling.counter("fit.lu_solves") - since["fit.lu_solves"]
        _check(launches["lu_solve_cuda"] == solves > 0,
               f"{name}: {solves} LU solves, {launches['lu_solve_cuda']} kernel launches")
        if cfg.kernel == RBFKernel.THIN_PLATE:
            _check(launches["evaluate_cuda_precise"] == n_drags,
                   "each TPS drag's apply must launch the precise kernel once")
        else:
            _check(launches["evaluate_cuda_culled"] == n_drags
                   and launches["culled_tables"] == n_drags,
                   "each drag's apply must launch the culled kernel once")
        out[name] = {"refit_ms": r, "fit_ms": f, "apply_ms": a, "launches": launches,
                     "deformer": d}

    # apply(spatial_perm=) against the natural order of a shuffled sphere
    d = out["default"].pop("deformer")
    out["TPS"].pop("deformer")
    gen = torch.Generator(device=dev).manual_seed(0)
    shuffled = pts[torch.randperm(v, generator=gen, device=dev)].contiguous()
    sp = spatial_order(shuffled)
    fns = {
        "apply, shuffled order": lambda: d.apply(shuffled),
        "apply(spatial_perm=), shuffled": lambda: d.apply(shuffled, spatial_perm=sp),
        "apply, the sphere's order": lambda: d.apply(pts),
        "spatial_order (Morton codes + argsort)": lambda: spatial_order(shuffled),
        f"gather of {v} rows": lambda: shuffled[sp[0]],
    }
    times = {k: stats(t) for k, t in time_cuda(fns).items()}
    for k, (best, med, spread) in times.items():
        print(f"time {k}: {best:.4f} ms best, {med:.4f} median, spread {spread * 100:.1f}% at "
              f"{v} x {DRAG_N}  [{label}]")
    err = float(torch.max(torch.abs(fns["apply(spatial_perm=), shuffled"]()[0]
                                    - fns["apply, shuffled order"]()[0])))
    print(f"apply(spatial_perm=) vs the shuffled order: max |d| {err:.3e} "
          f"(tol {POS_TOL_DECAYING:g})")
    _check(err <= POS_TOL_DECAYING, "apply(spatial_perm=) disagrees with the natural order")
    out["spatial_perm"] = times
    return out


# Phase 8, the capture chain: the reference SOP's cook order at the main
# path's mesh.  Capture rig: the main path's 1000 Fibonacci markers, class
# = octant, maxedges 32, radius 0.1; DBSE: 52 blendshapes (the ARKit face
# rig's count), normal bumps of radius 0.2 and amplitude 0.05; the rig
# tools at the JAX package's own example sizes (select 2000 of 50,000,
# decimate.py:20-21) and a 2000-control LOOCV rig.
CAPTURE_MARKERS, CAPTURE_MAXEDGES, CAPTURE_RADIUS = 1000, 32, 0.1
# 8b's falloff radius: under the markers' covering radius (~0.07 on the
# unit sphere), so the capture distances freeze a share of the vertices
GATE_RADIUS = 0.05
CAPTURE_RTOL, CAPTURE_ATOL = 1e-5, 1e-6   # dist2 vs float64 (tests/test_capture.py)
GEODESIC_RTOL = 1e-5                      # native Dijkstra vs scipy's
DBSE_SHAPES, DBSE_BUMP_RADIUS, DBSE_BUMP_AMP = 52, 0.2, 0.05
DBSE_W_TOL = 1e-4                         # weights and reconstruction (tests/test_dbse.py)
DBSE_PARITY_RTOL, DBSE_PARITY_ATOL = 1e-4, 1e-5
DBSE_BATCHED_TOL = 1e-6                   # batched vs per-frame weights
DBSE_OUTLIER_FRAC = 0.02
MORPH_TOL = 1e-5                          # morph_apply vs its float64 formula
PARITY_HOST_LIMIT_S = 30.0                # the packed QR's host time at full width
BAKE_SV_RTOL = 1e-4                       # bake singular values vs float64 (tests/test_blendshapes.py)
DECIMATE_N, DECIMATE_K = 50_000, 2000
LOOCV_N, LOOCV_REFITS, LOOCV_RTOL = 2000, 20, 1e-4


def _octants(x):
    return ((x[:, 0] > 0).astype(np.int32) + 2 * (x[:, 1] > 0).astype(np.int32)
            + 4 * (x[:, 2] > 0).astype(np.int32))


def _timed(fn, dev):
    """(result, host seconds): the host clock around fn and a synchronize
    (host steps, and device steps where they end in a host copy)."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _within(got, want, rtol, atol) -> float:
    """max of |got - want| / (atol + rtol |want|): <= 1 passes."""
    return float(torch.max(torch.abs(got.double() - want) / (atol + rtol * torch.abs(want))))


def _min_sqdist64_points(p, ctrl, chunk=1 << 22):
    """float64 brute force: min over targets of exact squared distances."""
    c = ctrl.double()
    step = max(1, chunk // c.shape[0])
    return torch.cat([((q.double()[:, None] - c[None]) ** 2).sum(-1).amin(1)
                      for q in torch.split(p, step)])


def _min_sqdist64_triangles(p, tris, chunk=1 << 21):
    """float64 brute force, written apart from the port's closed form: the
    distance to the plane where the projection falls inside the triangle
    (same-side tests), else the least distance to the three edges."""
    t = tris.double()
    a, b, c = t[:, 0], t[:, 1], t[:, 2]
    n = torch.linalg.cross(b - a, c - a)
    nn = (n * n).sum(-1)

    def seg2(q, s0, s1):
        e = s1 - s0
        u = torch.clamp(((q - s0) * e).sum(-1) / (e * e).sum(-1), 0.0, 1.0)
        d = q - (s0 + u[..., None] * e)
        return (d * d).sum(-1)

    out = []
    for q in torch.split(p, max(1, chunk // t.shape[0])):
        q = q.double()[:, None]                                   # (C, 1, 3)
        h = ((q - a) * n).sum(-1)                                 # (C, T)
        inside = ((torch.linalg.cross((b - a)[None], q - a) * n).sum(-1) >= 0) \
            & ((torch.linalg.cross((c - b)[None], q - b) * n).sum(-1) >= 0) \
            & ((torch.linalg.cross((a - c)[None], q - c) * n).sum(-1) >= 0)
        edge = torch.minimum(torch.minimum(seg2(q, a, b), seg2(q, b, c)), seg2(q, c, a))
        out.append(torch.where(inside, h * h / nn, edge).amin(1))
    return torch.cat(out)


def _bump_shapes(points, n, seed):
    """n blendshapes: smooth normal bumps at seeded sites on the sphere."""
    rng = np.random.default_rng(seed)
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points

    sites = fibonacci_points(4 * n)[rng.choice(4 * n, n, replace=False)]
    normal = points / np.linalg.norm(points, axis=1, keepdims=True)
    return [(points + DBSE_BUMP_AMP * np.exp(-np.sum((points - s) ** 2, -1)
                                             / DBSE_BUMP_RADIUS ** 2)[:, None] * normal
             ).astype(np.float32) for s in sites]


def _shot_b(pts, dev):
    """Slice B's 8-pose shot (phase 5's rig recipe) through fit_frames +
    apply_frames on pts, without capture or tangent frame: (8, V, 3)."""
    from facedeform_tpu_torch import DeformConfig, DeformParams
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points
    from facedeform_tpu_torch.ops import temporal
    from facedeform_tpu_torch.parallel import batched

    rng = np.random.default_rng(0)
    rest = fibonacci_points(1000)
    raw = np.stack([rest + 0.05 * rng.standard_normal((1000, 3)).astype(np.float32)
                    for _ in range(8)])
    frames = temporal.smooth_frames(raw, window=5)
    cfg, params = DeformConfig(), DeformParams()
    model, _ = batched.fit_frames(rest, frames, cfg, params, device=dev)
    v = pts.shape[0]
    out, _ = batched.apply_frames(model, pts, torch.zeros(v, device=dev),
                                  torch.ones(v, device=dev), cfg, params)
    return out


def main_path_capture(dev, label: str, n_side: int = 1000, decimate_n: int = DECIMATE_N,
                      decimate_k: int = DECIMATE_K, loocv_n: int = LOOCV_N) -> dict:
    """Phase 8: the capture chain, the reference SOP's cook order at the
    main path's mesh, uv_sphere(n_side, n_side) (1,000,002 vertices):
    8a capture (KD-tree seeds, the per-class flood, euclidean distances to
    points and to triangles on the card, geodesic on the host); 8b
    Deformer.fit + apply(dist2=) on "auto" and backend="cuda", and again
    with a group_mask parsed by grouppattern; 8c DBSE weights (lstsq,
    robust, parity, batched) and morph_apply; 8d the blendshape bake;
    8e select_markers / reduce_rig / fit_reduced and LOOCV autotune.
    Launch counters are set to 0 just before and read just after."""
    import scipy.spatial

    from facedeform_tpu_torch import DeformConfig, DeformParams, Deformer, native
    from facedeform_tpu_torch.capture import flood, geodesic
    from facedeform_tpu_torch.capture.capture import ProximityCapture
    from facedeform_tpu_torch.geometry.mesh import Mesh
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points, uv_sphere
    from facedeform_tpu_torch.geometry.topology import mesh_adjacency
    from facedeform_tpu_torch.ops import blendshapes, cuda_eval, dbse, decimate, distances, loocv
    from facedeform_tpu_torch.ops import fit as fit_mod
    from facedeform_tpu_torch.utils import errors

    on_card = dev.type == "cuda"
    _check(native.available(), "the fastgeo native library did not load: capture's host "
           "times would be the numpy/scipy fallbacks'")
    print(f"capture chain: native fastgeo loaded ({native.library_path()})", flush=True)
    counters = (cuda_eval.evaluate_cuda, cuda_eval.evaluate_cuda_culled,
                cuda_eval.control_records, cuda_eval.culled_tables,
                cuda_eval.evaluate_cuda_frames, cuda_eval.frames_stream,
                cuda_solve.lu_solve_cuda)
    since = profiling.counters()
    t_phase = time.perf_counter()
    rng = np.random.default_rng(8)
    mesh = uv_sphere(n_side, n_side)
    pts_np = mesh.points
    v = mesh.num_points
    pts = torch.as_tensor(pts_np, device=dev)
    markers = fibonacci_points(CAPTURE_MARKERS)
    classes = _octants(markers)
    rig = Mesh(points=markers)
    rig.set_attr("class", classes)
    hull = scipy.spatial.ConvexHull(markers).simplices.astype(np.int32)
    tri_rig = Mesh(points=markers, faces=hull)
    tri_rig.set_attr("class", classes)

    # ---- 8a capture
    kw = dict(max_edges=CAPTURE_MAXEDGES, radius=CAPTURE_RADIUS, dofalloff=True, falloffrate=1.0)
    res, walls = {}, {}
    for name, r, metric in (("points", rig, "euclidean"), ("triangles", tri_rig, "euclidean"),
                            ("geodesic", rig, "geodesic")):
        pc = ProximityCapture(device=dev)
        _, walls[f"init {name}"] = _timed(lambda: pc.init(mesh, r), dev)
        res[name], walls[f"capture {name}"] = _timed(
            lambda: pc.capture(**kw, metric=metric), dev)
    cap = res["points"]
    cap_idx = np.nonzero(cap.captured)[0]
    n_cap = len(cap_idx)
    print(f"8a capture at {v} verts, {CAPTURE_MARKERS} markers in {len(np.unique(classes))} "
          f"classes, maxedges {CAPTURE_MAXEDGES}, radius {CAPTURE_RADIUS}: {n_cap} captured "
          f"({100.0 * n_cap / v:.1f}%), {len(hull)} rig triangles, "
          f"{n_cap * len(hull)} point-triangle pairs  [{label}]", flush=True)
    for name in ("triangles", "geodesic"):
        _check(np.array_equal(res[name].captured, cap.captured),
               f"the {name} capture's islands differ from the point rig's")
    indptr, indices = mesh_adjacency(mesh)
    seeds = cap.seed_vertices
    _, t_adj = _timed(lambda: mesh_adjacency(mesh), dev)
    _, t_kd = _timed(lambda: native.nearest(pts_np, markers), dev)
    isl, t_flood = _timed(lambda: flood.find_islands(
        indptr, indices, seeds, classes.astype(np.int64), CAPTURE_MAXEDGES), dev)
    offsets = np.linalg.norm(markers - pts_np[seeds], axis=1).astype(np.float32)
    saved = native.get_lib
    native.get_lib = lambda: None      # the numpy/scipy fallbacks
    try:
        isl_np, t_flood_np = _timed(lambda: flood.find_islands(
            indptr, indices, seeds, classes.astype(np.int64), CAPTURE_MAXEDGES), dev)
        geo_sp, t_geo_sp = _timed(lambda: geodesic.geodesic_distance(
            indptr, indices, pts_np, seeds, offsets), dev)
    finally:
        native.get_lib = saved
    _check(sorted(isl) == sorted(isl_np) and all(np.array_equal(isl[k], isl_np[k]) for k in isl),
           "the native flood's islands differ from the numpy fallback's")
    _check(all(np.array_equal(cap.islands[k], isl[k]) for k in isl),
           "capture's islands differ from the flood's")
    geo_nat, t_geo = _timed(lambda: geodesic.geodesic_distance(
        indptr, indices, pts_np, seeds, offsets), dev)
    g_rel = np.abs(geo_nat[cap_idx].astype(np.float64) - geo_sp[cap_idx]) / np.maximum(
        np.abs(geo_sp[cap_idx].astype(np.float64)), 1e-12)
    g_all = np.abs(geo_nat.astype(np.float64) - geo_sp) / np.maximum(np.abs(geo_sp), 1e-12)
    print(f"8a geodesic: native vs scipy dijkstra, captured verts max rel {g_rel.max():.3e} "
          f"(tol {GEODESIC_RTOL:g}); all verts {g_all.max():.3e}")
    _check(g_rel.max() <= GEODESIC_RTOL, "the native geodesic disagrees with scipy's dijkstra")
    _check(np.allclose(res["geodesic"].dist2[cap_idx], geo_nat[cap_idx] ** 2, rtol=1e-6),
           "the geodesic capture's dist2 is not the squared native geodesic")

    # distances against float64 brute force on the card, and alone (events)
    cap_pts = pts[torch.as_tensor(cap_idx, device=dev)]
    m_t = torch.as_tensor(markers, device=dev)
    tri_t = torch.as_tensor(markers[hull], device=dev)
    want_p = _min_sqdist64_points(cap_pts, m_t)
    want_t = _min_sqdist64_triangles(cap_pts, tri_t)
    got = {k: torch.as_tensor(res[k].dist2[cap_idx], device=dev) for k in ("points", "triangles")}
    ep = _within(got["points"], want_p, CAPTURE_RTOL, CAPTURE_ATOL)
    et = _within(got["triangles"], want_t, CAPTURE_RTOL, CAPTURE_ATOL)
    print(f"8a dist2 vs float64 brute force over all {n_cap} captured verts, of "
          f"(atol {CAPTURE_ATOL:g} + rtol {CAPTURE_RTOL:g} |d2|): points {ep:.3e}, "
          f"triangles {et:.3e} (<= 1 passes)")
    _check(ep <= 1.0 and et <= 1.0, "capture dist2 disagrees with float64 brute force")
    _check(bool((got["triangles"] <= got["points"] + 1e-6).all()),
           "a point's distance to the hull exceeds its distance to the nearest marker")
    print(f"8a times (host s): init (KD-tree + adjacency) {walls['init points']:.3f}, "
          f"adjacency {t_adj:.3f}, KD nearest {t_kd:.4f}, flood {t_flood:.3f} (numpy "
          f"fallback {t_flood_np:.3f}), geodesic {t_geo:.3f} (scipy {t_geo_sp:.3f}); "
          f"capture() points {walls['capture points']:.3f}, triangles "
          f"{walls['capture triangles']:.3f}, geodesic {walls['capture geodesic']:.3f}  "
          f"[{label}]", flush=True)

    # ---- 8b the gated deform
    deformed = markers + 0.05 * rng.standard_normal(markers.shape).astype(np.float32)
    params = DeformParams(radius=GATE_RADIUS)
    d = Deformer.fit(markers, deformed, DeformConfig(), params, device=dev)
    d2 = torch.as_tensor(cap.dist2, device=dev)
    mesh.set_group("captured", cap.captured)
    mesh.set_group("south", pts_np[:, 1] < -0.5)
    mask_np = mesh.select_points("captured ^south")
    mask = torch.as_tensor(mask_np, device=dev)
    auto_pts, auto_w = d.apply(pts, dist2=d2)
    dense_pts, dense_w = d.apply(pts, dist2=d2, backend="cuda")
    g_pts, g_w = d.apply(pts, dist2=d2, group_mask=mask)
    g2_pts, _ = d.apply(pts, dist2=d2, group_mask=mask, backend="cuda")
    p = d.params.clamped()
    kernel = fit_mod.effective_kernel(d.cfg)
    ref, ref_w = cuda_eval.evaluate_reference(d.model, pts, d2, torch.ones_like(d2), p.radius,
                                              p.falloffrate, kernel, d.cfg.term)
    ref_g, ref_gw = cuda_eval.evaluate_reference(d.model, pts, d2, mask.float(), p.radius,
                                                 p.falloffrate, kernel, d.cfg.term)
    ref_g = torch.where(mask[:, None], ref_g, pts)
    errs_b = {"auto (culled)": float((auto_pts - ref).abs().max()),
              "cuda (dense)": float((dense_pts - ref).abs().max()),
              "gated auto": float((g_pts - ref_g).abs().max()),
              "gated cuda": float((g2_pts - ref_g).abs().max())}
    w_err = max(float((auto_w - ref_w).abs().max()), float((dense_w - ref_w).abs().max()),
                float((g_w - ref_gw).abs().max()))
    active = float((auto_w > 0).float().mean())
    beyond = d2 > p.radius * p.radius                  # the falloff's skip test
    print(f"8b gated deform at {v} x {CAPTURE_MARKERS} (capture dist2, radius "
          f"{p.radius:g}: {100 * active:.1f}% active, the capture gate freezes "
          f"{int(beyond.sum())} verts; group 'captured ^south': "
          f"{100 * mask_np.mean():.1f}%): vs the plain twin "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs_b.items())
          + f" (tol {POS_TOL_DECAYING:g}); falloff {w_err:.3e} (tol {FALLOFF_TOL:g})  [{label}]",
          flush=True)
    _check(max(errs_b.values()) <= POS_TOL_DECAYING and w_err <= FALLOFF_TOL,
           "a gated apply disagrees with its plain twin")
    _check(bool(beyond.any()), "the capture gate freezes no vertex")
    for name, out, w in (("auto", auto_pts, auto_w), ("cuda", dense_pts, dense_w)):
        still = w == 0
        _check(bool(still[beyond].all()), f"{name}: a vertex beyond the radius has weight")
        _check(bool(torch.equal(out[still], pts[still])), f"{name}: inactive vertices moved")
    off = ~mask | (g_w == 0)
    _check(bool(torch.equal(g_pts[off], pts[off])) and bool(torch.equal(g2_pts[off], pts[off])),
           "vertices outside the group or the falloff moved")
    _check(bool(torch.isfinite(g_pts).all()), "gated apply not finite")

    # ---- 8c DBSE
    shapes, t_shapes = _timed(lambda: _bump_shapes(pts_np, DBSE_SHAPES, seed=8), dev)
    model, t_build = _timed(lambda: dbse.build_model(pts_np, shapes, device=dev), dev)
    del shapes
    w_true = torch.as_tensor(rng.uniform(-0.5, 0.5, DBSE_SHAPES).astype(np.float32), device=dev)
    pose = pts + dbse.reconstruct(model, w_true, None, parity_scale=False)
    w_l, rep_l = dbse.weights_lstsq(model, pose, pts)
    errors.check_solve(rep_l)
    recon = pts + dbse.reconstruct(model, w_l, None, False)
    e_w, e_rec = float((w_l - w_true).abs().max()), float((recon - pose).abs().max())
    bad = torch.as_tensor(rng.choice(v, int(DBSE_OUTLIER_FRAC * v), replace=False), device=dev)
    pose_o = pose.clone()
    pose_o[bad] += 0.5 * torch.randn(len(bad), 3, device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(8))
    w_r, _ = dbse.weights_robust(model, pose_o, pts)
    w_lo, _ = dbse.weights_lstsq(model, pose_o, pts)
    e_r, e_lo = float((w_r - w_true).abs().max()), float((w_lo - w_true).abs().max())
    print(f"8c DBSE {DBSE_SHAPES} shapes x {v} verts (B {4 * 3 * v * DBSE_SHAPES / 1e6:.0f} MB): "
          f"lstsq |w - w_true| {e_w:.3e}, reconstruction {e_rec:.3e} (tol {DBSE_W_TOL:g}); "
          f"{100 * DBSE_OUTLIER_FRAC:g}% outliers: robust {e_r:.3e} (tol {DBSE_W_TOL:g}), "
          f"plain lstsq {e_lo:.3e}", flush=True)
    _check(e_w <= DBSE_W_TOL and e_rec <= DBSE_W_TOL, "DBSE lstsq misses the known weights")
    _check(e_r <= DBSE_W_TOL, "robust DBSE misses the known weights under outliers")

    # the parity route: the host float64 packed QR, timed on a subset first
    v_probe = min(v, 65536)
    sub = np.linspace(0, v - 1, v_probe).astype(np.int64)
    # a bump is a function of its vertex alone: the subset's shapes are the
    # full shapes' rows
    shapes_sub = _bump_shapes(pts_np[sub], DBSE_SHAPES, seed=8)
    _, t_probe = _timed(lambda: dbse.build_model(
        pts_np[sub], shapes_sub, parity=True, device=dev), dev)
    predicted = t_probe * v / v_probe
    v_par = (v if predicted <= PARITY_HOST_LIMIT_S
             else int(v_probe * 0.8 * PARITY_HOST_LIMIT_S / t_probe))
    v_par = min(max(v_par, v_probe), v)
    sub = np.linspace(0, v - 1, v_par).astype(np.int64)
    shapes_sub = _bump_shapes(pts_np[sub], DBSE_SHAPES, seed=8)
    model_p, t_par_build = _timed(lambda: dbse.build_model(
        pts_np[sub], shapes_sub, parity=True, device=dev), dev)
    del shapes_sub
    sub_t = torch.as_tensor(sub, device=dev)
    w_p = dbse.weights_parity(model_p, pose[sub_t], pts[sub_t])
    twin = (pose[sub_t] - pts[sub_t]).double().reshape(-1) @ model_p.packed_qr.double()
    e_par = _within(w_p, twin, DBSE_PARITY_RTOL, DBSE_PARITY_ATOL)
    cut = "" if v_par == v else (f"; CUT to {v_par} verts: at {v_probe} the packed QR took "
                                 f"{t_probe:.2f} s, {predicted:.1f} s predicted at {v}")
    print(f"8c parity route at {v_par} verts: packed QR + model {t_par_build:.2f} s (host "
          f"float64){cut}; weights vs the float64 twin {e_par:.3e} of (atol "
          f"{DBSE_PARITY_ATOL:g} + rtol {DBSE_PARITY_RTOL:g}|w|) (<= 1 passes)  [{label}]",
          flush=True)
    _check(e_par <= 1.0, "parity weights disagree with the float64 twin")

    # batched over slice B's 8-pose shot
    shot = _shot_b(pts, dev)
    w_b, rep_b = dbse.weights_lstsq_batched(model, shot, pts)
    e_b = max(float((w_b[f] - dbse.weights_lstsq(model, shot[f], pts)[0]).abs().max())
              for f in range(shot.shape[0]))
    _check(bool(errors.frames_solve_ok(rep_b).all()), "a batched DBSE frame failed its solve")
    print(f"8c batched over slice B's 8-pose shot: vs per-frame calls {e_b:.3e} (tol "
          f"{DBSE_BATCHED_TOL:g})")
    _check(e_b <= DBSE_BATCHED_TOL, "batched DBSE weights disagree with per-frame calls")

    # the morph stage on 8b's gated output, gated by the group (node.py:990-1000)
    cfg_m = DeformConfig(dofalloff=True, morphspace=True)
    w_g, rep_g = dbse.weights_lstsq(model, g_pts, pts)
    errors.check_solve(rep_g)
    morphed = dbse.morph_apply(model, g_pts, pts, w_g, cfg_m, params)
    out = torch.where(mask[:, None], morphed, g_pts)
    want = (pts.double() + (w_g.double() @ model.deltas.double().reshape(DBSE_SHAPES, -1))
            .reshape(-1, 3) + (g_pts.double() - pts.double()) * params.falloffradius)
    e_m = float((morphed.double() - want).abs().max())
    print(f"8c morph_apply vs its float64 formula {e_m:.3e} (tol {MORPH_TOL:g}); host: shapes "
          f"{t_shapes:.2f} s, build_model {t_build:.2f} s  [{label}]", flush=True)
    _check(e_m <= MORPH_TOL, "morph_apply disagrees with its float64 formula")
    _check(bool(torch.isfinite(out).all()) and bool(torch.equal(out[~mask], g_pts[~mask])),
           "the gated morph is not finite or moved vertices outside the group")

    # ---- 8d the bake
    (bake, brep), t_bake = _timed(lambda: blendshapes.fit_blendshapes(
        pts, shot, rank=8, device=dev), dev)
    d64 = (shot.double() - pts.double()[None]).reshape(shot.shape[0], -1)
    d64 = d64 - d64.mean(0)
    s64 = torch.sqrt(torch.clamp(torch.linalg.eigvalsh(d64 @ d64.T), min=0.0)).flip(0).cpu().numpy()
    alive = s64 > 1e-6 * s64[0]
    sv_err = float(np.max(np.abs(brep.singular_values[alive] - s64[alive]) / s64[alive]))
    scale = float((shot - pts[None]).abs().max())
    shapes_b, t_meshes = _timed(lambda: blendshapes.blendshape_meshes(bake, mesh), dev)
    dm = dbse.build_model(pts_np, [m.points for m in shapes_b], device=dev)
    del shapes_b
    # no ridge: the default 1e-6 tr/S ridge biases the smallest mode's
    # weights by ~1e-3 (its Gram diagonal is far below the mean target's)
    w_back, _ = dbse.weights_lstsq_batched(dm, shot, pts, ridge=0.0)
    e_back = float((w_back - bake.weights).abs().max())
    print(f"8d bake of the 8-pose shot at {v}: {bake.n_targets} targets, max err "
          f"{brep.max_err:.3e} (tol {2e-5 * max(scale, 1.0):.3e}), singular values vs float64 "
          f"{sv_err:.3e} (rtol {BAKE_SV_RTOL:g}), blendshape_meshes -> build_model -> weights "
          f"(no ridge) vs the bake's curves {e_back:.3e} (tol {DBSE_W_TOL:g}); fit_blendshapes "
          f"{t_bake:.3f} s, blendshape_meshes {t_meshes:.3f} s  [{label}]", flush=True)
    _check(brep.max_err <= 2e-5 * max(scale, 1.0), "the full-rank bake does not reconstruct")
    _check(sv_err <= BAKE_SV_RTOL, "bake singular values disagree with float64")
    _check(e_back <= DBSE_W_TOL, "the baked meshes do not give back the bake's weights")
    del dm

    # ---- 8e the rig tools
    rest_n = fibonacci_points(decimate_n)
    def_n = (rest_n + 0.05 * np.sin(3.0 * rest_n[:, [1, 2, 0]])
             + 0.001 * rng.standard_normal(rest_n.shape)).astype(np.float32)
    traces = []
    for k in (decimate_k // 8, decimate_k // 4, decimate_k // 2):
        traces.append(decimate.select_markers(rest_n, k, device=dev)[1].residual_trace)
    (idx, sel), t_sel = _timed(lambda: decimate.select_markers(
        rest_n, decimate_k, device=dev), dev)
    traces.append(sel.residual_trace)
    (_, red), t_red = _timed(lambda: decimate.reduce_rig(
        rest_n, def_n, decimate_k, device=dev), dev)
    (rm, rrep, rinfo), t_fr = _timed(lambda: decimate.fit_reduced(
        rest_n, def_n, decimate_k, idx=idx, device=dev), dev)
    errors.check_solve(rrep)
    dr = Deformer(model=rm, cfg=DeformConfig(), params=DeformParams(), report=rrep, reduced=True)
    r_pts, _ = dr.apply(pts)
    print(f"8e select_markers {decimate_k} of {decimate_n}: {t_sel:.3f} s, residual traces at k = "
          f"{decimate_k // 8}/{decimate_k // 4}/{decimate_k // 2}/{decimate_k}: "
          + "/".join(f"{t:.4e}" for t in traces)
          + f"; reduce_rig {t_red:.3f} s, error at the {decimate_n - decimate_k} dropped markers "
          f"max {red.max_err:.3e}, rms {red.rms_err:.3e} ({100 * red.relative_max_err:.2f}% of "
          f"motion {red.motion_scale:.3e}); fit_reduced {t_fr:.3f} s (fit rms {rinfo.fit_rms:.3e}, "
          f"max {rinfo.fit_max:.3e})  [{label}]", flush=True)
    _check(all(a > b for a, b in zip(traces, traces[1:])), "the residual trace does not fall")
    _check(len(np.unique(idx)) == decimate_k, "select_markers picked a marker twice")
    _check(all(bool(torch.isfinite(t).all()) for t in (rm.w_rbf, rm.w_poly, rm.eps, r_pts)),
           "the reduced model or its apply is not finite")

    rest_l = fibonacci_points(loocv_n)
    def_l = (rest_l + 0.05 * np.sin(3.0 * rest_l[:, [1, 2, 0]])
             + 0.002 * rng.standard_normal(rest_l.shape)).astype(np.float32)
    (tuned, diag), t_auto = _timed(lambda: loocv.autotune(rest_l, def_l, device=dev), dev)
    ctrl = torch.as_tensor(rest_l, device=dev)
    delta = torch.as_tensor(def_l - rest_l, device=dev)
    eps = fit_mod._qnn_radii(ctrl, tuned.qcoef, tuned.zcoef)
    e, _ = loocv.loocv_errors(ctrl, delta, fit_mod.effective_kernel(DeformConfig()),
                              DeformConfig().term, eps, 0.0)
    picks = np.linspace(0, loocv_n - 1, LOOCV_REFITS).astype(np.int64)
    c64, d64_, eps64 = ctrl.double(), delta.double(), eps.double()
    e64 = []
    for i in picks:
        keep = torch.ones(loocv_n, dtype=torch.bool, device=dev)
        keep[int(i)] = False
        c, ep = c64[keep], eps64[keep]
        n1 = loocv_n - 1
        p_c = torch.cat([torch.ones(n1, 1, dtype=torch.float64, device=dev), c], 1)
        a = torch.zeros(n1 + 4, n1 + 4, dtype=torch.float64, device=dev)
        a[:n1, :n1] = torch.exp(-((c[:, None] - c[None]) ** 2).sum(-1) / ep[None] ** 2)
        a[:n1, n1:] = p_c
        a[n1:, :n1] = p_c.T
        a[n1:, n1:] = -1e-8 * torch.eye(4, dtype=torch.float64, device=dev)
        x = torch.linalg.solve(a, torch.cat([d64_[keep], torch.zeros(4, 3, dtype=torch.float64,
                                                                     device=dev)]))
        xi = c64[int(i):int(i) + 1]
        pred = (torch.exp(-((xi[:, None] - c[None]) ** 2).sum(-1) / ep[None] ** 2) @ x[:n1]
                + torch.cat([torch.ones(1, 1, dtype=torch.float64, device=dev), xi], 1) @ x[n1:])
        e64.append(pred[0] - d64_[int(i)])
    e64 = torch.stack(e64)
    e_loo = float((e[torch.as_tensor(picks, device=dev)].double() - e64).abs().max()
                  / e64.abs().max())
    print(f"8e loocv.autotune at {loocv_n} controls (default config): {t_auto:.3f} s for "
          f"{diag['scores'].size} candidates, best factor {diag['best_factor']:g} (score "
          f"{diag['best_score']:.4e}); Rippa errors vs {LOOCV_REFITS} float64 leave-one-out "
          f"refits {e_loo:.3e} of max |e| (tol {LOOCV_RTOL:g})  [{label}]", flush=True)
    _check(e_loo <= LOOCV_RTOL, "LOOCV's closed form disagrees with explicit refits")

    wall = time.perf_counter() - t_phase
    launches = _launch_counts(counters, since)
    if on_card:
        # the device steps alone: CUDA events over interleaved rounds, one
        # warm-up call each (benchmark.time_cuda), after the counters are read
        from facedeform_tpu_torch.benchmark import stats, time_cuda

        shot64 = shot.repeat(8, 1, 1)                  # a longer shot: the per-frame cost
        fns = {
            f"points query ({n_cap} x {CAPTURE_MARKERS})":
                lambda: distances.min_sqdist_to_points(cap_pts, m_t),
            f"triangles query ({n_cap} x {len(hull)})":
                lambda: distances.min_sqdist_to_triangles(cap_pts, tri_t),
            "apply(dist2) auto (culled)": lambda: d.apply(pts, dist2=d2),
            "apply(dist2) cuda (dense)": lambda: d.apply(pts, dist2=d2, backend="cuda"),
            "apply(dist2, group_mask) auto": lambda: d.apply(pts, dist2=d2, group_mask=mask),
            "weights_lstsq": lambda: dbse.weights_lstsq(model, pose, pts),
            "weights_robust": lambda: dbse.weights_robust(model, pose_o, pts),
            f"weights_parity (at {v_par})":
                lambda: dbse.weights_parity(model_p, pose[sub_t], pts[sub_t]),
            "weights_lstsq_batched (8 frames)": lambda: dbse.weights_lstsq_batched(model, shot, pts),
            "weights_lstsq_batched (64 frames)":
                lambda: dbse.weights_lstsq_batched(model, shot64, pts),
            "reconstruct": lambda: dbse.reconstruct(model, w_l, None, False),
            "morph_apply": lambda: dbse.morph_apply(model, g_pts, pts, w_g, cfg_m, params),
            "fit_blendshapes (rank 8, 8 frames)":
                lambda: blendshapes.fit_blendshapes(pts, shot, rank=8, device=dev),
            f"reduced Deformer apply ({decimate_k} centers)": lambda: dr.apply(pts),
        }
        slow = {k: 1 for k in fns if k.startswith(("triangles", "weights_robust", "fit_blend"))}
        times = time_cuda(fns, rounds=3, iters={k: slow.get(k, 5) for k in fns})
        for k, ms in times.items():
            best, med, spread = stats(ms)
            print(f"8 time {k}: {best:.4f} ms best, {med:.4f} median, spread "
                  f"{100 * spread:.1f}% at {v} verts  [{label}]", flush=True)
    print(f"capture chain: {wall:.1f} s wall; launches {launches}  [{label}]", flush=True)
    if on_card:
        _check(launches["evaluate_cuda"] > 0, "the capture chain did not launch the dense kernel")
        _check(launches["evaluate_cuda_culled"] > 0,
               "the capture chain did not launch the culled kernel")
    return {"launches": launches, "wall_s": wall}


# Phase 9, the node's cook: FaceDeformNode.cook, the entry point a user
# calls, at the main path's width (the 1M sphere, phase 8's 1000 markers
# in 8 classes and 52 blendshapes), capture -> solve -> eval (autotuned)
# -> morph -> PSD -> transport -> secondaries.
NODE_DRAGS = 16
NODE_PSD_EXAMPLES = 4
NODE_PU_N = 30_000
NODE_TPS_N = 4096
NODE_SUBSET = 65536
NODE_SMALL_TOL = 5e-5      # of the motion scale: card vs CPU cook at test size


def _node_inputs(mesh_cls, pts, faces, markers, classes, pose):
    mesh = mesh_cls(points=pts, faces=faces)
    rest = mesh_cls(points=markers)
    rest.set_attr("class", classes)
    return mesh, rest, mesh_cls(points=pose)


def _cook_timed(node, inputs, cfg, params, dev, **kw):
    """(CookResult, wall s, StageTimes) of one cook; the cook ends in host
    copies, the synchronize fences anything left."""
    from facedeform_tpu_torch.utils.profiling import StageTimes

    times = StageTimes()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = node.cook(inputs, cfg, params, times=times, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0, times


def _node_small_check(dev, label: str) -> float:
    """The card's cook against the port's CPU cook at test size
    (uv_sphere(40, 40), 30 markers): capture, morph, transport; returns
    the error over the motion scale."""
    from facedeform_tpu_torch import DeformConfig, DeformParams, FaceDeformNode, Mesh
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points, uv_sphere

    sphere = uv_sphere(40, 40)
    pts = sphere.points
    markers = fibonacci_points(30)
    bump = 0.2 * np.exp(-2 * np.sum((markers - [0, 1, 0]) ** 2, -1, keepdims=True))
    pose = (markers + bump * np.float32([0.3, 1.0, 0.0])).astype(np.float32)
    shapes = _bump_shapes(pts, 3, seed=5)
    rng = np.random.default_rng(9)
    v_attr = rng.standard_normal(pts.shape).astype(np.float32)
    cfg = DeformConfig(dofalloff=True, morphspace=True)
    params = DeformParams(radius=0.8, maxedges=8, falloffradius=0.5)
    out = {}
    for where in (dev, torch.device("cpu")):
        mesh, rest, posed = _node_inputs(Mesh, pts, sphere.faces, markers,
                                         (np.arange(30) % 3).astype(np.int32), pose)
        mesh.set_attr("N", (pts / np.linalg.norm(pts, axis=1, keepdims=True)).astype(np.float32))
        mesh.set_attr("v", v_attr)
        res = FaceDeformNode(device=where).cook(
            [mesh, rest, posed] + [Mesh(points=s) for s in shapes], cfg, params,
            update_normals=True, transform_attrs=["v"], output_stretch=True)
        out[where.type] = res
    card, cpu = out[dev.type], out["cpu"]
    scale = float(np.abs(cpu.mesh.points - pts).max())
    err = float(np.abs(card.mesh.points.astype(np.float64) - cpu.mesh.points).max()) / scale
    e_n = float(np.abs(card.mesh.attr("N") - cpu.mesh.attr("N")).max())
    e_w = float(np.abs(card.mesh.attr("fd_falloff") - cpu.mesh.attr("fd_falloff")).max())
    print(f"9 test size ({len(pts)} verts x 30 markers, capture + morph + transport): card "
          f"vs CPU cook max |dP| {err:.3e} of scale {scale:.3e} (tol {NODE_SMALL_TOL:g}); "
          f"N {e_n:.3e}, fd_falloff {e_w:.3e}  [{label}]", flush=True)
    _check(err <= NODE_SMALL_TOL, "the card's cook disagrees with the CPU cook at test size")
    _check(e_w <= FALLOFF_TOL and card.warnings == cpu.warnings,
           "the card's cook's falloff or warnings differ from the CPU cook's")
    return err


def main_path_node(dev, label: str, n_side: int = 1000, pu_n: int = NODE_PU_N,
                   tps_n: int = NODE_TPS_N, n_shapes: int = DBSE_SHAPES) -> dict:
    """Phase 9: the node's cook at the main path's width.  9a a cold cook
    (capture with the 1000 markers in 8 classes, dofalloff, morphspace
    lstsq over 52 blendshapes, update_normals, transform_attrs=["v"],
    output_stretch), a warm cook and NODE_DRAGS drag cooks (FitPlan
    refit); 9b symmetrize="x" with PSD over NODE_PSD_EXAMPLES example
    poses and a cook at a further pose; 9c solver="pu" at pu_n controls,
    cold and warm (plan cached); 9d a TPS cook at tps_n controls; 9e two
    secondary meshes with recompute_normals (the keywords cut the sizes
    for a rehearsal on the CPU).  Launch
    counters are set to 0 just before the cooks and read just after them,
    before the checks: a drag cook against a fresh node's cook of the
    same pose, the RBF pass against Deformer.apply on the autotune's
    backend bit for bit, the transported N against the plain Jacobian
    route on a NODE_SUBSET-vertex subset, a PSD cook at an example pose
    against its sculpt, and the card's cook against the CPU's at test
    size."""
    from facedeform_tpu_torch import DeformConfig, DeformParams, FaceDeformNode, Mesh
    from facedeform_tpu_torch.config import RBFKernel, RBFModelType
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points, uv_sphere
    from facedeform_tpu_torch.ops import cuda_eval, cuda_jacobian, cuda_precise, cuda_pu
    from facedeform_tpu_torch.ops import jacobian as jac_mod
    from facedeform_tpu_torch.ops.fit import effective_kernel

    counters = (cuda_eval.evaluate_cuda, cuda_eval.evaluate_cuda_culled,
                cuda_eval.control_records, cuda_eval.culled_tables,
                cuda_precise.evaluate_cuda_precise, cuda_jacobian.jacobian_cuda,
                cuda_jacobian.jacobian_cuda_frames, cuda_pu.evaluate_pu_tiles,
                cuda_pu.evaluate_pu_tiles_frames,
                cuda_solve.lu_solve_cuda)
    t_phase = time.perf_counter()
    rng = np.random.default_rng(9)
    sphere = uv_sphere(n_side, n_side)
    pts = sphere.points
    v = len(pts)
    normals = (pts / np.linalg.norm(pts, axis=1, keepdims=True)).astype(np.float32)
    v_attr = rng.standard_normal(pts.shape).astype(np.float32)
    markers = fibonacci_points(CAPTURE_MARKERS)
    classes = _octants(markers)
    pose0 = markers + 0.05 * rng.standard_normal(markers.shape).astype(np.float32)
    shapes = [Mesh(points=s) for s in _bump_shapes(pts, n_shapes, seed=8)]

    def inputs(pose):
        mesh, rest, posed = _node_inputs(Mesh, pts, sphere.faces, markers, classes, pose)
        mesh.set_attr("N", normals)
        mesh.set_attr("v", v_attr)
        return mesh, rest, posed

    def drags(start, n):
        pose = start
        for _ in range(n):
            pose = pose.copy()
            moved = rng.choice(len(pose), 10, replace=False)
            pose[moved] += 0.01 * rng.standard_normal((10, 3)).astype(np.float32)
            yield pose

    mesh, rest, posed = inputs(pose0)
    cfg = DeformConfig(dofalloff=True, morphspace=True)
    params = DeformParams(radius=CAPTURE_RADIUS, maxedges=CAPTURE_MAXEDGES)
    kw = dict(update_normals=True, transform_attrs=["v"], output_stretch=True)
    t_setup = time.perf_counter() - t_phase
    since = profiling.counters()
    t_cooks = time.perf_counter()
    walls = {}

    def show(name, res, wall, times, extra=""):
        walls[name] = wall
        print(f"9 cook {name}: {1e3 * wall:.2f} ms wall; stages {times.summary()}; outside "
              f"them {1e3 * wall - sum(times.ms.values()):.2f} ms{extra}  [{label}]", flush=True)

    # ---- 9a cold, warm, drags
    node = FaceDeformNode(device=dev)
    res_cold, wall, times = _cook_timed(node, [mesh, rest, posed] + shapes, cfg, params, dev, **kw)
    show("9a cold", res_cold, wall, times)
    backend, timings = node.last_backend, dict(node.backend_timings)
    print(f"9a autotune at {v} verts x {CAPTURE_MARKERS}: chose {backend!r}; best of 2 after a "
          f"warm-up (CUDA events): " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in timings.items())
          + f"  [{label}]", flush=True)
    res_warm, wall, times = _cook_timed(node, [mesh, rest, posed] + shapes, cfg, params, dev, **kw)
    show("9a warm", res_warm, wall, times)
    drag_ms, drag_times = [], []
    for pose in drags(pose0, NODE_DRAGS):
        res_drag, wall, times = _cook_timed(node, [mesh, rest, Mesh(points=pose)] + shapes,
                                            cfg, params, dev, **kw)
        drag_ms.append(1e3 * wall)
        drag_times.append(times)
        print(f"9a drag {len(drag_ms)}: {drag_ms[-1]:.2f} ms wall; stages {times.summary()}; "
              f"outside them {drag_ms[-1] - sum(times.ms.values()):.2f} ms", flush=True)
    last_pose = pose
    plan_kept = node._plan is not None
    print(f"9a {NODE_DRAGS} drag cooks: {min(drag_ms):.2f} ms best, {float(np.median(drag_ms)):.2f}"
          f" median wall; the FitPlan refit each time: {plan_kept}  [{label}]", flush=True)
    # the RBF pass alone (morphspace off, no transport): the same deformer
    rbf_node_res, wall, times = _cook_timed(node, [mesh, rest, Mesh(points=last_pose)],
                                            DeformConfig(dofalloff=True), params, dev)
    show("9a RBF only (warm)", rbf_node_res, wall, times)
    rbf_backend = node.last_backend

    # ---- 9b symmetrize + PSD
    def sculpt(k):
        c = fibonacci_points(16)[3 * k + 1]
        g = np.exp(-np.sum((pts - c) ** 2, -1) / 0.1)
        return Mesh(points=(pts + 0.03 * (k + 1) * g[:, None] * normals).astype(np.float32))

    ex_poses = [markers + (0.04 * rng.standard_normal(markers.shape)).astype(np.float32)
                for _ in range(NODE_PSD_EXAMPLES)]
    examples = [(Mesh(points=p), sculpt(k)) for k, p in enumerate(ex_poses)]
    cfg_b = DeformConfig(dofalloff=True)
    node_b = FaceDeformNode(device=dev)
    mesh_b, rest_b, _ = inputs(pose0)
    res_b_ex, wall, times = _cook_timed(node_b, [mesh_b, rest_b, examples[0][0]], cfg_b, params,
                                        dev, symmetrize="x", examples=examples)
    show("9b symmetrize + PSD fit, at example 0", res_b_ex, wall, times,
         f"; {res_b_ex.messages[0]}; {res_b_ex.messages[-1]}")
    fifth = markers + (0.04 * rng.standard_normal(markers.shape)).astype(np.float32)
    res_b, wall, times = _cook_timed(node_b, [mesh_b, rest_b, Mesh(points=fifth)], cfg_b, params,
                                     dev, symmetrize="x", examples=examples)
    show("9b symmetrize + PSD at a fifth pose", res_b, wall, times,
         f"; psd_weights {np.round(res_b.mesh.detail_attrs['psd_weights'], 4).tolist()}")

    # ---- 9c PU
    pu_rest, pu_frames = _bump_rig(pu_n)
    cfg_c = DeformConfig(model=RBFModelType.KERNEL, kernel=RBFKernel.THIN_PLATE, solver="pu")
    params_c = DeformParams(lam=1e-5)
    node_c = FaceDeformNode(device=dev)
    mesh_c = Mesh(points=pts, faces=sphere.faces)
    pu_in = [mesh_c, Mesh(points=pu_rest), Mesh(points=pu_frames[0])]
    res_c, wall, times = _cook_timed(node_c, pu_in, cfg_c, params_c, dev)
    show(f"9c PU at {pu_n} (cold)", res_c, wall, times)
    res_c2, wall, times = _cook_timed(node_c, pu_in, cfg_c, params_c, dev)
    show(f"9c PU at {pu_n} (warm, plan cached)", res_c2, wall, times)

    # ---- 9d TPS
    tps_rest = fibonacci_points(tps_n)
    tps_pose = (tps_rest + 0.05 * np.sin(3.0 * tps_rest[:, [1, 2, 0]])).astype(np.float32)
    cfg_d = DeformConfig(model=RBFModelType.KERNEL, kernel=RBFKernel.THIN_PLATE)
    node_d = FaceDeformNode(device=dev)
    tps_in = [Mesh(points=pts, faces=sphere.faces), Mesh(points=tps_rest), Mesh(points=tps_pose)]
    res_d, wall, times = _cook_timed(node_d, tps_in, cfg_d, DeformParams(radius=1.0, lam=0.01), dev)
    show(f"9d TPS at {tps_n}", res_d, wall, times)

    # ---- 9e secondaries
    acc = uv_sphere(200, 200)
    secondary = [Mesh(points=(0.3 * acc.points + np.float32(c)).astype(np.float32),
                      faces=acc.faces) for c in ((0.3, 0.5, 0.7), (-0.3, 0.5, 0.7))]
    res_e, wall, times = _cook_timed(node, [mesh, rest, Mesh(points=last_pose)] + shapes, cfg,
                                     params, dev, secondary=secondary, recompute_normals=True)
    show(f"9e two secondaries of {secondary[0].num_points} verts + recompute_normals", res_e,
         wall, times)
    t_cooks = time.perf_counter() - t_cooks
    launches = _launch_counts(counters, since)
    print(f"node cook: launches {launches}  [{label}]", flush=True)

    # ---- checks (their launches are not counted)
    for name, res in (("cold", res_cold), ("warm", res_warm), ("drag", res_drag),
                      ("psd", res_b), ("pu", res_c2), ("tps", res_d), ("secondary", res_e)):
        _check(res.mesh.points.shape == (v, 3) and bool(np.isfinite(res.mesh.points).all()),
               f"9 {name}: the cook's P is not finite of shape (V, 3)")
        _check(not res.warnings, f"9 {name}: warnings {res.warnings}")
    _check(plan_kept, "the drag cooks did not keep the FitPlan")
    _check(res_warm.weights is not None and res_warm.weights.shape == (n_shapes,),
           "the warm cook did not morph")
    _check(set(res_warm.transported) == {"N", "v", "fd_stretch", "fd_compress"},
           f"the warm cook transported {res_warm.transported}")
    _check(all(s.num_points == secondary[0].num_points and np.isfinite(s.points).all()
               and "N" in s.point_attrs for s in res_e.secondary),
           "the secondaries' outputs are not finite or lack N")
    # a drag cook against a fresh node's cook of the same pose
    fresh = FaceDeformNode(device=dev).cook([mesh, rest, Mesh(points=last_pose)] + shapes,
                                           cfg, params, **kw)
    scale = float(np.abs(fresh.mesh.points - pts).max())
    e_drag = float(np.abs(res_drag.mesh.points.astype(np.float64) - fresh.mesh.points).max())
    print(f"9a last drag cook vs a fresh node's cook of its pose: max |dP| {e_drag:.3e} (tol "
          f"{ORACLE_BUDGET:g} x scale {scale:.3e}; bit for bit: {e_drag == 0.0})", flush=True)
    _check(e_drag <= ORACLE_BUDGET * scale, "a drag cook disagrees with a fresh node's cook")
    # the RBF pass against Deformer.apply on the autotune's backend
    d = node._deformer
    pts_t = torch.as_tensor(pts, device=dev)
    d2 = torch.as_tensor(res_cold.capture.dist2, device=dev)
    want, want_w = d.apply(pts_t, dist2=d2, backend=rbf_backend)
    same = (np.array_equal(rbf_node_res.mesh.points, want.cpu().numpy())
            and np.array_equal(rbf_node_res.mesh.attr("fd_falloff"), want_w.cpu().numpy()))
    print(f"9a the node's RBF pass vs Deformer.apply(backend={rbf_backend!r}): bit for bit "
          f"{same}", flush=True)
    _check(same and (dev.type != "cuda" or rbf_backend in ("cuda", "cuda_culled")),
           "the node's RBF pass differs from Deformer.apply on the autotune's backend")
    # the transported N of the last drag cook against the plain Jacobian
    # route (displacement_jacobian) composed with the same morph map
    idx = torch.linspace(0, v - 1, NODE_SUBSET, device=dev).long()
    nbr, coeff = node._transport_grad_plan(mesh, dev)
    rbf_pts = torch.as_tensor(rbf_node_res.mesh.points, device=dev)
    final = torch.as_tensor(res_drag.mesh.points, device=dev)
    gamma = float(params.falloffradius)
    from facedeform_tpu_torch.ops.jacobian import apply_field_gradient

    g_blend = apply_field_gradient(final - pts_t - gamma * (rbf_pts - pts_t), nbr, coeff)[idx]
    w_sub = torch.as_tensor(res_drag.mesh.attr("fd_falloff"), device=dev)[idx]
    jac = jac_mod.displacement_jacobian(d.model, pts_t[idx], effective_kernel(d.cfg), d.cfg.term)
    eye = torch.eye(3, device=dev)
    f_plain = eye + g_blend + gamma * (jac_mod.deformation_gradient(jac, w_sub) - eye)
    n_plain = jac_mod.transform_normals(torch.as_tensor(normals, device=dev)[idx], f_plain)
    sigma_min = torch.clamp(jac_mod.principal_stretches(f_plain).amin(-1), max=1.0)
    n_node = torch.as_tensor(res_drag.mesh.attr("N"), device=dev)[idx]
    diff = torch.abs(n_node - n_plain).amax(-1)
    t_err = float(torch.max(diff * sigma_min))
    print(f"9a transported N (Jacobian kernel, morph map) vs the plain displacement_jacobian "
          f"route on {NODE_SUBSET} verts: max |d| x min(1, sigma_min) {t_err:.3e} (tol "
          f"{TRANSPORT_TOL:g}), max |d| {float(diff.max()):.3e}", flush=True)
    _check(t_err <= TRANSPORT_TOL, "the node's transported N disagrees with the plain route")
    # a PSD cook at an example pose reproduces its sculpt
    sc = examples[0][1].points
    scale_b = float(np.abs(sc - pts).max())
    e_psd = float(np.abs(res_b_ex.mesh.points.astype(np.float64) - sc).max())
    print(f"9b PSD cook at example pose 0 vs its sculpt: max |dP| {e_psd:.3e} (tol "
          f"{ORACLE_BUDGET:g} x scale {scale_b:.3e}); weights "
          f"{np.round(res_b_ex.mesh.detail_attrs['psd_weights'], 6).tolist()}", flush=True)
    _check(e_psd <= ORACLE_BUDGET * scale_b, "a PSD cook at an example pose misses its sculpt")
    e_small = _node_small_check(dev, label)
    if dev.type == "cuda":
        # where a warm cook's and a drag cook's time goes: device kernel
        # rows and the device's idle share of the wall (after the counters)
        warm_in = [mesh, rest, Mesh(points=last_pose)] + shapes
        _profile(lambda: node.cook(warm_in, cfg, params, **kw), "9a warm cook")
        more = drags(last_pose, 2)
        _profile(lambda: node.cook([mesh, rest, Mesh(points=next(more))] + shapes, cfg, params,
                                   **kw), "9a drag cook")
    wall = time.perf_counter() - t_phase
    print(f"node cook: {wall:.1f} s wall (set-up {t_setup:.1f} s, cooks {t_cooks:.1f} s)  "
          f"[{label}]", flush=True)
    for name, counter in (("#1 dense", "evaluate_cuda"), ("#2 culled", "evaluate_cuda_culled"),
                          ("#5 precise", "evaluate_cuda_precise"), ("#6 jacobian", "jacobian_cuda"),
                          ("#7 PU tiles", "evaluate_pu_tiles")):
        _check(dev.type != "cuda" or launches[counter] > 0,
               f"the node cook did not launch kernel {name}")
    shared = {"sphere": sphere, "markers": markers, "classes": classes, "pose0": pose0,
              "shapes": [s.points for s in shapes], "examples": examples}
    return {"launches": launches, "walls": walls, "drag_ms": drag_ms, "backend": backend,
            "timings": timings, "e_small": e_small, "wall_s": wall, "shared": shared}


EXPORT_POSES = 8
EXPORT_BONES, EXPORT_INFLUENCES = 16, 4
EXPORT_SMOOTH = 0.1
RIGID_TOL = 1e-4          # rigid-cluster recovery, rmse over the bbox diagonal
LBS_TOL = 1e-5            # lbs_apply against float64, of the bbox diagonal
GLB_ROT_TOL = 1e-5        # a reloaded skin's transforms, of max(1, |t|)
GLB_W_TOL = 1e-6          # a reloaded skin's top-4 weights (renormalized in f32)
INVERSE_TOL = 5e-3        # tests/test_inverse.py:72, max |dP| of the refit
INVERSE_SUBSAMPLE = 20_000
INVERSE_GRAD_ITERS = 150
INVERSE_GRAD_GAIN = 0.2   # tests/test_inverse.py:63, error over the start
GRAD_ROUTE_ITERS = 5      # Adam iterates held card against CPU
GRAD_ROUTE_TOL = 1e-5     # tests/test_torch_inverse.py's iterate tolerance
PU_SEQ_N = 20_000


def _same(a, b) -> bool:
    """Bit equality of two tensors (or arrays) of one shape."""
    a, b = (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
            for x in (a, b))
    return a.shape == b.shape and bool(torch.equal(a.cpu(), b.cpu()))


def main_path_export(dev, label: str, shared: dict = None, n_side: int = 1000,
                     pu_n: int = NODE_PU_N, pu_seq_n: int = PU_SEQ_N, tps_n: int = NODE_TPS_N,
                     n_shapes: int = DBSE_SHAPES, grad_iters: int = INVERSE_GRAD_ITERS) -> dict:
    """Phase 10: the rig export and rig tools at phase 9's width (the 1M
    sphere, its 1000 markers in 8 classes, 52 bump shapes; `shared` is
    phase 9's, else they are made by phase 9's recipe).  10a the skinning
    bake: an 8-pose sweep cooked through the node, fit_skinning (16
    bones, 4 influences) with edges, again with smooth_lambda, a
    rigid-cluster sweep and lbs_apply against float64; 10b glTF: the
    skinned bake, the mesh, the 52 shapes as morph targets and the 8
    cooked frames, written and read back; 10c a checkpoint of every kind
    saved and reloaded, the reloads bit-equal through the same kernels
    and a node cook from reloaded files equal to the in-memory one; 10d
    inverse rig fits, the closed form at 1000 markers, the card's
    gradient route against the CPU's and the 2-layer gradient path; 10e
    the doctor; 10f the Houdini adapter on tests/mock_hou.py, a cold and
    a warm cook against a direct cook of the original meshes.
    Launch counters are set to 0 before the phase and read after it (the
    keywords cut the sizes for a rehearsal on the CPU)."""
    import tempfile

    import facedeform_tpu_torch.deformer as deformer_mod
    from facedeform_tpu_torch import (DeformConfig, DeformParams, Deformer, FaceDeformNode, Mesh,
                                      fit_rig, load_mesh, save_mesh)
    from facedeform_tpu_torch.config import RBFKernel, RBFModelType
    from facedeform_tpu_torch.doctor import diagnose
    from facedeform_tpu_torch.geometry import gltf_io
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points, uv_sphere
    from facedeform_tpu_torch.geometry.topology import unique_edges
    from facedeform_tpu_torch.ops import cuda_eval, cuda_jacobian, cuda_precise, cuda_pu, skinning
    from facedeform_tpu_torch.ops.blendshapes import fit_blendshapes
    from facedeform_tpu_torch.ops.psd import PSDDeformer
    from facedeform_tpu_torch.ops.pu import PUDeformer, PUSeqDeformer
    from facedeform_tpu_torch.parallel import batched
    from facedeform_tpu_torch.utils import checkpoint
    from facedeform_tpu_torch.utils.profiling import StageTimes

    counters = (cuda_eval.evaluate_cuda, cuda_eval.evaluate_cuda_culled,
                cuda_eval.control_records, cuda_eval.culled_tables,
                cuda_eval.evaluate_cuda_frames, cuda_eval.frames_stream,
                cuda_eval.evaluate_cuda_diff, cuda_precise.evaluate_cuda_precise,
                cuda_precise.evaluate_cuda_precise_frames, cuda_jacobian.jacobian_cuda,
                cuda_jacobian.jacobian_cuda_frames, cuda_pu.evaluate_pu_tiles,
                cuda_pu.evaluate_pu_tiles_frames,
                cuda_solve.lu_solve_cuda)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(10)
    if shared is None:
        sphere = uv_sphere(n_side, n_side)
        markers = fibonacci_points(CAPTURE_MARKERS)
        classes = _octants(markers)
        shape_pts = _bump_shapes(sphere.points, n_shapes, seed=8)
        ex_poses = [markers + (0.04 * rng.standard_normal(markers.shape)).astype(np.float32)
                    for _ in range(NODE_PSD_EXAMPLES)]
    else:
        sphere, markers, classes = shared["sphere"], shared["markers"], shared["classes"]
        shape_pts = shared["shapes"]
        ex_poses = [p.points for p, _ in shared["examples"]]
    pts, faces = sphere.points, sphere.faces
    v = len(pts)
    bbox = float(np.linalg.norm(pts.max(0) - pts.min(0)))
    pts_t = torch.as_tensor(pts, device=dev)
    poses = [markers + 0.05 * rng.standard_normal(markers.shape).astype(np.float32)
             for _ in range(EXPORT_POSES)]
    mesh = Mesh(points=pts, faces=faces)
    rest_rig = Mesh(points=markers)
    rest_rig.set_attr("class", classes)
    cfg, params = DeformConfig(), DeformParams()
    walls = {}

    def wall(name, fn):
        out, secs = _timed(fn, dev)
        walls[name] = secs
        return out

    def say(msg):
        print(f"10{msg}  [{label}]", flush=True)

    t_setup = time.perf_counter() - t_phase
    since = profiling.counters()
    tmp = tempfile.TemporaryDirectory(prefix="facedeform_export_")
    d = tmp.name
    try:
        # ---- 10a the skinning bake
        bake_node = FaceDeformNode(device=dev)
        frames = wall("10a sweep cooks", lambda: np.stack([
            bake_node.cook([mesh, rest_rig, Mesh(points=p)], cfg, params).mesh.points
            for p in poses]))
        edges = wall("10a unique_edges", lambda: unique_edges(faces))
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        times = StageTimes()
        model, report = wall("10a fit_skinning", lambda: skinning.fit_skinning(
            pts, frames, n_bones=EXPORT_BONES, max_influences=EXPORT_INFLUENCES, edges=edges,
            device=dev, times=times))
        peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
        nnz = int((model.weights > 0).sum(-1).max())
        say(f"a fit_skinning({EXPORT_BONES} bones, {EXPORT_INFLUENCES} influences) of "
            f"{EXPORT_POSES} cooked poses at {v} verts: {walls['10a fit_skinning']:.2f} s "
            f"({times.summary()}); rmse/bbox {report.relative_rmse:.4e}, max_err/bbox "
            f"{report.max_err / bbox:.4e}, max nonzeros a row {nnz} (cap held: "
            f"{nnz <= EXPORT_INFLUENCES}), weight_roughness {report.weight_roughness:.4e}, "
            f"peak device memory {peak:.2f} GiB; sweep cooks {walls['10a sweep cooks']:.2f} s")
        _check(nnz <= EXPORT_INFLUENCES, "the influence cap did not hold")
        _check(np.isfinite(report.rmse) and report.relative_rmse < 0.05,
               f"the bake's rmse/bbox {report.relative_rmse:.3e} is past 5%")
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        times_s = StageTimes()
        model_s, report_s = wall("10a fit_skinning smoothed", lambda: skinning.fit_skinning(
            pts, frames, n_bones=EXPORT_BONES, max_influences=EXPORT_INFLUENCES, edges=edges,
            smooth_lambda=EXPORT_SMOOTH, device=dev, times=times_s))
        peak_s = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
        say(f"a smooth_lambda={EXPORT_SMOOTH} (neighbour table capped at 16): "
            f"{walls['10a fit_skinning smoothed']:.2f} s ({times_s.summary()}); "
            f"weight_roughness {report_s.weight_roughness:.4e} against {report.weight_roughness:.4e} "
            f"unsmoothed, rmse/bbox {report_s.relative_rmse:.4e}, peak {peak_s:.2f} GiB")
        _check(report_s.weight_roughness < report.weight_roughness,
               "smooth_lambda did not lower the weight roughness")
        # two halves under known rigid motions: exact recovery
        left = pts[:, 0] < 0
        rig_frames = []
        for k, ang in enumerate((0.2, 0.5, -0.3)):
            c, s_ = np.cos(ang), np.sin(ang)
            rz = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]], np.float32)
            rx = np.array([[1, 0, 0], [0, c, -s_], [0, s_, c]], np.float32)
            moved = pts @ rx.T + np.float32([0.0, -0.1, 0.05]) * (k + 1)
            moved[left] = pts[left] @ rz.T + np.float32([0.1, 0.3, 0.0]) * ang
            rig_frames.append(moved.astype(np.float32))
        rig_model, rig_report = wall("10a rigid clusters", lambda: skinning.fit_skinning(
            pts, np.stack(rig_frames), n_bones=2, max_influences=2, seed=3, device=dev))
        say(f"a rigid-cluster sweep (two halves, 3 poses): rmse/bbox {rig_report.relative_rmse:.3e} "
            f"(tol {RIGID_TOL:g}), {walls['10a rigid clusters']:.2f} s")
        _check(rig_report.relative_rmse <= RIGID_TOL, "the rigid clusters were not recovered")
        # lbs_apply against a float64 reconstruction on a vertex sample
        idx = np.linspace(0, v - 1, 4096).astype(np.int64)
        w64 = model.weights[idx].double()
        e_lbs = 0.0
        for f in range(EXPORT_POSES):
            got = skinning.lbs_apply(model.weights, model.rest, model.rotations[f],
                                     model.translations[f])[idx]
            y = (torch.einsum("bij,vj->vbi", model.rotations[f].double(), model.rest[idx].double())
                 + model.translations[f].double()[None])
            e_lbs = max(e_lbs, float((got.double() - (w64[:, :, None] * y).sum(1)).abs().max()))
        say(f"a lbs_apply vs float64 on {len(idx)} verts x {EXPORT_POSES} poses: "
            f"{e_lbs / bbox:.3e} of bbox (tol {LBS_TOL:g})")
        _check(e_lbs <= LBS_TOL * bbox, "lbs_apply disagrees with float64")

        # ---- 10b glTF
        def size(name):
            return os.path.getsize(os.path.join(d, name)) / 2**20

        p_skin = os.path.join(d, "skin.glb")
        wall("10b save_glb_skinned", lambda: gltf_io.save_glb_skinned(p_skin, mesh, model))
        skin2, skin_t = wall("10b load_glb_skin",
                             lambda: gltf_io.load_glb_skin(p_skin, device=dev))
        t_scale = max(1.0, float(model.translations.abs().max()))
        e_w = float((skin2.weights - model.weights).abs().max())
        e_r = float((skin2.rotations - model.rotations).abs().max())
        e_t = float((skin2.translations - model.translations).abs().max())
        say(f"b skinned .glb {size('skin.glb'):.1f} MiB: write {walls['10b save_glb_skinned']:.2f} s, "
            f"read {walls['10b load_glb_skin']:.2f} s; weights {e_w:.2e} (tol {GLB_W_TOL:g}), "
            f"rotations {e_r:.2e}, translations {e_t:.2e} (tol {GLB_ROT_TOL:g} x {t_scale:.2f}), "
            f"rest bit-equal {_same(skin2.rest, model.rest)}, {len(skin_t)} keyframes")
        _check(e_w <= GLB_W_TOL and e_r <= GLB_ROT_TOL and e_t <= GLB_ROT_TOL * t_scale
               and _same(skin2.rest, model.rest) and len(skin_t) == EXPORT_POSES,
               "the skinned .glb did not round-trip")
        p_mesh = os.path.join(d, "mesh.glb")
        wall("10b save_mesh .glb", lambda: save_mesh(p_mesh, mesh))
        back = wall("10b load_mesh .glb", lambda: load_mesh(p_mesh))
        ok_mesh = _same(back.points, pts) and _same(back.faces, mesh.triangles())
        say(f"b mesh .glb {size('mesh.glb'):.1f} MiB: write {walls['10b save_mesh .glb']:.2f} s, "
            f"read {walls['10b load_mesh .glb']:.2f} s; points and triangles equal {ok_mesh}")
        _check(ok_mesh, "the mesh .glb did not round-trip")
        targets = np.stack([s - pts for s in shape_pts]).astype(np.float32)
        t_weights = rng.random((EXPORT_POSES, len(targets))).astype(np.float32)
        p_tgt = os.path.join(d, "targets.glb")
        wall("10b save_glb_targets", lambda: gltf_io.save_glb_targets(p_tgt, mesh, targets,
                                                                      t_weights))
        _, shapes_back, _, anim = wall("10b load_glb_blendshapes",
                                       lambda: gltf_io.load_glb_blendshapes(p_tgt))
        ok_tgt = (len(shapes_back) == len(targets) and _same(anim, t_weights)
                  and all(_same(s.points, pts + t) for s, t in zip(shapes_back, targets)))
        say(f"b {len(targets)} morph targets .glb {size('targets.glb'):.1f} MiB: write "
            f"{walls['10b save_glb_targets']:.2f} s, read {walls['10b load_glb_blendshapes']:.2f} s; "
            f"shapes and weight curves equal {ok_tgt}")
        _check(ok_tgt, "the morph-target .glb did not round-trip")
        p_morph = os.path.join(d, "morph.glb")
        wall("10b save_glb_morph", lambda: gltf_io.save_glb_morph(p_morph, mesh, frames))
        say(f"b {EXPORT_POSES}-frame morph .glb {size('morph.glb'):.1f} MiB: write "
            f"{walls['10b save_glb_morph']:.2f} s")

        # ---- 10c checkpoints: a reload evaluates bit for bit as the original
        def roundtrip(name, save, load):
            path = os.path.join(d, name + ".npz")
            wall(f"10c save {name}", lambda: save(path))
            out = wall(f"10c load {name}", lambda: load(path))
            return out, checkpoint.kind(path)

        dense = Deformer.fit(markers, poses[0], cfg, params, device=dev)
        dense2, k_dense = roundtrip("dense", lambda p: checkpoint.save(p, dense),
                                    lambda p: checkpoint.load(p, device=dev))
        same_dense = all(_same(dense.apply(pts_t, backend=b)[0], dense2.apply(pts_t, backend=b)[0])
                         for b in ("cuda", "cuda_culled"))
        tps_rest = fibonacci_points(tps_n)
        tps_pose = (tps_rest + 0.05 * np.sin(3.0 * tps_rest[:, [1, 2, 0]])).astype(np.float32)
        cfg_tps = DeformConfig(model=RBFModelType.KERNEL, kernel=RBFKernel.THIN_PLATE)
        tps = Deformer.fit(tps_rest, tps_pose, cfg_tps, DeformParams(radius=1.0, lam=0.01),
                           device=dev)
        tps2, k_tps = roundtrip("tps", lambda p: checkpoint.save(p, tps),
                                lambda p: checkpoint.load(p, device=dev))
        same_tps = (tps2.model.w_rbf_lo is not None
                    and _same(tps.apply(pts_t)[0], tps2.apply(pts_t)[0]))
        seq_model, resid = batched.fit_frames(markers, np.stack(poses), cfg, params, device=dev)
        (seq2, cfg2, params2, resid2), k_seq = roundtrip(
            "seq", lambda p: checkpoint.save_seq(p, seq_model, cfg, params, resid),
            lambda p: checkpoint.load_seq(p, device=dev))
        zeros, ones = torch.zeros(v, device=dev), torch.ones(v, device=dev)
        same_seq = _same(batched.apply_frames(seq_model, pts_t, zeros, ones, cfg, params)[0],
                         batched.apply_frames(seq2, pts_t, zeros, ones, cfg2, params2)[0])
        pu_rest, pu_frames = _bump_rig(pu_n)
        pud = wall("10c PUDeformer.fit", lambda: PUDeformer.fit(pu_rest, pu_frames[0], device=dev))
        pud2, k_pu = roundtrip("pu", lambda p: checkpoint.save_pu(p, pud),
                               lambda p: checkpoint.load_pu(p, device=dev))
        plan = wall("10c PU plan", lambda: pud.make_plan(pts))
        same_pu = _same(pud.displacement(pts_t, plan=plan), pud2.displacement(pts_t, plan=plan))
        seq_rest, seq_frames = _bump_rig(pu_seq_n, PU_SHOT_CENTERS[:EXPORT_POSES])
        pus = wall("10c PUSeqDeformer.fit",
                   lambda: PUSeqDeformer.fit(seq_rest, seq_frames, device=dev))
        pus2, k_pus = roundtrip("pu_seq", lambda p: checkpoint.save_pu_seq(p, pus),
                                lambda p: checkpoint.load_pu_seq(p, device=dev))
        same_pus = _same(pus.displacement_frames(pts_t), pus2.displacement_frames(pts_t))
        normals = pts / np.linalg.norm(pts, axis=1, keepdims=True)
        corr = np.stack([0.03 * (k + 1) * np.exp(-np.sum((pts - fibonacci_points(16)[3 * k + 1]) ** 2,
                                                         -1) / 0.1)[:, None] * normals
                         for k in range(len(ex_poses))]).astype(np.float32)
        psd = PSDDeformer.fit(markers, np.stack(ex_poses), corr, device=dev)
        psd2, k_psd = roundtrip("psd", lambda p: checkpoint.save_psd(p, psd),
                                lambda p: checkpoint.load_psd(p, device=dev))
        (skin3, rep3), k_skin = roundtrip(
            "skin", lambda p: checkpoint.save_skinning(p, model, report),
            lambda p: checkpoint.load_skinning(p, device=dev))
        same_skin = rep3 == report and all(_same(a, b) for a, b in zip(skin3, model))
        bake, bake_rep = fit_blendshapes(pts, frames, rank=EXPORT_POSES, device=dev)
        (bake2, bake_rep2), k_shapes = roundtrip(
            "shapes", lambda p: checkpoint.save_blendshapes(p, bake, bake_rep),
            lambda p: checkpoint.load_blendshapes(p, device=dev))
        same_shapes = (all(_same(a, b) for a, b in zip(bake, bake2))
                       and bake_rep2.rmse == bake_rep.rmse)
        # the node's cook from the reloaded deformer and PSD files against
        # the in-memory ones (the autotune held to the culled kernel, so
        # the two cooks run one kernel)
        ck_node = FaceDeformNode(device=dev)
        ck_in = [mesh, rest_rig, Mesh(points=ex_poses[0])]
        saved_backends = deformer_mod.AUTOTUNE_BACKENDS
        deformer_mod.AUTOTUNE_BACKENDS = ("cuda_culled",)
        try:
            res_mem = ck_node.cook(ck_in, cfg, params, deformer=dense, psd=psd)
            res_ck = ck_node.cook(ck_in, cfg, params, deformer=dense2, psd=psd2)
        finally:
            deformer_mod.AUTOTUNE_BACKENDS = saved_backends
        same_cook = (_same(res_mem.mesh.points, res_ck.mesh.points)
                     and _same(res_mem.mesh.attr("fd_falloff"), res_ck.mesh.attr("fd_falloff")))
        kinds = {"dense": k_dense, "tps": k_tps, "seq": k_seq, "pu": k_pu, "pu_seq": k_pus,
                 "psd": k_psd, "skin": k_skin, "shapes": k_shapes}
        checks = {"dense #1/#2": same_dense, "tps lo words #5": same_tps, "seq #3": same_seq,
                  "pu #7": same_pu, "pu_seq #7": same_pus, "skin": same_skin,
                  "shapes": same_shapes, "node cook deformer= psd=": same_cook}
        say(f"c checkpoints (walls s): " + ", ".join(
            f"{k[4:]} {w:.2f}" for k, w in walls.items() if k.startswith("10c ")))
        say(f"c reloads bit-equal: {checks}; kind(): {kinds}; PU plan {walls['10c PU plan']:.2f} s")
        _check(all(checks.values()), f"a reloaded checkpoint differs: {checks}")
        _check(kinds == {"dense": "dense", "tps": "dense", "seq": "seq", "pu": "pu",
                         "pu_seq": "pu_seq", "psd": "psd", "skin": "skin", "shapes": "shapes"},
               f"kind() misnamed a file: {kinds}")

        # ---- 10d inverse rig fits
        target = dense.apply(pts_t)[0]
        inv = wall("10d fit_rig closed form", lambda: fit_rig(
            markers, pts_t, target, ridge=1e-8, subsample=INVERSE_SUBSAMPLE, device=dev))
        refit = Deformer.fit(markers, inv.deformed_ctrl, cfg, params, device=dev).apply(pts_t)[0]
        e_inv = float((refit - target).abs().max())
        say(f"d closed form at {CAPTURE_MARKERS} markers, subsample {INVERSE_SUBSAMPLE} of {v}: "
            f"{walls['10d fit_rig closed form']:.3f} s, residual rms {float(inv.residual_rms):.3e}; "
            f"refit max |dP| {e_inv:.3e} (tol {INVERSE_TOL:g})")
        _check(e_inv <= INVERSE_TOL, "the closed-form inverse did not recover the rig")
        g_rest = fibonacci_points(25)
        g_true = g_rest + 0.08 * np.random.default_rng(42).standard_normal((25, 3)).astype(
            np.float32)
        cfg_ml = DeformConfig(model=RBFModelType.MULTILAYER, layers=2)
        params_ml = DeformParams(radius=1.5, lam=0.05)
        g_target = Deformer.fit(g_rest, g_true, cfg_ml, params_ml, device=dev).apply(pts_t)[0]
        # the card's route (falloff x gate and the tangent projection inside
        # #4a's forward) against the CPU route's evaluate x falloff on the
        # same subsample: a nonzero dist2, without and with a tangent
        # frame, the first Adam iterates held to each other
        g_dist2 = (0.3 * np.abs(np.random.default_rng(43).standard_normal(v))).astype(np.float32)
        g_frame = tuple(f.cpu().numpy() for f in _sphere_frame(pts_t))
        g_target_np = g_target.cpu().numpy()
        route_cases = {
            "falloff": (cfg_ml, None),
            "falloff+tangent": (DeformConfig(model=RBFModelType.MULTILAYER, layers=2,
                                             tangent=True), g_frame)}
        route_errs, cold = {}, "10d gradient path first step (cold)"
        for case, (cfg_r, frame_r) in route_cases.items():
            route_errs[case] = 0.0
            for k in range(1, GRAD_ROUTE_ITERS + 1):
                kw = dict(dist2=g_dist2, frame=frame_r, max_iters=k, learning_rate=0.05,
                          ridge=1e-6, subsample=INVERSE_SUBSAMPLE)
                name = cold if cold not in walls else "10d route check, card"
                on_dev = wall(name, lambda: fit_rig(g_rest, pts_t, g_target, cfg_r, params_ml,
                                                    device=dev, **kw))
                on_cpu = fit_rig(g_rest, pts, g_target_np, cfg_r, params_ml, device="cpu", **kw)
                route_errs[case] = max(route_errs[case], float(
                    (on_dev.deformed_ctrl.cpu() - on_cpu.deformed_ctrl).abs().max()))
        say(f"d gradient route, card against CPU (2-layer, 25 markers, subsample "
            f"{INVERSE_SUBSAMPLE}, dist2 = 0.3|N(0,1)|, Adam iterates 1-{GRAD_ROUTE_ITERS}): "
            f"max |d ctrl| {route_errs} (tol {GRAD_ROUTE_TOL:g}); the first card step, cold, "
            f"{walls[cold]:.2f} s")
        _check(all(e <= GRAD_ROUTE_TOL for e in route_errs.values()),
               f"the card's gradient route differs from the CPU route: {route_errs}")
        diff_before = profiling.counters()
        ginv = wall("10d fit_rig gradient path", lambda: fit_rig(
            g_rest, pts_t, g_target, cfg_ml, params_ml, max_iters=grad_iters,
            learning_rate=0.05, ridge=1e-6, subsample=INVERSE_SUBSAMPLE, device=dev))
        diff_launches = _launch_counts((cuda_eval.evaluate_cuda_diff,), diff_before)[
            "evaluate_cuda_diff"]
        g_refit = Deformer.fit(g_rest, ginv.deformed_ctrl, cfg_ml, params_ml,
                               device=dev).apply(pts_t)[0]
        base = float((g_target - pts_t).abs().max())
        e_g = float((g_refit - g_target).abs().max())
        say(f"d gradient path (2-layer, 25 markers, {grad_iters} Adam steps): "
            f"{walls['10d fit_rig gradient path']:.2f} s, evaluate_cuda_diff launches "
            f"{diff_launches}; refit max |dP| {e_g:.3e} against the start {base:.3e} "
            f"({e_g / base:.3f}, tol {INVERSE_GRAD_GAIN:g})")
        _check(e_g < INVERSE_GRAD_GAIN * base, "the gradient path did not converge")
        _check(not on_card or diff_launches >= grad_iters,
               "the gradient path did not run the custom-VJP eval")

        # ---- 10e the doctor
        rep = wall("10e diagnose", lambda: diagnose(
            mesh, rest_rig, [Mesh(points=p) for p in poses], probe_solve=True, device=dev))
        say(f"e diagnose at {v} verts, 8 posed rigs: {walls['10e diagnose']:.2f} s; "
            f"{rep.summary()}: " + "; ".join(f"{f.severity} {f.code}" for f in rep.findings))
        _check(not rep.errors and "solve-ok" in {f.code for f in rep.findings},
               f"the doctor found errors: {rep.findings}")

        # ---- 10f the Houdini adapter on tests/mock_hou.py (loaded by path:
        # another installed package may own the name `tests`)
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "mock_hou", os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                     "mock_hou.py"))
        mock_hou = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mock_hou)
        saved_hou = sys.modules.get("hou")
        sys.modules["hou"] = mock_hou
        try:
            from facedeform_tpu_torch import houdini

            geos = wall("10f hou geometry", lambda: [mock_hou.geometry_from_mesh(m) for m in (
                mesh, rest_rig, Mesh(points=poses[0]))])
            inputs = tuple(mock_hou.SopNode(f"/obj/face/in{i}", g) for i, g in enumerate(geos))
            sop = mock_hou.SopNode("/obj/face/facedeform", parms={
                "dofalloff": 1, "radius": CAPTURE_RADIUS, "maxedges": CAPTURE_MAXEDGES},
                inputs=inputs)
            houdini.clear_state()
            wall("10f cook_sop cold", lambda: houdini.cook_sop(sop, device=dev))
            wall("10f cook_sop warm", lambda: houdini.cook_sop(sop, device=dev))
            state = houdini._NODE_STATE[sop.path()]
            h_cfg, h_params, h_group = houdini.config_from_node(sop)
            # a node of its own cooks the original meshes, not the adapter's
            # conversions of them, held to the backend the adapter's node
            # chose (the autotune may pick either on a close call)
            direct_node = FaceDeformNode(device=dev)
            direct_in = [mesh, rest_rig, Mesh(points=poses[0])]
            saved_backends = deformer_mod.AUTOTUNE_BACKENDS
            if state["node"].last_backend in saved_backends:
                deformer_mod.AUTOTUNE_BACKENDS = (state["node"].last_backend,)
            try:
                _, direct_cold_s, _ = _cook_timed(direct_node, direct_in, h_cfg, h_params, dev,
                                                  group=h_group or None)
                direct, direct_s, direct_times = _cook_timed(direct_node, direct_in, h_cfg,
                                                             h_params, dev, group=h_group or None)
            finally:
                deformer_mod.AUTOTUNE_BACKENDS = saved_backends
            walls["10f direct cold cook"], walls["10f direct warm cook"] = direct_cold_s, direct_s
            out_geo = sop.geometry()
            got = np.asarray(out_geo.pointFloatAttribValues("P"), np.float32).reshape(-1, 3)
            got_fall = np.asarray(out_geo.pointFloatAttribValues("fd_falloff"), np.float32)
            same_h = (_same(got, direct.mesh.points)
                      and _same(got_fall, direct.mesh.attr("fd_falloff")))
            # the adapter's own host steps in a warm cook: the input cache
            # keys' point counts (len(geo.points()), three inputs) and the
            # write-back of P, fd_falloff and rest as float lists
            wall("10f point counts", lambda: [len(g.points()) for g in geos])
            wall("10f write-back", lambda: houdini.write_mesh_to_geometry(
                sop.geometry(), direct.mesh, extra_attrs=direct.transported))
            say(f"f cook_sop at {v} verts: mock geometry build {walls['10f hou geometry']:.2f} s, "
                f"cold {walls['10f cook_sop cold']:.2f} s, warm "
                f"{1e3 * walls['10f cook_sop warm']:.2f} ms against a direct FaceDeformNode.cook "
                f"of the original meshes, cold {direct_cold_s:.2f} s, warm "
                f"{1e3 * direct_s:.2f} ms ({direct_times.summary()}); output P and fd_falloff "
                f"bit-equal {same_h}; backend {state['node'].last_backend!r}; in the "
                f"warm cook: the inputs' len(geo.points()) {walls['10f point counts']:.2f} s, "
                f"the write-back {walls['10f write-back']:.2f} s")
            _check(same_h, "the adapter's output differs from the direct cook's")
        finally:
            houdini.clear_state()
            if saved_hou is None:
                sys.modules.pop("hou", None)
            else:
                sys.modules["hou"] = saved_hou
    finally:
        tmp.cleanup()
    launches = _launch_counts(counters, since)
    wall_s = time.perf_counter() - t_phase
    print(f"export: launches {launches}  [{label}]", flush=True)
    print(f"export: {wall_s:.1f} s wall (set-up {t_setup:.1f} s)  [{label}]", flush=True)
    for name, counter in (("#1 dense", "evaluate_cuda"), ("#2 culled", "evaluate_cuda_culled"),
                          ("#3 frames", "evaluate_cuda_frames"),
                          ("#4 custom-VJP", "evaluate_cuda_diff"),
                          ("#5 precise", "evaluate_cuda_precise"),
                          ("#7 PU tiles", "evaluate_pu_tiles"),
                          ("#7 PU tiles frames", "evaluate_pu_tiles_frames")):
        _check(not on_card or launches[counter] > 0,
               f"the export path did not launch kernel {name}")
    return {"launches": launches, "walls": walls, "wall_s": wall_s}


def time_skin_bases(dev, label: str, n_side: int = 1000) -> dict:
    """fit_skinning at phase 10a's shape (the 1M sphere, 8 poses cooked
    through the node, 16 bones, 4 influences) with one PGD call's
    per-frame bases kept on the device (BASIS_CACHE_BYTES at its default)
    and recomputed on every pass (0), in alternating runs: keep,
    recompute, recompute, keep.  The two must give bit-equal weights."""
    from facedeform_tpu_torch import FaceDeformNode, Mesh
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points, uv_sphere
    from facedeform_tpu_torch.ops import skinning
    from facedeform_tpu_torch.utils.profiling import StageTimes

    sphere = uv_sphere(n_side, n_side)
    markers = fibonacci_points(CAPTURE_MARKERS)
    mesh = Mesh(points=sphere.points, faces=sphere.faces)
    rest_rig = Mesh(points=markers)
    rest_rig.set_attr("class", _octants(markers))
    rng = np.random.default_rng(10)
    node = FaceDeformNode(device=dev)
    frames = np.stack([node.cook([mesh, rest_rig, Mesh(points=markers + 0.05 * rng.standard_normal(
        markers.shape).astype(np.float32))]).mesh.points for _ in range(EXPORT_POSES)])
    default = skinning.BASIS_CACHE_BYTES
    alt, walls, weights = {"keep": [], "recompute": []}, {"keep": [], "recompute": []}, {}
    try:
        for mode in ("keep", "recompute", "recompute", "keep"):
            skinning.BASIS_CACHE_BYTES = default if mode == "keep" else 0
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            times = StageTimes()
            (model, _), secs = _timed(lambda: skinning.fit_skinning(
                sphere.points, frames, n_bones=EXPORT_BONES, max_influences=EXPORT_INFLUENCES,
                device=dev, times=times), dev)
            peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
            alt[mode].append(times.ms["alternation"] / 1e3)
            walls[mode].append(secs)
            weights.setdefault(mode, model.weights)
            print(f"skin-bases {mode}: alternation {alt[mode][-1]:.4f} s, fit_skinning "
                  f"{secs:.4f} s, peak device memory {peak:.2f} GiB  [{label}]", flush=True)
    finally:
        skinning.BASIS_CACHE_BYTES = default
    same = _same(weights["keep"], weights["recompute"])
    print(f"skin-bases at {len(sphere.points)} verts x {EXPORT_BONES} bones x {EXPORT_POSES} "
          f"poses: alternation keep {alt['keep']} s, recompute {alt['recompute']} s "
          f"(recompute / keep {min(alt['recompute']) / min(alt['keep']):.4f} best to best); "
          f"weights bit-equal {same}  [{label}]", flush=True)
    _check(same, "kept and recomputed bases gave different weights")
    return {"alternation": alt, "walls": walls}


# The LU solve kernel (csrc/lu_solve.cu) held by its componentwise
# backward error as a solution of L U x = P^T b, taken in float64, to
# LU_VS_TWIN times the nearer of the plain twin's and torch.linalg.lu_solve's
# plus LU_FLOOR (~17 f32 ulps).  The sides sum in other orders and the kernel
# applies the diagonal blocks' inverses where the others substitute; on the
# TPS rig's ill-conditioned factor that moves the forward error by several
# times between any two of them (printed), while each stays backward stable.
LU_CHECK_NS = (1, 31, 64, 65, 127, 128, 129, 1004, 4100)
LU_VS_TWIN, LU_FLOOR = 4.0, 1e-6


def _lu_errs(lu, perm, b, x) -> tuple[float, float]:
    """(componentwise backward error max_i |L U x - P^T b|_i / (|L| |U| |x| +
    |P^T b|)_i, forward error max |x - x64| / max |x64|), in float64."""
    lu64 = lu.double()
    low = torch.tril(lu64, -1) + torch.eye(lu.shape[0], dtype=torch.float64, device=lu.device)
    up = torch.triu(lu64)
    pb, x_ = b.double()[perm], x.double()
    r = low @ (up @ x_) - pb
    den = torch.abs(low) @ (torch.abs(up) @ torch.abs(x_)) + torch.abs(pb)
    x64 = torch.linalg.solve_triangular(up, torch.linalg.solve_triangular(
        low, pb, upper=False, unitriangular=True), upper=True)
    return (float(torch.max(torch.abs(r) / torch.clamp(den, min=1e-300))),
            float(torch.max(torch.abs(x_ - x64)) / torch.max(torch.abs(x64))))


def _lu_rigs(dev) -> dict:
    """The dense route's factors of the benchmark's two rig sizes: the
    4096-marker TPS saddle system (n = 4100, radius 1, lam 0.01) and the
    default QNN gaussian at 1000 markers (n = 1004), by fit.prepare: each
    layer's solve.LUFactors."""
    from facedeform_tpu_torch import DeformConfig, DeformParams
    from facedeform_tpu_torch.config import RBFKernel, RBFModelType
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points
    from facedeform_tpu_torch.ops import fit

    tps = (DeformConfig(model=RBFModelType.KERNEL, kernel=RBFKernel.THIN_PLATE),
           DeformParams(radius=1.0, lam=0.01), TPS_PLAN_N)
    gauss = (DeformConfig(), DeformParams(), DRAG_N)
    return {name: fit.prepare(torch.as_tensor(fibonacci_points(n), device=dev), cfg, params)
            .layers[0].factors for name, (cfg, params, n) in (("TPS", tps), ("gaussian", gauss))}


def check_lu_solve_kernel(dev) -> dict:
    """The LU solve kernel at k = 1 .. K_MAX, by its backward error beside
    its twin's and torch.linalg.lu_solve's: Gaussian factors (partial
    pivoting swaps most rows) at LU_CHECK_NS, contiguous
    and strided right-hand sides, and the benchmark rigs' factors; every
    launch twice, bit-equal.  Returns the rigs' factors."""
    from facedeform_tpu_torch.ops import solve

    rng = np.random.default_rng(15)
    cases = []
    for n in LU_CHECK_NS:
        a = torch.as_tensor(rng.standard_normal((n, n)), dtype=torch.float32, device=dev)
        f = solve.lu_factor_hp(a)
        cases.append((f"gaussian-matrix {n}", *f))
    rigs = _lu_rigs(dev)
    cases += [(f"{name} rig {f.lu.shape[0]}", *f) for name, f in rigs.items()]
    worst, count = 0.0, 0
    for name, lu, piv, perm, dinv in cases:
        n = lu.shape[0]
        for k in range(1, cuda_solve.K_MAX + 1):
            b = torch.as_tensor(rng.standard_normal((n, 2 * k)), dtype=torch.float32, device=dev)
            for rhs in (b[:, :k].contiguous(), b[:, ::2]):
                x = cuda_solve.lu_solve_cuda(lu, perm, dinv, rhs)
                again = cuda_solve.lu_solve_cuda(lu, perm, dinv, rhs)
                torch.cuda.synchronize()
                _check(torch.equal(x, again), f"lu_solve {name} k={k}: two launches differ")
                e = _lu_errs(lu, perm, rhs, x)
                e_twin = _lu_errs(lu, perm, rhs, cuda_solve.lu_solve_reference(lu, perm, rhs))
                e_lib = _lu_errs(lu, perm, rhs, torch.linalg.lu_solve(lu, piv, rhs))
                lim = LU_VS_TWIN * min(e_twin[0], e_lib[0]) + LU_FLOOR
                _check(e[0] <= lim, f"lu_solve {name} k={k}: backward error {e[0]:.3e} "
                       f"(twin {e_twin[0]:.3e}, library {e_lib[0]:.3e})")
                worst = max(worst, e[0] / lim)
                count += 1
        if n >= 1004:
            print(f"lu_solve {name} k=K_MAX: backward error {e[0]:.3e}, twin {e_twin[0]:.3e}, "
                  f"library {e_lib[0]:.3e}; forward error {e[1]:.3e}, twin {e_twin[1]:.3e}, "
                  f"library {e_lib[1]:.3e}", flush=True)
    print(f"lu_solve kernel: {count} cases (k 1..{cuda_solve.K_MAX}), "
          f"backward errors within {LU_VS_TWIN:g}x the nearer of twin and library + "
          f"{LU_FLOOR:g}, two launches bit-equal; worst at {worst:.3f} of its limit",
          flush=True)
    return rigs


def time_lu_solve(dev, label: str, rigs: dict = None) -> list:
    """The LU solve kernel at the drag's shapes (k = 3 against the TPS
    rig's n = 4100 and the gaussian rig's n = 1004 factors), beside the
    plain twin and torch.linalg.lu_solve (library_ms):
    CUDA-event ms a call, the kernel's device time alone (profiler), and
    its bound, the factor read once at 3.35 TB/s; then one TPS plan refit
    profiled (the device ops of the drag's GMRES-IR)."""
    from facedeform_tpu_torch import Deformer
    from facedeform_tpu_torch.benchmark import stats, time_cuda

    rigs = rigs or _lu_rigs(dev)
    rng = np.random.default_rng(16)
    rows = []
    for name, f in rigs.items():
        n = f.lu.shape[0]
        b = torch.as_tensor(rng.standard_normal((n, 3)), dtype=torch.float32, device=dev)
        fns = {"kernel": lambda: cuda_solve.lu_solve_cuda(f.lu, f.perm, f.dinv, b),
               "plain": lambda: cuda_solve.lu_solve_reference(f.lu, f.perm, b),
               "library": lambda: torch.linalg.lu_solve(f.lu, f.piv, b)}
        times = {k: stats(t) for k, t in time_cuda(fns, rounds=7, iters=20).items()}
        alone = _kernel_alone_ms(fns["kernel"], "lu_solve_kernel")
        # the factor read once, b and x, perm; 2 n^2 k operations
        bound = _bound(4.0 * n * n + 4 * 3 * 2 * n + 8 * n, (2.0 * n * n * 3, PEAK_F32))
        for k, t in times.items():
            print(_fmt(f"lu_solve {k} {name} n={n} k=3", t, f"  [{label}]"))
        print(f"time lu_solve kernel alone (profiler, 20 calls) {name} n={n}: {alone:.4f} ms; "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})  [{label}]", flush=True)
        rows.append({"name": f"lu_solve n={n}", "route": "cuda",
                     "source": "facedeform_tpu_torch/csrc/lu_solve.cu", "replaces": None,
                     "ms": times["kernel"][0], "kernel_alone_ms": alone,
                     "plain_ms": times["plain"][0], **bound,
                     "library_ms": times["library"][0]})
    # one TPS drag refit, profiled: what its device time is made of now
    from facedeform_tpu_torch import DeformConfig, DeformParams
    from facedeform_tpu_torch.config import RBFKernel, RBFModelType
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points

    cfg = DeformConfig(model=RBFModelType.KERNEL, kernel=RBFKernel.THIN_PLATE)
    params = DeformParams(radius=1.0, lam=0.01)
    rest = fibonacci_points(TPS_PLAN_N)
    pose = rest.copy()
    pose[:10] += 0.01 * rng.standard_normal((10, 3)).astype(np.float32)
    _, plan = Deformer.fit_with_plan(rest, pose, cfg, params, device=dev)
    pose[10:20] += 0.01 * rng.standard_normal((10, 3)).astype(np.float32)
    before = profiling.counters()
    _profile(lambda: plan.refit(pose), f"TPS refit {TPS_PLAN_N} [{label}]")
    solves = profiling.counter("fit.lu_solves") - before["fit.lu_solves"]
    launches = profiling.counter("launches.lu_solve_cuda") - before["launches.lu_solve_cuda"]
    print(f"TPS refit: {solves} fit.lu_solves, {launches} lu_solve_cuda launches over the "
          f"warm-up and the profiled call", flush=True)
    return rows


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
    if "--precise-bases" in sys.argv[1:]:
        # the precise kernel's per-basis timing alone
        time_precise_bases(dev, label)
        return 0
    if "--pu-jac" in sys.argv[1:]:
        # the PU and Jacobian kernels' timing alone
        time_pu_jac(dev, label)
        return 0
    if "--eval" in sys.argv[1:]:
        # the dense and culled eval kernels' timing alone
        time_eval(dev, label)
        return 0
    if "--frames" in sys.argv[1:]:
        # the frames eval kernel's timing alone
        time_frames_part(dev, label)
        return 0
    if "--krylov" in sys.argv[1:]:
        # the Krylov parity phase and the large-rig and drag main paths alone
        check_krylov_parity(dev, label)
        main_path_large_rigs(dev, label)
        main_path_drag(dev, label)
        return 0
    if "--capture" in sys.argv[1:]:
        # the capture chain (phase 8) alone
        main_path_capture(dev, label)
        return 0
    if "--node" in sys.argv[1:]:
        # the node's cook (phase 9) alone
        main_path_node(dev, label)
        return 0
    if "--export" in sys.argv[1:]:
        # the rig export and rig tools (phase 10) alone
        main_path_export(dev, label)
        return 0
    if "--skin-bases" in sys.argv[1:]:
        # fit_skinning with its bases kept against recomputed, alone
        time_skin_bases(dev, label)
        return 0
    if "--lu-solve" in sys.argv[1:]:
        # the LU solve kernel's checks and timing alone
        rows = time_lu_solve(dev, label, check_lu_solve_kernel(dev))
        print(json.dumps({"kernels": rows}))
        return 0

    check_kernels(dev)
    check_pack_kernels(dev)
    check_frames_kernel(dev)
    check_jacobian_kernel(dev)
    check_precise_kernel(dev)
    check_precise_frames_kernel(dev)
    check_device_log(dev)
    check_diff_kernel(dev)
    check_pu_kernel(dev)
    lu_rigs = check_lu_solve_kernel(dev)
    main = main_path(dev, label)
    main_b = main_path_frames(dev, label)
    main_c = main_path_precise(dev, label)
    main_f = main_path_pu(dev, label)
    shot_f = main_path_pu_shot(dev, label)
    check_krylov_parity(dev, label)
    large = main_path_large_rigs(dev, label)
    drag = main_path_drag(dev, label)
    torch.cuda.empty_cache()
    chain = main_path_capture(dev, label)
    torch.cuda.empty_cache()
    node = main_path_node(dev, label)
    torch.cuda.empty_cache()
    export = main_path_export(dev, label, shared=node["shared"])
    kernels = (time_kernels(main, label) + time_frames(main_b, label)
               + time_precise(main_c, label) + time_pu(main_f, shot_f, label)
               + time_lu_solve(dev, label, lu_rigs))
    # the kernels the large-rig, drag and capture-chain paths launched, by
    # path (each path's counters set to 0 just before it and read just after)
    paths = {"large rigs": large["launches"],
             **{f"drag {k}": v["launches"] for k, v in drag.items() if "launches" in v},
             "capture chain": chain["launches"], "node cook": node["launches"],
             "export": export["launches"]}
    counter_of = {"eval_dense": "evaluate_cuda", "eval_culled": "evaluate_cuda_culled",
                  "eval_records": "control_records", "culled_tables": "culled_tables",
                  "eval_frames": "evaluate_cuda_frames", "frames_stream": "frames_stream",
                  "eval_precise": "evaluate_cuda_precise",
                  "eval_precise_frames": "evaluate_cuda_precise_frames",
                  "eval_diff": "evaluate_cuda_diff",
                  "jacobian": "jacobian_cuda_frames", "jacobian_single": "jacobian_cuda",
                  "pu_tiles": "evaluate_pu_tiles",
                  "pu_tiles_frames": "evaluate_pu_tiles_frames"}
    for k in kernels:
        counter = "lu_solve_cuda" if k["name"].startswith("lu_solve") else counter_of.get(k["name"])
        if counter:
            k["launches_by_path"] = {p: c[counter] for p, c in paths.items() if c.get(counter)}
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
