"""Headline measurement of the PyTorch port on a CUDA GPU (counterpart of
facedeform_tpu/benchmark.py, same record keys, plus the 8-frame animated
sequence's per-frame time as a record key, `sequence_ms_per_frame`).

The unit of eval throughput is one phi(|v - c|) evaluation, so a
1M-vertex x 1k-control frame is 1e9 evals.  Device times come from CUDA
events around blocks of launches; each metric reports the best round, the
median and the spread (max - best) / best over the rounds.  Backends are
timed in interleaved rounds so an A/B ratio samples the same windows.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch


def device_label() -> str:
    """The card's name and power limit as nvidia-smi reports them; every
    timing carries it, since a card below its power limit runs slower."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_cuda(fns: dict, rounds: int = 5, iters=10) -> dict:
    """ms per call of each fn, per round: {name: [ms, ...]}.  One warm-up
    call each, then rounds interleaved across the fns.  iters is the calls
    per round, one int or {name: int} (slow plain versions take fewer)."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            n = iters[name] if isinstance(iters, dict) else iters
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / n)
    return times


def stats(ms: list) -> tuple[float, float, float]:
    """(best, median, spread) of per-round times."""
    best = min(ms)
    return best, float(np.median(ms)), (max(ms) - best) / best


def _log(msg: str, label: str) -> None:
    print(f"# {msg}  [{label}]", file=sys.stderr)


def run_headline(n_ctrl: int = 1000, n_verts: int = 1_000_000) -> dict:
    """Solve latency, dense/culled eval throughput against the plain path,
    the localized 4k rig, the capture-gated run and the 8-frame animated
    sequence (batched.deform_frames); commentary goes to stderr, the record
    is returned.  Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark measures a CUDA device and found none")
    from facedeform_tpu_torch.config import DeformConfig, DeformParams
    from facedeform_tpu_torch.deformer import Deformer
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points, uv_sphere
    from facedeform_tpu_torch.ops import fit as fit_mod

    dev = torch.device("cuda")
    label = device_label()
    rng = np.random.default_rng(0)
    rest = fibonacci_points(n_ctrl)
    deformed = rest + 0.05 * rng.standard_normal((n_ctrl, 3)).astype(np.float32)
    cfg = DeformConfig()
    params = DeformParams()

    # --- solve latency ------------------------------------------------------
    rest_dev = torch.as_tensor(rest, device=dev)
    deformed_dev = torch.as_tensor(deformed, device=dev)
    solve = time_cuda({"fit": lambda: fit_mod.fit(rest_dev, deformed_dev, cfg, params)})
    solve_ms, solve_median, solve_spread = stats(solve["fit"])
    _log(f"solve @ {n_ctrl} ctrl pts: {solve_ms:.4f} ms best-of-5 "
         f"(median {solve_median:.4f}, spread {solve_spread * 100:.1f}%)", label)

    # --- eval throughput ----------------------------------------------------
    # the 1M-vertex sphere in its natural (row-major, spatially coherent)
    # vertex order, what the culled kernel's block bboxes see in practice
    d = Deformer.fit(rest, deformed, cfg, params, device=dev)
    res = max(int(np.sqrt(max(n_verts - 2, 4))), 2)
    mesh = uv_sphere(res, res)
    n_verts = mesh.num_points
    pts = torch.as_tensor(mesh.points, device=dev)
    dist2 = torch.zeros(n_verts, device=dev)

    def apply_with(deformer, backend, d2=dist2):
        return lambda: deformer.apply(pts, dist2=d2, backend=backend)

    backends = ("cuda", "cuda_culled", "dense")
    rounds = time_cuda({b: apply_with(d, b) for b in backends})
    best = {b: stats(rounds[b]) for b in backends}
    dense_ms, dense_median, dense_spread = best["cuda"]
    culled_ms = best["cuda_culled"][0]
    plain_ms = best["dense"][0]
    evals = n_verts * n_ctrl
    ref = d.apply(pts[:4096], backend="cuda")[0]
    got = d.apply(pts[:4096], backend="cuda_culled")[0]
    err = float(torch.max(torch.abs(ref - got)))
    for b, (b_ms, b_med, b_spread) in best.items():
        _log(f"eval {b}: {b_ms:.4f} ms/frame (median {b_med:.4f}, spread "
             f"{b_spread * 100:.1f}%), {evals / b_ms / 1e6:.2f} Gevals/s "
             f"[{n_verts} verts x {n_ctrl} ctrl global rig]", label)
    _log(f"culled vs dense kernel: {dense_ms / culled_ms:.3f}x, max |err| {err:.3e}",
         label)

    # --- localized rig: 4096 controls in a cap, the production face case ----
    n_loc = 4096
    cap = fibonacci_points(n_loc) * 0.15 + np.float32([0, 0.98, 0])
    cap_def = cap + 0.01 * rng.standard_normal((n_loc, 3)).astype(np.float32)
    d_loc = Deformer.fit(cap, cap_def, cfg, params, device=dev)
    loc_rounds = time_cuda({b: apply_with(d_loc, b) for b in ("cuda", "cuda_culled")})
    loc_dense_ms = stats(loc_rounds["cuda"])[0]
    loc_culled_ms = stats(loc_rounds["cuda_culled"])[0]
    _log(f"localized 4k rig: dense {loc_dense_ms:.4f} ms, culled "
         f"{loc_culled_ms:.4f} ms ({loc_dense_ms / loc_culled_ms:.3f}x)", label)

    # --- capture-gated: only the region near the rig's top is active --------
    cap_d2 = torch.sum((pts - torch.tensor([0.0, 1.0, 0.0], device=dev)) ** 2, dim=-1)
    gated = time_cuda({"gated": apply_with(d, "cuda", cap_d2)})
    gated_ms = stats(gated["gated"])[0]
    frac = float(torch.mean((cap_d2 <= 1.0).float()))
    _log(f"capture-gated ({frac * 100:.1f}% active): {gated_ms:.4f} ms/frame "
         f"({dense_ms / gated_ms:.3f}x all-active)", label)

    # --- animated sequence: 8 poses, batched fit + all-frames eval --------
    from facedeform_tpu_torch.parallel import batched

    n_frames = 8
    frames = np.stack([
        rest + 0.05 * rng.standard_normal((n_ctrl, 3)).astype(np.float32)
        for _ in range(n_frames)
    ])
    frames_dev = torch.as_tensor(frames, device=dev)
    gate = torch.ones(n_verts, device=dev)
    seq = time_cuda({"seq": lambda: batched.deform_frames(
        rest_dev, frames_dev, pts, dist2, gate, cfg, params, device=dev)})
    seq_ms, seq_median, seq_spread = stats(seq["seq"])
    _log(f"animated sequence ({n_frames} frames, fit + eval): "
         f"{seq_ms / n_frames:.4f} ms/frame (median {seq_median / n_frames:.4f}, "
         f"spread {seq_spread * 100:.1f}%)", label)

    dense_rate = evals / (dense_ms * 1e-3)
    return {
        "metric": "vertex_kernel_evals_per_sec_1Mv_1kc",
        "value": dense_rate,
        "unit": "evals/s",
        "vs_baseline": dense_rate / 1e9,
        "device": label,
        "dense_gevals_per_sec": dense_rate / 1e9,
        "dense_ms_median": dense_median,
        "dense_spread": dense_spread,
        "solve_ms_best": solve_ms,
        "solve_ms_median": solve_median,
        "solve_spread": solve_spread,
        "culled_gevals_per_sec": evals / (culled_ms * 1e-3) / 1e9,
        "culled_max_abs_err": err,
        "plain_dense_ms": plain_ms,
        "plain_gevals_per_sec": evals / (plain_ms * 1e-3) / 1e9,
        "localized_dense_gevals_per_sec": n_verts * n_loc / (loc_dense_ms * 1e-3) / 1e9,
        "localized_culled_gevals_per_sec": n_verts * n_loc / (loc_culled_ms * 1e-3) / 1e9,
        "localized_culled_speedup": loc_dense_ms / loc_culled_ms,
        "capture_gated_ms_per_frame": gated_ms,
        "capture_gated_active_fraction": frac,
        "capture_gated_speedup": dense_ms / gated_ms,
        "sequence_ms_per_frame": seq_ms / n_frames,
        "sequence_ms_per_frame_median": seq_median / n_frames,
        "sequence_spread": seq_spread,
    }


if __name__ == "__main__":
    import json

    print(json.dumps(run_headline()))
