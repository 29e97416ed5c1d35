"""Temporal rig smoothing: denoise tracked-marker jitter across a shot.

A copy of facedeform_tpu/ops/temporal.py, which is numpy only: importing
it from there would import the JAX package (its __init__ imports jax).

Tracked control rigs (optical mocap, landmark trackers) carry
frame-to-frame noise; per-frame RBF fits interpolate every jittered pose
faithfully, so the noise lands on the deformed mesh as a shimmer.  The
reference has no sequence concept at all (it re-cooks per frame,
src/SOP_FaceDeform.cpp:216-489); this module is the input-side cure: a
Savitzky-Golay filter over the frame axis of the (F, N, 3) posed-rig
stack, applied BEFORE the sequence fit.

Why Savitzky-Golay rather than a box/Gaussian: the filter is the
least-squares projection onto degree-`order` polynomials in a sliding
window, so any marker trajectory that IS locally polynomial — constant
pose, linear travel, a quadratic motion arc — passes through EXACTLY
(no amplitude loss, no phase lag at extremes of motion, which is what
artists notice first with naive blurs), while white tracker noise is
attenuated by roughly sqrt(window) in rms.

The whole filter is one precomputed (F, F) banded matrix applied by a
single einsum, so it is O(F^2 N) host work on a tiny array (rigs are
KBs), works identically for every solver route (dense, Krylov, PU — it
never touches the solve), and the edge rows evaluate the SAME
least-squares polynomial at the boundary frames instead of shrinking or
mirroring the window, preserving the polynomial-reproduction property at
the shot's first/last frames too.
"""

from __future__ import annotations

import numpy as np

__all__ = ["smoothing_matrix", "smooth_frames"]


def smoothing_matrix(n_frames: int, window: int = 5, order: int = 2) -> np.ndarray:
    """(F, F) Savitzky-Golay smoothing operator over the frame axis.

    Row f holds the weights producing the filtered value at frame f:
    interior rows are the classic centered SG kernel; rows within half a
    window of either end evaluate the window's least-squares polynomial
    at their off-center position (scipy's mode='interp' semantics,
    derived here from the Vandermonde pseudo-inverse directly so the
    package keeps zero scipy.signal dependency).

    Constraints: window odd, 1 <= order < window.  window > n_frames is
    clamped down (to the largest odd size that fits) rather than raised
    so short shots degrade gracefully; a 1-frame "shot" returns identity.
    """
    if window % 2 == 0:
        raise ValueError(f"window must be odd, got {window}")
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    f_n = int(n_frames)
    if f_n < 1:
        raise ValueError("need at least one frame")
    window = min(window, f_n if f_n % 2 else f_n - 1)
    if window <= order:
        # not enough support to both fit and smooth — identity (exact)
        return np.eye(f_n, dtype=np.float64)

    half = window // 2
    # least-squares polynomial fit over offsets t = -half..half:
    # coeffs = pinv(V) y with V[t, k] = t^k; the smoothed value at offset
    # t0 is the fitted polynomial evaluated there: row(t0) = [t0^k] pinv(V)
    t = np.arange(-half, half + 1, dtype=np.float64)
    v = np.vander(t, order + 1, increasing=True)        # (window, order+1)
    pinv = np.linalg.pinv(v)                            # (order+1, window)

    s = np.zeros((f_n, f_n), dtype=np.float64)
    for f in range(f_n):
        lo = min(max(f - half, 0), f_n - window)
        t0 = float(f - (lo + half))                     # offset within window
        row = np.array([t0 ** k for k in range(order + 1)]) @ pinv
        s[f, lo:lo + window] = row
    return s


def smooth_frames(frames, window: int = 5, order: int = 2) -> np.ndarray:
    """Savitzky-Golay-filter an (F, N, 3) posed-rig stack along frames.

    Returns float32 (F, N, 3); F < 2 or a window clamped to <= order pass
    through unchanged (identity).  Feed the result to
    parallel.batched.fit_frames / ops.pu.fit_pu_frames / per-frame cooks
    interchangeably — the filter is solver-agnostic.
    """
    frames = np.asarray(frames, np.float32)
    if frames.ndim != 3 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (F, N, 3), got {frames.shape}")
    f_n = frames.shape[0]
    if f_n < 2:
        return frames
    s = smoothing_matrix(f_n, window=window, order=order)
    return np.einsum("fg,gnd->fnd", s, frames.astype(np.float64)).astype(
        np.float32
    )
