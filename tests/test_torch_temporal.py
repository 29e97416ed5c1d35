"""PyTorch port: temporal rig smoothing against the JAX package's.  Both
are the same float64 numpy, so they agree bit for bit."""

import numpy as np
import pytest

from facedeform_tpu.ops import temporal as jtemporal
from facedeform_tpu_torch.ops import temporal as ttemporal


@pytest.mark.parametrize("n_frames,window,order", [
    (1, 5, 2), (2, 5, 2), (4, 5, 2), (5, 5, 2), (8, 5, 2), (12, 7, 3), (9, 3, 1), (6, 9, 2),
])
def test_smoothing_matrix_bit_for_bit(n_frames, window, order):
    got = ttemporal.smoothing_matrix(n_frames, window=window, order=order)
    want = jtemporal.smoothing_matrix(n_frames, window=window, order=order)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_frames", [1, 3, 8, 17])
def test_smooth_frames_bit_for_bit(n_frames):
    rng = np.random.default_rng(n_frames)
    frames = rng.standard_normal((n_frames, 50, 3)).astype(np.float32)
    got = ttemporal.smooth_frames(frames, window=5)
    want = jtemporal.smooth_frames(frames, window=5)
    assert got.dtype == np.float32 and got.shape == frames.shape
    np.testing.assert_array_equal(got, want)


def test_polynomial_trajectories_pass_through():
    """Savitzky-Golay reproduces any trajectory of degree <= order, edges
    included."""
    t = np.arange(10, dtype=np.float64)[:, None, None]
    rng = np.random.default_rng(0)
    c = rng.standard_normal((3, 1, 20, 3))
    frames = (c[0] + c[1] * t + c[2] * t * t).astype(np.float32)
    np.testing.assert_allclose(ttemporal.smooth_frames(frames, window=5, order=2),
                               frames, atol=2e-5)


@pytest.mark.parametrize("kwargs,shape", [
    (dict(window=4), (5, 10, 3)), (dict(order=0), (5, 10, 3)), ({}, (5, 10)),
])
def test_errors_match(kwargs, shape):
    frames = np.zeros(shape, np.float32)
    with pytest.raises(ValueError) as want:
        jtemporal.smooth_frames(frames, **kwargs)
    with pytest.raises(ValueError) as got:
        ttemporal.smooth_frames(frames, **kwargs)
    assert str(got.value) == str(want.value)
