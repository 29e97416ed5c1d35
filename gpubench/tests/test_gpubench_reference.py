"""The plain reference against closed forms, at test sizes, on the CPU."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from gpubench import inputs
from gpubench import reference as ref
from gpubench.reference.capture import captured_mask
from gpubench.reference.prec import mm, round_tf32

from .conftest import ROOT

QNN = {"model": "QNN", "kernel": "GAUSSIAN", "term": "LINEAR"}
TPS = {"model": "KERNEL", "kernel": "THIN_PLATE", "term": "LINEAR"}
PARAMS = {"qcoef": 1.0, "zcoef": 5.0, "radius": 1.0, "lam": 0.01, "falloffrate": 1.0,
          "falloffradius": 1.0, "weight_lo": 0.0, "weight_hi": 1.0, "maxedges": 4}


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      1.0 + 2.0 ** -12, -3.0, 0.0])
    got = round_tf32(x)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -9, 1.0, -3.0, 0.0])
    assert torch.equal(got, want)   # ties to even: 1 + 2^-11 -> 1, 1 + 3 2^-11 -> 1 + 2^-9


def test_mm_tf32_error_is_tf32_sized():
    g = torch.Generator().manual_seed(0)
    a, b = torch.rand(64, 256, generator=g), torch.rand(256, 8, generator=g)
    exact = a.double() @ b.double()
    err32 = float(((a @ b).double() - exact).abs().max() / exact.abs().max())
    err_tf = float((mm(a, b, True).double() - exact).abs().max() / exact.abs().max())
    assert err32 < 1e-6 < err_tf < 2e-3


def _path_mesh(n):
    """n points on a line joined by degenerate quads (i, i+1, i+1, i+1)."""
    pts = torch.stack([torch.arange(n, dtype=torch.float64), torch.zeros(n), torch.zeros(n)], 1)
    i = torch.arange(n - 1)
    faces = torch.stack([i, i + 1, i + 1, i + 1], 1)
    return pts, faces


def test_capture_floods_max_edges_hops():
    pts, faces = _path_mesh(20)
    rest = torch.tensor([[5.2, 0.0, 0.0], [15.9, 0.0, 0.0]])     # seeds 5 and 16
    mask = captured_mask(pts, faces, rest, 2)
    want = torch.zeros(20, dtype=torch.bool)
    want[3:8] = True
    want[14:19] = True
    assert torch.equal(mask, want)
    d2 = ref.capture_dist2(pts, faces, rest, 2, ref.JUDGE)
    assert float(d2[4]) == pytest.approx(1.2 ** 2)
    assert float(d2[0]) == 0.0                               # uncaptured keeps 0


def test_falloff_closed_form():
    d2 = torch.tensor([-1.0, 0.0, 0.25, 1.0, 2.0], dtype=torch.float64)
    w = ref.falloff(d2, 1.0, 2.0, ref.JUDGE)
    assert torch.allclose(w, torch.tensor([1.0, 1.0, 0.5625, 0.0, 0.0], dtype=torch.float64))


@pytest.mark.parametrize("cfg", [QNN, TPS], ids=["qnn", "tps"])
def test_fit_reproduces_an_affine_pose_by_its_tail(cfg):
    rest = torch.as_tensor(inputs.fibonacci_points(60))
    a = torch.tensor([[1.1, 0.1, 0.0], [0.0, 0.9, 0.2], [0.05, 0.0, 1.0]])
    pose = rest @ a.T + torch.tensor([0.1, -0.2, 0.3])
    model = ref.fit(rest, pose, cfg, PARAMS, ref.JUDGE)
    # the tail block's -1e-8 I leaves weights of about 1e-8 times the system's conditioning
    assert float(model.w.abs().max()) < 1e-5
    x = torch.as_tensor(inputs.uv_sphere(10, 10)[0]).double()
    disp = ref.evaluate([model], x, ref.JUDGE)[0]
    want = x @ a.T.double() + torch.tensor([0.1, -0.2, 0.3], dtype=torch.float64) - x
    assert float((disp - want).abs().max()) < 1e-6


def test_qnn_fit_interpolates_its_markers():
    rest = torch.as_tensor(inputs.fibonacci_points(50))
    g = np.random.default_rng(0)
    pose = rest + torch.as_tensor(0.05 * g.standard_normal((50, 3)), dtype=torch.float32)
    model = ref.fit(rest, pose, QNN, PARAMS, ref.JUDGE)
    disp = ref.evaluate([model], rest.double(), ref.JUDGE)[0]
    assert float((disp - (pose - rest).double()).abs().max()) < 1e-6


def test_normals_through_an_affine_map():
    """A pure tail model's F is the constant I + w A: n' ~ F^-T n."""
    rest = torch.as_tensor(inputs.fibonacci_points(30))
    a = torch.tensor([[0.3, 0.1, 0.0], [0.0, -0.2, 0.4], [0.1, 0.0, 0.1]])
    model = ref.fit(rest, rest + rest @ a.T, QNN, PARAMS, ref.JUDGE)
    x = torch.as_tensor(inputs.uv_sphere(8, 8)[0]).double()
    n = x / x.norm(dim=1, keepdim=True)
    w = torch.full((x.shape[0],), 0.5, dtype=torch.float64)
    got = ref.transport_normals([model], x, n, w, ref.JUDGE)[0]
    f = torch.eye(3, dtype=torch.float64) + 0.5 * a.double()
    want = n @ torch.linalg.inv(f)
    want = want / want.norm(dim=1, keepdim=True)
    assert float((got - want).abs().max()) < 1e-6


def test_dbse_weights_of_orthogonal_shapes():
    rest = torch.zeros(4, 3, dtype=torch.float64)
    shapes = [rest.clone() for _ in range(2)]
    shapes[0][0, 0] = 2.0
    shapes[1][1, 1] = 1.0
    blend = ref.Blendshapes([s.numpy() for s in shapes], rest, ref.JUDGE, ridge=0.0)
    p = rest.clone()
    p[0, 0], p[1, 1], p[2, 2] = 1.0, 3.0, 5.0
    w = blend.weights(p)
    assert torch.allclose(w, torch.tensor([0.5, 3.0], dtype=torch.float64))
    out = blend.morph(p, w, dofalloff=True, falloffradius=0.5)
    want = 0.5 * p
    want[0, 0] += 1.0
    want[1, 1] += 3.0
    assert torch.allclose(out, want)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, gpubench.reference, gpubench.compare, gpubench.inputs, "
            "gpubench.peaks, gpubench.catalog, gpubench.device\n"
            "names = {m.split('.')[0] for m in sys.modules}\n"
            "bad = names & {'facedeform_tpu_torch', 'facedeform_tpu', 'jax', 'jaxlib', 'flax'}\n"
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.card
def test_control_emulation_matches_the_cards_tf32(card):
    """On the card, the reference's emulated TF32 contraction reads within
    float32 accumulation noise of cuBLAS's own TF32 product."""
    g = torch.Generator(device=card).manual_seed(0)
    a = torch.rand(512, 1024, generator=g, device=card)
    b = torch.rand(1024, 48, generator=g, device=card)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        native = a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    emulated = mm(a, b, True)
    exact = a.double() @ b.double()
    rel = float((native.double() - emulated.double()).abs().max() / exact.abs().max())
    tf32_err = float((emulated.double() - exact).abs().max() / exact.abs().max())
    assert rel < 0.25 * tf32_err
