"""PyTorch port: evaluate_cuda_diff, the dense eval kernel with gradients,
against the JAX package's evaluate_pallas_diff (Pallas in interpret mode)
and autograd through the plain twin."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
import facedeform_tpu.deformer as jdef
from facedeform_tpu.geometry.primitives import fibonacci_points
from facedeform_tpu.ops import pallas_eval
from facedeform_tpu_torch import convert
from facedeform_tpu_torch.ops import cuda_eval
from facedeform_tpu_torch.ops.fit import RBFModel, effective_kernel
from facedeform_tpu_torch.utils import profiling

K = jcfg.RBFKernel
M = jcfg.RBFModelType
GRAD_TOL = 1e-4    # tests/test_pallas_vjp.py's rtol = atol

CASES = [
    ("qnn", jcfg.DeformConfig(), jcfg.DeformParams()),
    ("tps", jcfg.DeformConfig(model=M.KERNEL, kernel=K.THIN_PLATE),
     jcfg.DeformParams(radius=1.0, lam=0.01)),
]


def _setup(cfg, params, seed=42):
    rng = np.random.default_rng(seed)
    rest = fibonacci_points(20)
    deformed = rest + 0.1 * rng.standard_normal((20, 3)).astype(np.float32)
    d = jdef.Deformer.fit(rest, deformed, cfg, params)
    pts = rng.standard_normal((64, 3)).astype(np.float32)
    dist2 = (0.5 * rng.uniform(size=64)).astype(np.float32)       # all active at r = 2
    gate = rng.uniform(0.5, 1.0, 64).astype(np.float32)
    frame = tuple(rng.standard_normal((64, 3)).astype(np.float32) for _ in range(3))
    return d, pts, dist2, gate, frame


def _interpret(monkeypatch):
    orig = pallas_eval.evaluate_pallas

    def interp(*args, **kw):
        kw.setdefault("interpret", True)
        kw.setdefault("tile_v", 64)
        return orig(*args, **kw)

    monkeypatch.setattr(pallas_eval, "evaluate_pallas", interp)


@pytest.mark.parametrize("name,cfg,params", CASES, ids=[c[0] for c in CASES])
def test_diff_grads_match_jax(name, cfg, params, monkeypatch):
    """d sum(out^2) / d(w_rbf, points), as tests/test_pallas_vjp.py takes it."""
    _interpret(monkeypatch)
    d, pts, *_ = _setup(cfg, params)
    kernel = effective_kernel(cfg)
    v = pts.shape[0]

    def jloss(w_rbf, p):
        out, _ = pallas_eval.evaluate_pallas_diff(
            d.model._replace(w_rbf=w_rbf), p, jnp.zeros(v), jnp.ones(v), jnp.float32(2.0),
            jnp.float32(1.0), None, kernel, cfg.term, False)
        return jnp.sum(out ** 2)

    want = jax.grad(jloss, argnums=(0, 1))(d.model.w_rbf, jnp.asarray(pts))
    model = convert.model_from_numpy({f: np.asarray(getattr(d.model, f))
                                      for f in d.model._fields}, device="cpu")
    w = model.w_rbf.clone().requires_grad_()
    p = torch.as_tensor(pts).requires_grad_()
    out, _ = cuda_eval.evaluate_cuda_diff(
        RBFModel(ctrl=model.ctrl, w_rbf=w, w_poly=model.w_poly, eps=model.eps), p,
        torch.zeros(v), torch.ones(v), 2.0, 1.0, None, kernel, cfg.term)
    got = torch.autograd.grad(torch.sum(out ** 2), (w, p))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL, atol=GRAD_TOL)
    assert profiling.counter("launches.evaluate_cuda_diff") == 0


@pytest.mark.parametrize("name,cfg,params", CASES, ids=[c[0] for c in CASES])
def test_diff_all_input_grads_match_jax(name, cfg, params, monkeypatch):
    """Every differentiable input at once, with capture distances, a soft
    gate, radius and rate as tensors, a tangent frame and a loss that
    reads the falloff too."""
    _interpret(monkeypatch)
    d, pts, dist2, gate, frame = _setup(cfg, params, seed=7)
    kernel = effective_kernel(cfg)

    def jloss(model, p, d2, g, r, rate, fr):
        out, w = pallas_eval.evaluate_pallas_diff(model, p, d2, g, r, rate, fr, kernel,
                                                  cfg.term, False)
        return jnp.sum(out ** 2) + jnp.sum(w ** 2)

    jargs = (d.model, jnp.asarray(pts), jnp.asarray(dist2), jnp.asarray(gate),
             jnp.float32(2.0), jnp.float32(1.5), tuple(map(jnp.asarray, frame)))
    want = jax.grad(jloss, argnums=tuple(range(7)))(*jargs)

    model = convert.model_from_numpy({f: np.asarray(getattr(d.model, f))
                                      for f in ("ctrl", "w_rbf", "w_poly", "eps")}, device="cpu")
    leaves = [t.clone().requires_grad_() for t in
              (model.ctrl, model.w_rbf, model.w_poly, model.eps)]
    ins = [torch.as_tensor(a).requires_grad_() for a in (pts, dist2, gate)]
    r, rate = torch.tensor(2.0, requires_grad=True), torch.tensor(1.5, requires_grad=True)
    fr = tuple(torch.as_tensor(f).requires_grad_() for f in frame)
    out, w = cuda_eval.evaluate_cuda_diff(RBFModel(*leaves), *ins, r, rate, fr, kernel,
                                          cfg.term)
    got = torch.autograd.grad(torch.sum(out ** 2) + torch.sum(w ** 2),
                              (*leaves, *ins, r, rate, *fr))
    jm = want[0]
    expect = [jm.ctrl, jm.w_rbf, jm.w_poly, jm.eps, *want[1:6], *want[6]]
    names = ["ctrl", "w_rbf", "w_poly", "eps", "points", "dist2", "gate", "radius",
             "falloffrate", "u", "v", "n"]
    for name_, a, b in zip(names, got, expect):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name_)


@pytest.mark.parametrize("name,cfg,params", CASES, ids=[c[0] for c in CASES])
def test_diff_forward_and_plain_grads(name, cfg, params):
    """On CPU tensors the forward is the plain twin's output, and the
    gradients are autograd's through that twin, bit for bit."""
    d, pts, dist2, gate, frame = _setup(cfg, params, seed=3)
    kernel = effective_kernel(cfg)
    model = convert.model_from_numpy({f: np.asarray(getattr(d.model, f))
                                      for f in ("ctrl", "w_rbf", "w_poly", "eps")}, device="cpu")
    args = (torch.as_tensor(pts), torch.as_tensor(dist2), torch.as_tensor(gate), 2.0, 1.5)
    fr = tuple(map(torch.as_tensor, frame))
    got = cuda_eval.evaluate_cuda_diff(model, *args, fr, kernel, cfg.term, True)
    want = cuda_eval.evaluate_reference(model, *args, kernel, cfg.term, True, fr)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    def grads(fn):
        w = model.w_rbf.clone().requires_grad_()
        p = args[0].clone().requires_grad_()
        m = RBFModel(ctrl=model.ctrl, w_rbf=w, w_poly=model.w_poly, eps=model.eps)
        out, _ = fn(m, p, *args[1:], fr)
        return torch.autograd.grad(torch.sum(out ** 2), (w, p))

    g_diff = grads(lambda m, p, d2, g, r, rate, f: cuda_eval.evaluate_cuda_diff(
        m, p, d2, g, r, rate, f, kernel, cfg.term, True))
    g_plain = grads(lambda m, p, d2, g, r, rate, f: cuda_eval.evaluate_reference(
        m, p, d2, g, r, rate, kernel, cfg.term, True, f))
    assert all(torch.equal(a, b) for a, b in zip(g_diff, g_plain))
    assert profiling.counter("launches.evaluate_cuda_diff") == 0 and cuda_eval._lib is None
