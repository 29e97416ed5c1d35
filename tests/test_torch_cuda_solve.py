"""The LU solve of ops/solve.lu_solve: the row permutation stored beside the
factors, the plain twin of the CUDA kernel (ops/cuda_solve.py), the
dispatch rule and the launch counter on the CPU; the kernel itself on the
card (tests marked `card`, skipped without one).

This file imports neither JAX nor the JAX package, so on a machine with a
card it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_solve.py
"""

import types
from pathlib import Path

import numpy as np
import pytest
import torch

from facedeform_tpu_torch.ops import cuda_solve, solve
from facedeform_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "facedeform_tpu_torch" / "csrc" / "lu_solve.cu"


@pytest.fixture
def card():
    """Skip unless torch sees a CUDA card (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda:0")


def _system(n, k, seed, device="cpu"):
    """A pivoting f32 system: a Gaussian matrix (partial pivoting swaps
    most rows) and k right-hand sides."""
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(rng.standard_normal((n, n)), dtype=torch.float32, device=device)
    b = torch.as_tensor(rng.standard_normal((n, k)), dtype=torch.float32, device=device)
    return a, b


def _check_perm(lu, piv, perm, b):
    n = lu.shape[0]
    p, _, _ = torch.lu_unpack(lu, piv)
    assert perm.dtype == torch.int64 and perm.shape == (n,) and perm.device == lu.device
    # (P^T b)[i] = b[perm[i]]: P has its one in row perm[i] of column i
    assert torch.equal(p[perm, torch.arange(n, device=lu.device)], torch.ones_like(perm, dtype=p.dtype))
    assert torch.equal(b[perm], p.T @ b)


# ----------------------------------------------------------------- CPU tests
@pytest.mark.parametrize("n", [1, 2, 5, 64, 65, 1004])
def test_perm_is_lu_unpacks_permutation(n):
    a, b = _system(n, 3, n)
    f = solve.lu_factor_hp(a)
    _check_perm(f.lu, f.piv, cuda_solve.lu_perm(f.piv), b)


def test_batched_factors_carry_no_perm():
    a, _ = _system(6, 1, 0)
    f = solve.lu_factor_hp(a.expand(3, 6, 6))
    assert f.perm is None and f.dinv is None


def test_factors_off_the_card_carry_no_perm():
    """perm and dinv are made only for factors the kernel can take."""
    a, _ = _system(6, 1, 0)
    f = solve.lu_factor_hp(a)
    assert f.perm is None and f.dinv is None


@pytest.mark.parametrize("k", [1, 3, cuda_solve.K_MAX])
@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 1004])
def test_twin_matches_library(n, k):
    a, b = _system(n, k, 100 * n + k)
    f = solve.lu_factor_hp(a)
    want = torch.linalg.lu_solve(f.lu, f.piv, b)
    got = cuda_solve.lu_solve_reference(f.lu, cuda_solve.lu_perm(f.piv), b)
    assert float(torch.max(torch.abs(got - want)) / torch.max(torch.abs(want))) <= 1e-6



def _blocked(lu, perm, dinv, b):
    """The kernel's order, plain: row block by row block, the panel folded
    in, then the stored inverse of the diagonal block applied."""
    n, block = lu.shape[0], dinv.shape[-1]
    nb = dinv.shape[1]
    pad = nb * block
    low = torch.zeros((pad, pad), dtype=lu.dtype)
    up = torch.zeros((pad, pad), dtype=lu.dtype)
    low[:n, :n] = torch.tril(lu, -1)
    up[:n, :n] = torch.triu(lu, 1)
    rhs = torch.zeros((pad, b.shape[1]), dtype=b.dtype)
    rhs[:n] = b[perm]
    y, x = torch.zeros_like(rhs), torch.zeros_like(rhs)
    for i in range(nb):
        rows = slice(i * block, (i + 1) * block)
        y[rows] = dinv[0, i].T @ (rhs[rows] - low[rows] @ y)
    for i in reversed(range(nb)):
        rows = slice(i * block, (i + 1) * block)
        x[rows] = dinv[1, i].T @ (y[rows] - up[rows] @ x)
    return x[:n]


@pytest.mark.parametrize("n", [1, 65, 128, 129, 300])
def test_block_inverses_in_the_kernels_order(n):
    """block_inverses' layout and padding, through a plain emulation of the
    kernel's order: as backward stable as the twin."""
    a, b = _system(n, 3, 11 * n)
    f = solve.lu_factor_hp(a)
    perm = cuda_solve.lu_perm(f.piv)
    dinv, block = cuda_solve.block_inverses(f.lu), cuda_solve.LU_SOLVE_BLOCK
    nb = -(-n // block)
    assert dinv.shape == (2, nb, block, block) and dinv.dtype == torch.float32
    # the identity past n
    m = n - (nb - 1) * block
    eye = torch.eye(block)
    assert torch.equal(dinv[:, -1, m:, m:], eye[m:, m:].expand(2, -1, -1))
    got = _blocked(f.lu, perm, dinv, b)
    err = _backward(f.lu, perm, b, got)
    assert err <= 4 * _backward(f.lu, perm, b, cuda_solve.lu_solve_reference(f.lu, perm, b)) + 1e-6


def _like(device_type, ndim, dtype=torch.float32, k=3, grad=False, dinv=True):
    """Stand-ins for factors and b with the attributes the dispatch rule
    reads; dinv=False is a factor stored without the kernel's inverses."""
    n = 8
    lu = types.SimpleNamespace(is_cuda=device_type == "cuda", ndim=ndim, dtype=dtype,
                               requires_grad=False)
    f = types.SimpleNamespace(lu=lu, dinv=object() if dinv else None)
    b = types.SimpleNamespace(ndim=2, dtype=dtype, shape=(n, k), requires_grad=grad)
    return f, b


def test_route_rule():
    assert cuda_solve.K_MAX >= 3       # the drag's 3-column blocks
    assert cuda_solve.takes(*_like("cuda", 2))
    assert cuda_solve.takes(*_like("cuda", 2, k=1))
    assert cuda_solve.takes(*_like("cuda", 2, k=cuda_solve.K_MAX))
    assert not cuda_solve.takes(*_like("cuda", 2, k=cuda_solve.K_MAX + 1))
    assert not cuda_solve.takes(*_like("cuda", 3))
    assert not cuda_solve.takes(*_like("cuda", 2, dtype=torch.float64))
    assert not cuda_solve.takes(*_like("cpu", 2))
    # the kernel has no backward: a solve autograd differentiates stays on the library
    assert not cuda_solve.takes(*_like("cuda", 2, grad=True))
    with torch.no_grad():
        assert cuda_solve.takes(*_like("cuda", 2, grad=True))
    # factors without the inverses (a batched factor's slice, a caller's
    # LUFactors(lu, piv)) stay on the library
    assert not cuda_solve.takes(*_like("cuda", 2, dinv=False))
    f, _ = _like("cuda", 2)
    assert cuda_solve.takes_factor(f.lu)
    assert not cuda_solve.takes_factor(_like("cuda", 3)[0].lu)
    assert not cuda_solve.takes_factor(_like("cpu", 2)[0].lu)
    a, b = _system(5, 3, 1)
    assert not cuda_solve.takes(solve.lu_factor_hp(a), b)


def _as_if_on_the_card(monkeypatch):
    """Route CPU factors as card factors, the kernel's wrapper replaced by a
    recorder of its calls (its CPU path runs the twin)."""
    calls = []
    wrapper = cuda_solve.lu_solve_cuda
    monkeypatch.setattr(cuda_solve, "takes_factor",
                        lambda lu: lu.ndim == 2 and lu.dtype == torch.float32)

    def record(lu, perm, dinv, b):
        calls.append(tuple(b.shape))
        return wrapper(lu, perm, dinv, b)

    monkeypatch.setattr(cuda_solve, "lu_solve_cuda", record)
    return calls


def test_batched_gmres_ir_solves_keep_the_library(monkeypatch):
    """GMRES-IR over a batch of systems (the partition-of-unity patches at a
    forced eps) solves each against its slice of the batched factors, on
    torch.linalg.lu_solve; one 2-D system takes the kernel."""
    calls = _as_if_on_the_card(monkeypatch)
    rng = np.random.default_rng(4)
    a_hi = torch.as_tensor(rng.standard_normal((2, 12, 12)) + 12 * np.eye(12), dtype=torch.float32)
    a_lo = torch.zeros_like(a_hi)
    b = torch.as_tensor(rng.standard_normal((2, 12, 3)), dtype=torch.float32)
    before = profiling.counter("fit.lu_solves")
    solve.lu_solve_refined_against_df(a_hi, a_lo, b, n_refine=1)
    assert profiling.counter("fit.lu_solves") > before and calls == []
    solve.lu_solve_refined_against_df(a_hi[0], a_lo[0], b[0], n_refine=1)
    assert calls and set(calls) == {(12, 3)}


def test_a_callers_lu_piv_pair_is_converted_once(monkeypatch):
    calls = _as_if_on_the_card(monkeypatch)
    a, b = _system(30, 3, 8)
    a = a + 30 * torch.eye(30)
    lu, piv = torch.linalg.lu_factor(a)
    want = solve.lu_resolve_refined_df(solve.lu_factor_hp(a), a, b)
    n_calls = len(calls)
    got = solve.lu_resolve_refined_df((lu, piv), a, b)
    assert len(calls) == 2 * n_calls == 6          # 1 + n_refine solves each
    assert all(torch.equal(x, y) for x, y in zip(got[0], want[0]))


@pytest.mark.parametrize("k", [1, 3, 7])
def test_cpu_lu_solve_stays_on_the_library(k):
    a, b = _system(40, k, k)
    f = solve.lu_factor_hp(a)
    before = profiling.counters()
    got = solve.lu_solve(f, b)
    assert torch.equal(got, torch.linalg.lu_solve(f.lu, f.piv, b))
    assert profiling.counter("fit.lu_solves") == before["fit.lu_solves"] + 1
    assert profiling.counter("launches.lu_solve_cuda") == before["launches.lu_solve_cuda"]


def test_cpu_wrapper_runs_the_twin():
    a, b = _system(70, 2, 3)
    f = solve.lu_factor_hp(a)
    before = profiling.counter("launches.lu_solve_cuda")
    perm, dinv = cuda_solve.lu_perm(f.piv), cuda_solve.block_inverses(f.lu)
    assert torch.equal(cuda_solve.lu_solve_cuda(f.lu, perm, dinv, b),
                       cuda_solve.lu_solve_reference(f.lu, perm, b))
    assert profiling.counter("launches.lu_solve_cuda") == before


def test_counter_registered_and_constants_match_source():
    assert profiling.counter("launches.lu_solve_cuda") >= 0
    src = CSRC.read_text()
    assert f"constexpr int kLuMaxRhs = {cuda_solve.K_MAX};" in src
    assert f"constexpr int kLuBlock = {cuda_solve.LU_SOLVE_BLOCK};" in src


# ---------------------------------------------------------------- card tests
def _backward(lu, perm, b, x):
    """Componentwise backward error of x as a solution of L U x = P^T b,
    in float64: max_i |L U x - P^T b|_i / (|L| |U| |x| + |P^T b|)_i."""
    lu64 = lu.double()
    low = torch.tril(lu64, -1) + torch.eye(lu.shape[0], dtype=torch.float64, device=lu.device)
    up = torch.triu(lu64)
    pb, x = b.double()[perm], x.double()
    r = low @ (up @ x) - pb
    den = torch.abs(low) @ (torch.abs(up) @ torch.abs(x)) + torch.abs(pb)
    return float(torch.max(torch.abs(r) / torch.clamp(den, min=1e-300)))


def _hold(lu, piv, perm, dinv, b):
    """The kernel's backward error within 4x the nearer of the twin's and
    the library's plus 1e-6 (~17 f32 ulps: the sides sum in other orders,
    and the kernel applies the diagonal blocks' inverses where they
    substitute); and two launches give the same bits."""
    x = cuda_solve.lu_solve_cuda(lu, perm, dinv, b)
    assert torch.equal(x, cuda_solve.lu_solve_cuda(lu, perm, dinv, b))
    errs = {"kernel": _backward(lu, perm, b, x),
            "twin": _backward(lu, perm, b, cuda_solve.lu_solve_reference(lu, perm, b)),
            "library": _backward(lu, perm, b, torch.linalg.lu_solve(lu, piv, b))}
    assert errs["kernel"] <= 4 * min(errs["twin"], errs["library"]) + 1e-6, errs
    return errs


@pytest.mark.card
@pytest.mark.parametrize("k", [1, 2, 3, cuda_solve.K_MAX])
@pytest.mark.parametrize("n", [1, 31, 64, 65, 1004, 4100])
def test_kernel_matches_twin_and_library(card, n, k):
    a, b = _system(n, k, 7 * n + k, card)
    f = solve.lu_factor_hp(a)
    _check_perm(f.lu, f.piv, f.perm, b)
    before = profiling.counter("launches.lu_solve_cuda")
    _hold(f.lu, f.piv, f.perm, f.dinv, b)
    # a strided right-hand side: every other column of a wider tensor
    wide = torch.repeat_interleave(b, 2, dim=1)
    _hold(f.lu, f.piv, f.perm, f.dinv, wide[:, ::2])
    assert profiling.counter("launches.lu_solve_cuda") == before + 4


@pytest.mark.card
def test_differentiable_solves_keep_the_library(card):
    a, b = _system(300, 3, 2, card)
    f = solve.lu_factor_hp(a)
    before = profiling.counter("launches.lu_solve_cuda")
    leaf = b.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(solve.lu_solve(f, leaf).sum(), leaf)
    ref = b.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(torch.linalg.lu_solve(f.lu, f.piv, ref).sum(), ref)
    assert torch.equal(grad, want)
    assert profiling.counter("launches.lu_solve_cuda") == before


def _tps_rig(card):
    from facedeform_tpu_torch import DeformConfig, DeformParams
    from facedeform_tpu_torch.config import RBFKernel, RBFModelType
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points

    cfg = DeformConfig(model=RBFModelType.KERNEL, kernel=RBFKernel.THIN_PLATE)
    return fibonacci_points(4096), cfg, DeformParams(radius=1.0, lam=0.01)


def _gauss_rig(card):
    from facedeform_tpu_torch import DeformConfig, DeformParams
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points

    return fibonacci_points(1000), DeformConfig(), DeformParams()


@pytest.mark.card
def test_kernel_on_tps_factors(card):
    from facedeform_tpu_torch.ops import fit

    rest, cfg, params = _tps_rig(card)
    factors = fit.prepare(torch.as_tensor(rest, device=card), cfg, params)
    f = factors.layers[0].factors
    assert f.lu.shape == (4100, 4100)
    b = torch.as_tensor(np.random.default_rng(5).standard_normal((4100, 3)),
                        dtype=torch.float32, device=card)
    _check_perm(f.lu, f.piv, f.perm, b)
    _hold(*f, b)


def _poses(rest, seed):
    rng = np.random.default_rng(seed)
    pose = rest.copy()
    for _ in range(2):
        pose = pose.copy()
        moved = rng.choice(len(rest), 10, replace=False)
        pose[moved] += 0.01 * rng.standard_normal((10, 3)).astype(np.float32)
        yield pose


@pytest.mark.card
@pytest.mark.parametrize("rig", [_tps_rig, _gauss_rig], ids=["tps4096", "gauss1000"])
def test_refit_equals_fit_bit_for_bit(card, rig):
    from facedeform_tpu_torch import Deformer

    rest, cfg, params = rig(card)
    first, second = _poses(rest, 3)
    _, plan = Deformer.fit_with_plan(rest, first, cfg, params, device=card)
    before = profiling.counter("launches.lu_solve_cuda")
    refit = plan.refit(second)
    fresh = Deformer.fit(rest, second, cfg, params, device=card)
    assert profiling.counter("launches.lu_solve_cuda") > before
    for name in ("ctrl", "w_rbf", "w_poly", "eps", "w_rbf_lo", "w_poly_lo"):
        assert torch.equal(getattr(refit.model, name), getattr(fresh.model, name)), name


@pytest.mark.card
def test_tps_drag_refit_takes_the_kernel_for_every_solve(card):
    from facedeform_tpu_torch import Deformer

    rest, cfg, params = _tps_rig(card)
    first, second = _poses(rest, 4)
    _, plan = Deformer.fit_with_plan(rest, first, cfg, params, device=card)
    torch.cuda.synchronize()
    before = profiling.counters()
    plan.refit(second)
    torch.cuda.synchronize()
    solves = profiling.counter("fit.lu_solves") - before["fit.lu_solves"]
    launches = profiling.counter("launches.lu_solve_cuda") - before["launches.lu_solve_cuda"]
    # 1 first solve + 3 GMRES-IR sweeps x 2 restarts x (16 Arnoldi steps + 1)
    assert (solves, launches) == (103, 103)


@pytest.mark.card
def test_pu_fit_at_a_forced_eps_keeps_the_library(card):
    """fit_pu at a forced eps refines each patch by GMRES-IR against its
    slice of the batched factors: every solve on torch.linalg.lu_solve, as
    before the kernel, and the fit healthy."""
    from facedeform_tpu_torch.config import PolyTerm, RBFKernel
    from facedeform_tpu_torch.geometry.primitives import fibonacci_points
    from facedeform_tpu_torch.ops import pu

    rest = fibonacci_points(600)
    disp = 0.05 * np.sin(3 * rest).astype(np.float32)
    before = profiling.counters()
    _, rep = pu.fit_pu(rest, rest + disp, RBFKernel.THIN_PLATE, PolyTerm.LINEAR, eps=1.0,
                       lam=1e-4, patch_size=128, device=card)
    assert float(rep.backward_error()) < 1e-9
    assert profiling.counter("fit.lu_solves") > before["fit.lu_solves"]
    assert profiling.counter("launches.lu_solve_cuda") == before["launches.lu_solve_cuda"]
