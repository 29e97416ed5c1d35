"""PyTorch port: the matrix-free Krylov route (ops/krylov.py and the
routing of ops/fit.fit) against the JAX package's facedeform_tpu.ops.krylov
on the same seeded inputs, at the sizes of tests/test_krylov.py.

Iteration counts are compared by counting matvec calls: on the JAX side a
jax.debug.callback inside the matvec runs once per executed application,
inside the while loops too.  They are compared at tol = 1e-6 (COUNT_TOL):
at the solvers' default 1e-7 these systems' f32 residuals sit at their
noise floor, where either side's last iterations follow its rounding; at
1e-6 the two agree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
from facedeform_tpu import Deformer as JDeformer
from facedeform_tpu.geometry.primitives import fibonacci_points
from facedeform_tpu.ops import assemble as jassemble
from facedeform_tpu.ops import krylov as jk
from facedeform_tpu_torch import Deformer, convert
from facedeform_tpu_torch.config import PolyTerm, RBFKernel
from facedeform_tpu_torch.ops import assemble as tassemble
from facedeform_tpu_torch.ops import fit as tfit
from facedeform_tpu_torch.ops import krylov as tk
from facedeform_tpu_torch.parallel import batched
from facedeform_tpu_torch.utils import errors

K = jcfg.RBFKernel
M = jcfg.RBFModelType
JP = jcfg.PolyTerm

# the port's saddle matvec and preconditioners vs the JAX package's,
# relative to max |y|: the same f32 arithmetic up to summation order
OP_RTOL = 1e-5
# a stopping tolerance the f32 arithmetic resolves (see the module doc)
COUNT_TOL = 1e-6


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """Run on one torch intra-op thread, as tests/test_torch_eval.py's
    fixture of this name does (and for its reasons; the count is never
    raised again).  These solvers run hundreds of small operations, and
    under the tier-1 command's six workers each worker's intra-op pool
    contends for the same cores: on all threads, tests of about a second
    on their own took minutes there."""
    torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _counted_jax(mv):
    """mv with a host counter of its executed applications."""
    calls = [0]

    def bump():
        calls[0] += 1

    def counted(x):
        jax.debug.callback(bump)
        return mv(x)

    return counted, calls


def _counted(mv):
    calls = [0]

    def counted(x):
        calls[0] += 1
        return mv(x)

    return counted, calls


def _sync_calls(calls):
    jax.effects_barrier()
    return calls[0]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


# ---------------------------------------------------------------- operators
MATVEC_CASES = [
    # QNN: per-point radii (non-symmetric), no ridge, LINEAR tail
    ("qnn_eps", K.GAUSSIAN, JP.LINEAR, "qnn", 0.0),
    ("gaussian_scalar_lam", K.GAUSSIAN, JP.LINEAR, 0.5, 0.05),
    ("gaussian_marker_lam_zero_tail", K.GAUSSIAN, JP.ZERO, 0.5, "marker"),
    ("tps_marker_lam", K.THIN_PLATE, JP.LINEAR, 1.0, "marker"),
]


def _eps_lam(ctrl, eps, lam):
    n = ctrl.shape[0]
    if eps == "qnn":
        eps = np.asarray(tfit._qnn_radii(_t(ctrl), 1.0, 5.0))
    else:
        eps = np.full((n,), eps, np.float32)
    if lam == "marker":
        lam = (0.01 / np.linspace(0.2, 1.0, n)).astype(np.float32)
    else:
        lam = np.float32(lam)
    return eps, lam


@pytest.mark.parametrize("name,kernel,term,eps,lam", MATVEC_CASES,
                         ids=[c[0] for c in MATVEC_CASES])
def test_saddle_matvec_matches_jax(rng, name, kernel, term, eps, lam):
    n = 300
    ctrl = fibonacci_points(n)
    eps, lam = _eps_lam(ctrl, eps, lam)
    m = {JP.LINEAR: 4, JP.ZERO: 0}[term]
    x = rng.standard_normal((n + m, 3)).astype(np.float32)
    want = np.asarray(jk.make_saddle_matvec(jnp.asarray(ctrl), kernel, term, jnp.asarray(eps),
                                            jnp.asarray(lam), chunk=64)(jnp.asarray(x)))
    got = tk.make_saddle_matvec(_t(ctrl), RBFKernel(kernel), PolyTerm(term), _t(eps), _t(lam),
                                chunk=64)(_t(x)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < OP_RTOL
    # and against the assembled system it never materializes
    a = tassemble.assemble_system(_t(ctrl), RBFKernel(kernel), PolyTerm(term), _t(eps), _t(lam))
    assert _rel(got, a.double().numpy() @ x.astype(np.float64)) < OP_RTOL


BJ_CASES = [
    ("qnn_eps_padded", K.GAUSSIAN, "qnn", 0.0, 128),
    ("gaussian_marker_lam", K.GAUSSIAN, 0.4, "marker", 128),
    ("imq", K.INVERSE_MULTIQUADRIC, 0.2, 0.05, 96),
]


@pytest.mark.parametrize("name,kernel,eps,lam,block", BJ_CASES, ids=[c[0] for c in BJ_CASES])
def test_block_jacobi_matches_jax(rng, name, kernel, eps, lam, block):
    n = 300                     # not a multiple of the block: a padded mixed block
    ctrl = fibonacci_points(n)
    eps, lam = _eps_lam(ctrl, eps, lam)
    r = rng.standard_normal((n + 4, 2)).astype(np.float32)
    want = np.asarray(jk.make_block_jacobi(jnp.asarray(ctrl), kernel, JP.LINEAR, jnp.asarray(eps),
                                           jnp.asarray(lam), block=block)(jnp.asarray(r)))
    got = tk.make_block_jacobi(_t(ctrl), RBFKernel(kernel), PolyTerm.LINEAR, _t(eps), _t(lam),
                               block=block)(_t(r)).numpy()
    assert _rel(got, want) < OP_RTOL
    np.testing.assert_array_equal(got[n:], r[n:])      # identity on the tail rows


ABS_CASES = [
    # TPS at lam 2: indefinite blocks with a |w| condition below 1e2, so
    # the f32 eigh resolves every direction (both asserted)
    ("tps_indefinite", K.THIN_PLATE, 1.0, 2.0),
    ("gaussian_definite", K.GAUSSIAN, 0.2, 0.01),
]


def _first_block_spectrum(ctrl, kernel, eps, lam, block=128):
    """float64 eigenvalues of the first Z-ordered diagonal block."""
    from facedeform_tpu_torch.ops.morton import spatial_order

    c = _t(ctrl)[spatial_order(_t(ctrl))[0][:block]].double()
    a = tassemble.assemble_system(c, RBFKernel(kernel), PolyTerm.ZERO, eps, lam)
    return np.linalg.eigvalsh(a.numpy())


def _abs_cond(w):
    return np.abs(w).max() / np.abs(w).min()


@pytest.mark.parametrize("name,kernel,eps,lam", ABS_CASES, ids=[c[0] for c in ABS_CASES])
def test_abs_block_jacobi_matches_jax(rng, name, kernel, eps, lam):
    """The applied operator, never Q: eigenvector signs and the order of
    degenerate eigenvectors differ between LAPACK builds."""
    n = 300
    ctrl = fibonacci_points(n)
    r = rng.standard_normal((n + 4, 2)).astype(np.float32)
    want = np.asarray(jk.make_abs_block_jacobi(
        jnp.asarray(ctrl), kernel, JP.LINEAR, jnp.full((n,), eps), jnp.float32(lam),
        block=128)(jnp.asarray(r)))
    got = tk.make_abs_block_jacobi(_t(ctrl), RBFKernel(kernel), PolyTerm.LINEAR,
                                   torch.full((n,), eps), lam, block=128)(_t(r)).numpy()
    assert _rel(got, want) < OP_RTOL
    w = _first_block_spectrum(ctrl, kernel, eps, lam)
    assert _abs_cond(w) < 1e2 and (w.min() < 0) == (kernel == K.THIN_PLATE)


def test_abs_block_jacobi_ill_conditioned_as_close_to_float64_as_jax(rng):
    """At the route's own TPS setting (lam 0.01) a block's |w| condition
    is above 1e3, and any f32 eigh misses the float64 operator by ~u *
    cond: the port must be no further from the float64 operator than twice
    JAX's distance (the CPU margin of tests/test_krylov.py's df tests)."""
    n = 300
    ctrl = fibonacci_points(n)
    r = rng.standard_normal((n + 4, 2)).astype(np.float32)
    args = (RBFKernel.THIN_PLATE, PolyTerm.LINEAR, torch.ones(n), 0.01)
    got = tk.make_abs_block_jacobi(_t(ctrl), *args, block=128)(_t(r)).numpy()
    ref = tk.make_abs_block_jacobi(_t(ctrl).double(), *args, block=128)(
        _t(r).double()).numpy()
    want = np.asarray(jk.make_abs_block_jacobi(
        jnp.asarray(ctrl), K.THIN_PLATE, JP.LINEAR, jnp.ones((n,)), jnp.float32(0.01),
        block=128)(jnp.asarray(r)))
    assert _abs_cond(_first_block_spectrum(ctrl, K.THIN_PLATE, 1.0, 0.01)) > 1e3
    assert _rel(got, ref) <= 2 * _rel(want, ref)


def test_block_jacobi_is_exact_for_block_diagonal(rng):
    """With block == N the preconditioner IS the (unjittered) inverse."""
    ctrl = _t(fibonacci_points(64))
    eps, lam = torch.full((64,), 0.4), 0.05
    msolve = tk.make_block_jacobi(ctrl, RBFKernel.GAUSSIAN, PolyTerm.ZERO, eps, lam,
                                  block=64, jitter=0.0)
    a = tassemble.assemble_system(ctrl, RBFKernel.GAUSSIAN, PolyTerm.ZERO, eps, lam)
    r = rng.standard_normal((64, 2)).astype(np.float32)
    want = np.linalg.solve(a.double().numpy(), r.astype(np.float64))
    np.testing.assert_allclose(msolve(_t(r)).numpy(), want, rtol=1e-3, atol=1e-4)


def test_abs_block_jacobi_is_spd(rng):
    """SPD even when the kernel blocks are indefinite (TPS)."""
    ctrl = _t(rng.standard_normal((90, 3)))
    msolve = tk.make_abs_block_jacobi(ctrl, RBFKernel.THIN_PLATE, PolyTerm.LINEAR,
                                      torch.ones(90), 0.01, block=32)
    m_inv = msolve(torch.eye(94)).double().numpy()
    np.testing.assert_allclose(m_inv, m_inv.T, atol=1e-5)
    assert np.linalg.eigvalsh((m_inv + m_inv.T) / 2).min() > 0


def test_abs_block_jacobi_inverts_definite_block(rng):
    """Block >= N on a PD kernel: |w| = w, so M^-1 r recovers A^-1 r."""
    ctrl = _t(fibonacci_points(64))
    eps, lam = torch.full((64,), 0.4), 0.05
    msolve = tk.make_abs_block_jacobi(ctrl, RBFKernel.GAUSSIAN, PolyTerm.ZERO, eps, lam,
                                      block=96)
    a = tassemble.assemble_system(ctrl, RBFKernel.GAUSSIAN, PolyTerm.ZERO, eps, lam)
    r = rng.standard_normal((64, 2)).astype(np.float32)
    want = np.linalg.solve(a.double().numpy(), r.astype(np.float64))
    np.testing.assert_allclose(msolve(_t(r)).numpy(), want, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------- solvers
def _gaussian_saddle(n=300, eps=0.12, lam=0.02, block=128):
    ctrl = fibonacci_points(n)
    jmv = jk.make_saddle_matvec(jnp.asarray(ctrl), K.GAUSSIAN, JP.LINEAR, jnp.float32(eps),
                                jnp.float32(lam))
    jms = jk.make_block_jacobi(jnp.asarray(ctrl), K.GAUSSIAN, JP.LINEAR,
                               jnp.full((n,), eps, jnp.float32), jnp.float32(lam), block=block)
    tmv = tk.make_saddle_matvec(_t(ctrl), RBFKernel.GAUSSIAN, PolyTerm.LINEAR, eps, lam)
    tms = tk.make_block_jacobi(_t(ctrl), RBFKernel.GAUSSIAN, PolyTerm.LINEAR,
                               torch.full((n,), eps), lam, block=block)
    return (jmv, jms), (tmv, tms)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "x0"])
def test_pminres_matches_jax(rng, warm):
    (jmv, jms), (tmv, tms) = _gaussian_saddle()
    b = rng.standard_normal((304, 3)).astype(np.float32)
    x0 = None
    if warm:  # a partial solve to restart from, as fit's second sweep does
        x0 = np.asarray(jk.pminres(jmv, jnp.asarray(b), jms, maxiter=4)[0])
    jx0, tx0 = (None, None) if x0 is None else (jnp.asarray(x0), _t(x0))
    xj, _ = jk.pminres(jmv, jnp.asarray(b), jms, x0=jx0)
    xt, rt = tk.pminres(tmv, _t(b), tms, x0=tx0)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2e-4)
    assert float(rt.backward_error()) < 1e-6
    assert tuple(rt.col_backward.shape) == (3,)
    jmv_c, jcalls = _counted_jax(jmv)
    tmv_c, tcalls = _counted(tmv)
    jk.pminres(jmv_c, jnp.asarray(b), jms, tol=COUNT_TOL, x0=jx0)
    tk.pminres(tmv_c, _t(b), tms, tol=COUNT_TOL, x0=tx0)
    assert abs(tcalls[0] - _sync_calls(jcalls)) <= 1, (tcalls[0], jcalls[0])


def test_pminres_matches_minres_solution(rng):
    """Preconditioning changes the path, not the answer."""
    _, (tmv, tms) = _gaussian_saddle()
    b = _t(rng.standard_normal((304, 3)))
    x_p, rep_p = tk.pminres(tmv, b, tms)
    x_m, _ = tk.minres(tmv, b)
    assert float(rep_p.backward_error()) < 1e-6
    np.testing.assert_allclose(x_p.numpy(), x_m.numpy(), atol=2e-4)


def test_pminres_zero_column_stays_zero(rng):
    """A zero column (planar rig delta) among live ones: its update stays
    exactly zero and the live columns are solved (the JAX test's bounds).
    No count comparison here: this CPD system's |.|-block-Jacobi blocks have
    a |w| condition above 1e3, so the two f32 eigh decompositions give
    operators far apart, and both sides stall at a true residual far above
    tol, where their tracked residuals reach 1e-7 after different counts."""
    n = 300
    ctrl = fibonacci_points(n)
    eps, lam = np.ones((n,), np.float32), np.float32(0.05)
    b = np.array(jassemble.assemble_rhs(
        jnp.asarray(0.05 * rng.standard_normal((n, 3)).astype(np.float32)), JP.LINEAR))
    b[:, 2] = 0.0
    tmv = tk.make_saddle_matvec(_t(ctrl), RBFKernel.THIN_PLATE, PolyTerm.LINEAR, _t(eps),
                                float(lam))
    tms = tk.make_abs_block_jacobi(_t(ctrl), RBFKernel.THIN_PLATE, PolyTerm.LINEAR, _t(eps),
                                   float(lam), block=128)
    x, _ = tk.pminres(tmv, _t(b), tms)
    x = x.numpy()
    np.testing.assert_array_equal(x[:, 2], 0.0)
    assert np.isfinite(x).all()
    r = tmv(_t(x)).numpy() - b
    assert np.abs(r[:, :2]).max() < 1e-2 * np.abs(b).max()


@pytest.mark.parametrize("solver", ["pminres", "minres", "gmres"])
def test_zero_rhs_converges_at_once(solver):
    """An all-zero right-hand side runs no iteration: the dead-column
    guards zero its tracked residual, and the only matvec is the report's
    (GMRES: no restart)."""
    (_, _), (tmv, tms) = _gaussian_saddle()
    counted, calls = _counted(tmv)
    b = torch.zeros(304, 3)
    if solver == "pminres":
        x, rep = tk.pminres(counted, b, tms)
    elif solver == "minres":
        x, rep = tk.minres(counted, b)
    else:
        x, rep = tk.gmres(counted, b, tms)
    assert calls[0] == 1
    assert torch.equal(x, torch.zeros_like(b)) and float(rep.residual_norm) == 0.0


def test_gmres_identity_preconditioner_matches_jax(rng):
    """msolve=None: plain restarted GMRES on a non-symmetric system."""
    n = 120
    a = (np.eye(n) * 3 + rng.standard_normal((n, n)) / np.sqrt(n)).astype(np.float32)
    b = rng.standard_normal((n, 3)).astype(np.float32)
    a_j, a_t = jnp.asarray(a), _t(a)
    jmv, jcalls = _counted_jax(lambda v: jnp.dot(a_j, v, precision="highest"))
    tmv, tcalls = _counted(lambda v: a_t @ v)
    xj, _ = jk.gmres(jmv, jnp.asarray(b), tol=COUNT_TOL)
    xt, rt = tk.gmres(tmv, _t(b), tol=COUNT_TOL)
    x_ref = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    tol = 1e-4 * np.abs(x_ref).max() + 1e-5
    assert np.abs(xt.numpy() - x_ref).max() < tol
    assert np.abs(xt.numpy() - np.asarray(xj)).max() < tol
    assert float(rt.backward_error()) < 1e-6
    # a restart of 32 Arnoldi steps is 32 + 2 matvecs: the same restarts
    assert tcalls[0] == _sync_calls(jcalls), (tcalls[0], jcalls[0])


def _qnn_saddle(n=400):
    ctrl = fibonacci_points(n)
    eps = np.asarray(tfit._qnn_radii(_t(ctrl), 1.0, 5.0))
    jargs = (jnp.asarray(ctrl), K.GAUSSIAN, JP.LINEAR, jnp.asarray(eps), jnp.float32(0.0))
    targs = (_t(ctrl), RBFKernel.GAUSSIAN, PolyTerm.LINEAR, _t(eps), 0.0)
    return ((jk.make_saddle_matvec(*jargs), jk.make_block_jacobi(*jargs)),
            (tk.make_saddle_matvec(*targs), tk.make_block_jacobi(*targs)))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "x0"])
def test_gmres_block_jacobi_matches_jax(rng, warm):
    """The QNN route's solve: block-Jacobi GMRES on the non-symmetric
    saddle system, cold and warm-started (fit's second sweep)."""
    (jmv, jms), (tmv, tms) = _qnn_saddle()
    b = np.asarray(jassemble.assemble_rhs(
        jnp.asarray(0.05 * rng.standard_normal((400, 3)).astype(np.float32)), JP.LINEAR))
    x0 = None
    if warm:
        x0 = np.asarray(jk.gmres(jmv, jnp.asarray(b), jms, restart=4, max_restarts=1)[0])
    jmv_c, jcalls = _counted_jax(jmv)
    tmv_c, tcalls = _counted(tmv)
    xj, _ = jk.gmres(jmv_c, jnp.asarray(b), jms, tol=COUNT_TOL,
                     x0=None if x0 is None else jnp.asarray(x0))
    xt, rt = tk.gmres(tmv_c, _t(b), tms, tol=COUNT_TOL, x0=None if x0 is None else _t(x0))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj),
                               atol=1e-4 * np.abs(np.asarray(xj)).max() + 1e-5)
    assert float(rt.backward_error()) < 1e-6
    assert tcalls[0] == _sync_calls(jcalls), (tcalls[0], jcalls[0])


def test_gmres_converged_x0_exits_at_once(rng):
    (_, _), (tmv, tms) = _qnn_saddle()
    b = _t(rng.standard_normal((404, 3)))
    x, _ = tk.gmres(tmv, b, tms, tol=COUNT_TOL)
    counted, calls = _counted(tmv)
    x2, _ = tk.gmres(counted, b, tms, tol=COUNT_TOL, x0=x)
    assert calls[0] == 2          # the warm residual and the report's
    assert torch.equal(x2, x)


def test_minres_random_symmetric_indefinite_matches_jax(rng):
    n = 150
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eig = np.concatenate([np.linspace(0.5, 3, n - 15), -np.linspace(0.5, 2, 15)])
    a = ((q * eig) @ q.T).astype(np.float32)
    b = rng.standard_normal((n, 3)).astype(np.float32)
    a_j, a_t = jnp.asarray(a), _t(a)
    jmv, jcalls = _counted_jax(lambda v: jnp.dot(a_j, v, precision="highest"))
    tmv, tcalls = _counted(lambda v: a_t @ v)
    xj, _ = jk.minres(jmv, jnp.asarray(b), maxiter=400, tol=COUNT_TOL)
    xt, rt = tk.minres(tmv, _t(b), maxiter=400, tol=COUNT_TOL)
    x_ref = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    tol = 1e-4 * np.abs(x_ref).max() + 1e-5
    assert np.abs(xt.numpy() - x_ref).max() < tol
    assert np.abs(xt.numpy() - np.asarray(xj)).max() < tol
    assert float(rt.residual_norm) < 1e-4 * float(rt.rhs_norm)
    assert abs(tcalls[0] - _sync_calls(jcalls)) <= 1, (tcalls[0], jcalls[0])


def test_cpd_preconditioner_beats_plain_minres(rng):
    """At a fixed iteration budget on a TPS saddle system |.|-block-Jacobi
    PMINRES lands a materially lower true residual than plain MINRES."""
    n = 600
    ctrl = _t(rng.standard_normal((n, 3)))
    eps, lam = torch.ones(n), 0.01
    mv = tk.make_saddle_matvec(ctrl, RBFKernel.THIN_PLATE, PolyTerm.LINEAR, eps, lam)
    b = tassemble.assemble_rhs(_t(0.05 * rng.standard_normal((n, 3))), PolyTerm.LINEAR)
    msolve = tk.make_abs_block_jacobi(ctrl, RBFKernel.THIN_PLATE, PolyTerm.LINEAR, eps, lam,
                                      block=256)
    x_p, _ = tk.pminres(mv, b, msolve, maxiter=128)
    x_m, _ = tk.minres(mv, b, maxiter=128)
    r_p = float(torch.linalg.norm(b - mv(x_p)))
    r_m = float(torch.linalg.norm(b - mv(x_m)))
    assert r_p < 0.5 * r_m, (r_p, r_m)


# ------------------------------------------------------------ float64 path
def _tps64(ctrl, lam):
    c = ctrl.astype(np.float64)
    n = c.shape[0]
    d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    phi = np.where(d2 <= 1e-30, 0.0, 0.5 * d2 * np.log(np.maximum(d2, 1e-30)))
    p = np.concatenate([np.ones((n, 1)), c], 1)
    a = np.zeros((n + 4, n + 4))
    a[:n, :n] = phi + lam * np.eye(n)
    a[:n, n:] = p
    a[n:, :n] = p.T
    a[n:, n:] = -1e-8 * np.eye(4)
    return a


def test_df_matvec_at_least_as_close_to_float64_as_jax(rng):
    """The float64 matvec (the JAX package's double-float sweep) is at
    least as close to a float64 reference as JAX's, and beats the f32
    matvec."""
    n = 600
    ctrl = fibonacci_points(n)
    x = rng.standard_normal((n + 4, 3)).astype(np.float32)
    lam = np.float32(0.01)
    yref = _tps64(ctrl, float(lam)) @ x.astype(np.float64)
    sc = np.abs(yref).max()
    jdf = jk.make_saddle_matvec_df(jnp.asarray(ctrl), K.THIN_PLATE, JP.LINEAR,
                                   jnp.ones((n,), jnp.float32), lam)
    err_jax = np.abs(np.asarray(jdf(jnp.asarray(x)), np.float64) - yref).max() / sc
    targs = (_t(ctrl), RBFKernel.THIN_PLATE, PolyTerm.LINEAR, torch.ones(n), float(lam))
    ydf = tk.make_saddle_matvec_df(*targs)(_t(x)).double().numpy()
    y32 = tk.make_saddle_matvec(*targs)(_t(x)).double().numpy()
    err_df = np.abs(ydf - yref).max() / sc
    err_32 = np.abs(y32 - yref).max() / sc
    assert err_df <= err_jax, (err_df, err_jax)
    assert err_df < err_32 and err_df < 1e-6
    # the pair carries the float64 result below the f32 rounding
    hi, lo = tk.make_saddle_matvec_df_pair(*targs)((_t(x), torch.zeros(n + 4, 3)))
    assert np.abs(hi.double().numpy() + lo.double().numpy() - yref).max() / sc < 1e-12


def test_df_matvec_per_marker_lam(rng):
    n = 300
    ctrl = _t(fibonacci_points(n))
    x = _t(rng.standard_normal((n + 4, 3)))
    lam = _t(0.01 / np.linspace(0.2, 1.0, n))
    args = (ctrl, RBFKernel.GAUSSIAN, PolyTerm.LINEAR, torch.ones(n), lam)
    np.testing.assert_allclose(tk.make_saddle_matvec_df(*args)(x).numpy(),
                               tk.make_saddle_matvec(*args)(x).numpy(), atol=5e-5)


def test_pminres_df_beats_f32_floor(rng):
    """pminres_df (float64 vectors and matvec) lands a lower true residual
    than f32 PMINRES at the same budget on an ill-conditioned TPS system."""
    n = 400
    ctrl = fibonacci_points(n)
    lam = 1e-4
    targs = (_t(ctrl), RBFKernel.THIN_PLATE, PolyTerm.LINEAR, torch.ones(n), lam)
    msolve = tk.make_abs_block_jacobi(*targs, block=128)
    b = tassemble.assemble_rhs(_t(0.05 * rng.standard_normal((n, 3))), PolyTerm.LINEAR)
    x32, _ = tk.pminres(tk.make_saddle_matvec(*targs), b, msolve, tol=0.0, maxiter=512)
    (xh, xl), rep = tk.pminres_df(tk.make_saddle_matvec_df_pair(*targs), b, msolve,
                                  tol=0.0, maxiter=512)
    a = _tps64(ctrl, lam)
    bb = b.double().numpy()

    def rel_res(x):
        return np.abs(a @ x - bb).max() / np.abs(bb).max()

    r32 = rel_res(x32.double().numpy())
    rdf = rel_res(xh.double().numpy() + xl.double().numpy())
    assert np.isfinite(rdf) and rdf < 0.5 * r32, (r32, rdf)
    assert xh.dtype == xl.dtype == torch.float32
    assert rep.residual_norm.dtype == torch.float32


# ------------------------------------------------------------- the fit route
FIT_CASES = [
    # (id, cfg kwargs, params, n, krylov-vs-direct tolerance (err, scale))
    ("qnn", dict(model=M.QNN), dict(radius=0.4, lam=0.01), 400, "decaying"),
    ("gaussian", dict(model=M.KERNEL), dict(radius=0.4, lam=0.01), 400, "decaying"),
    ("multilayer3", dict(model=M.MULTILAYER, layers=3), dict(radius=1.0, lam=0.05), 250,
     "decaying"),
    ("tps", dict(model=M.KERNEL, kernel=K.THIN_PLATE), dict(radius=1.0, lam=0.01), 500, "cpd"),
]


def _tol(kind, err, scale):
    # the JAX package's bounds (tests/test_krylov.py)
    return err < (5e-5 + 1e-3 * scale if kind == "decaying" else 5e-3 * scale + 1e-4)


@pytest.mark.parametrize("name,cfg_kw,params_kw,n,kind", FIT_CASES, ids=[c[0] for c in FIT_CASES])
def test_fit_krylov_matches_direct_and_jax(rng, name, cfg_kw, params_kw, n, kind):
    rest = fibonacci_points(n)
    deformed = rest + 0.05 * rng.standard_normal((n, 3)).astype(np.float32)
    pts = rng.standard_normal((400, 3)).astype(np.float32)
    jparams = jcfg.DeformParams(**params_kw)
    tparams = convert.params_from_fields(jparams._asdict())
    out = {}
    for solver in ("direct", "krylov"):
        jc = jcfg.DeformConfig(**cfg_kw, solver=solver)
        tc = convert.config_from_fields(dataclasses.asdict(jc))
        d = Deformer.fit(rest, deformed, tc, tparams, device="cpu")
        out[solver] = d.displacement(pts).double().numpy()
        if solver == "krylov":
            assert d.model.w_rbf_lo is None and d.model.w_poly_lo is None
            jd = JDeformer.fit(rest, deformed, jc, jparams)
            out["jax"] = np.asarray(jd.displacement(pts), np.float64)
    scale = np.abs(out["direct"]).max()
    for other in ("direct", "jax"):
        err = np.abs(out["krylov"] - out[other]).max()
        assert _tol(kind, err, scale), (other, err, scale)


def test_routing_by_model_and_kernel(monkeypatch):
    """QNN -> GMRES + block-Jacobi, PD -> PMINRES + block-Jacobi, CPD ->
    PMINRES + |.|-block-Jacobi (the JAX package's ops/fit.py:360-405)."""
    seen = []
    for name in ("gmres", "pminres", "make_block_jacobi", "make_abs_block_jacobi"):
        real = getattr(tk, name)
        monkeypatch.setattr(tk, name, lambda *a, _r=real, _n=name, **k: (seen.append(_n), _r(*a, **k))[1])
    rest = fibonacci_points(60)
    deformed = rest + 0.01
    want = {
        (M.QNN, K.GAUSSIAN): ["make_block_jacobi", "gmres", "gmres"],
        (M.KERNEL, K.WENDLAND_C2): ["make_block_jacobi", "pminres", "pminres"],
        (M.KERNEL, K.MULTIQUADRIC): ["make_abs_block_jacobi", "pminres", "pminres"],
    }
    for (model, kernel), calls in want.items():
        seen.clear()
        tc = convert.config_from_fields(dataclasses.asdict(
            jcfg.DeformConfig(model=model, kernel=kernel, solver="krylov")))
        Deformer.fit(rest, deformed, tc, device="cpu", check=False)
        assert seen == calls, (model, kernel, seen)


def test_krylov_fit_past_the_threshold():
    """8193 controls on solver="auto" take the matrix-free route instead
    of raising: radius 0.01 against a ~0.04 spacing makes Phi ~ I, so
    block-Jacobi PMINRES converges in a few sweeps of the 8193^2 matvec."""
    n = tfit._KRYLOV_THRESHOLD + 1
    rest = fibonacci_points(n)
    deformed = rest + 0.01 * np.sin(7.0 * rest[:, [1, 2, 0]]).astype(np.float32)
    cfg = convert.config_from_fields(dataclasses.asdict(
        jcfg.DeformConfig(model=M.KERNEL, term=JP.ZERO, n_refine=1)))
    assert tfit.uses_krylov(cfg, n)
    d = Deformer.fit(rest, deformed, cfg, convert.params_from_fields(
        jcfg.DeformParams(radius=0.01, lam=0.01)._asdict()), device="cpu")
    assert d.model.w_rbf_lo is None
    assert float(d.report.backward_error()) <= errors.SOLVE_BACKWARD_RTOL
    # Phi = I to ~3e-7, so the ridge leaves w = delta / (1 + lam) and the
    # field at a control w_i
    idx = np.arange(0, n, 97)
    got = d.displacement(rest[idx]).numpy()
    np.testing.assert_allclose(got, (deformed - rest)[idx] / 1.01, atol=1e-6)


def test_krylov_shot_frames_equal_single_fits(rng):
    """A Krylov shot is a loop of per-pose fits: each frame equals its
    single fit bit for bit, and the repaired check_frames passes it."""
    n, f = 300, 3
    rest = fibonacci_points(n)
    frames = rest[None] + 0.05 * rng.standard_normal((f, n, 3)).astype(np.float32)
    cfg = convert.config_from_fields(dataclasses.asdict(
        jcfg.DeformConfig(model=M.KERNEL, kernel=K.THIN_PLATE, solver="krylov")))
    model, resid, report = batched.fit_frames(rest, frames, cfg, device="cpu", want_report=True)
    assert model.w_rbf_lo is None and tuple(model.w_rbf.shape) == (f, 1, n, 3)
    assert tuple(report.col_backward.shape) == (f, 3)
    torch.testing.assert_close(resid, report.residual_norm, rtol=0, atol=0)
    for i in range(f):
        single, rep = tfit.fit(_t(rest), _t(frames[i]), cfg)
        assert torch.equal(model.w_rbf[i], single.w_rbf)
        assert torch.equal(model.w_poly[i], single.w_poly)
        assert torch.equal(resid[i], rep.residual_norm)
    errors.check_frames(resid, rest, frames, cfg=cfg, report=report)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("n", [1000, 2000])
def test_tps_krylov_field_against_the_jax_routes_own(n):
    """Past ~1000 controls the f32 TPS Krylov field leaves the JAX test's
    5e-3 of scale behind, in the JAX package too.  At 1000 controls the
    JAX route still meets it; on chip_smoke.py phase 6c's 2000-control rig
    (same seed, same shell of probes) it sits JAX_TPS_KRYLOV_REL_ERR[2000]
    of scale from the dense field, the number phase 6c holds the port's
    field to (times KRYLOV_CPD_VS_JAX).  This measures both again.  On so
    ill-conditioned a solve the distance follows the rounding (XLA:CPU's
    thread count moves it by about 1%), hence the 10% band."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(3)
    rest = fibonacci_points(n)
    deformed = rest + 0.05 * rng.standard_normal((n, 3)).astype(np.float32)
    pts = fibonacci_points(4096) * 1.02
    jp = jcfg.DeformParams(radius=1.0, lam=0.01)
    jc = jcfg.DeformConfig(model=M.KERNEL, kernel=K.THIN_PLATE, solver="krylov")
    tc = convert.config_from_fields(dataclasses.asdict(jc))
    ref = Deformer.fit(rest, deformed, dataclasses.replace(tc, solver="direct"),
                       convert.params_from_fields(jp._asdict()),
                       device="cpu").displacement(pts).double().numpy()
    jax_err = np.abs(np.asarray(JDeformer.fit(rest, deformed, jc, jp).displacement(pts),
                                np.float64) - ref).max() / np.abs(ref).max()
    if n not in smoke.JAX_TPS_KRYLOV_REL_ERR:
        assert jax_err <= 5e-3, jax_err
        return
    want = smoke.JAX_TPS_KRYLOV_REL_ERR[n]
    assert abs(jax_err - want) <= 0.1 * want, (jax_err, want)
    assert jax_err > 5e-3


def _multilayer_krylov(n, radius, check):
    """The 3-layer gaussian Krylov fit (lam 0.05) in both packages on the
    same seeded rig: (port Deformer, JAX Deformer); check=True raises on
    either side's failed health check."""
    rng = np.random.default_rng(3)
    rest = fibonacci_points(n)
    deformed = rest + 0.05 * rng.standard_normal((n, 3)).astype(np.float32)
    jparams = jcfg.DeformParams(radius=radius, lam=0.05)
    jc = jcfg.DeformConfig(model=M.MULTILAYER, layers=3, solver="krylov")
    tc = convert.config_from_fields(dataclasses.asdict(jc))
    tparams = convert.params_from_fields(jparams._asdict())
    return (Deformer.fit(rest, deformed, tc, tparams, device="cpu", check=check),
            JDeformer.fit(rest, deformed, jc, jparams, check=check))


def test_multilayer_krylov_wide_first_layer_fails_in_jax_first():
    """The port's multilayer Krylov fit against the JAX package's on a rig
    whose first layer spans ~11 control spacings, as the card's 3-layer
    gaussian at radius 0.6 over 4096 controls does (600 controls, radius
    1.5), both forced onto PMINRES with the same inputs.  Outcome: the JAX
    route misses the 1e-6 health check (worst column 1.1-1.2e-6) where the
    port's passes.  At 4096 controls, radius 0.6, both raise on the CPU,
    as the port does on the card: the reference's behaviour, not a fault
    of the port (`JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_krylov.py`
    prints the sweep)."""
    from facedeform_tpu.utils import errors as jerrors

    with pytest.raises(jerrors.SolveFailedError):
        _multilayer_krylov(600, 1.5, check=True)
    d, jd = _multilayer_krylov(600, 1.5, check=False)
    errors.check_solve(d.report)
    be, jbe = float(d.report.backward_error()), float(jd.report.backward_error())
    assert be <= errors.SOLVE_BACKWARD_RTOL < float(np.max(np.asarray(jd.report.col_backward)))
    assert be < jbe
    # the two fields agree at the Krylov route's tolerance all the same
    pts = np.random.default_rng(4).standard_normal((400, 3)).astype(np.float32)
    got = d.displacement(pts).double().numpy()
    want = np.asarray(jd.displacement(pts), np.float64)
    assert _tol("decaying", np.abs(got - want).max(), np.abs(want).max())


if __name__ == "__main__":
    # the multilayer Krylov sweep behind the test above (minutes on the CPU)
    torch.set_num_threads(1)
    for n, radius in ((4096, 0.6), (2000, 0.85), (1000, 1.2), (1000, 0.6), (600, 1.5)):
        d, jd = _multilayer_krylov(n, radius, check=False)
        for name, rep in (("port", d.report), ("jax", jd.report)):
            be = float(rep.backward_error())
            worst = float(np.max(np.asarray(rep.col_backward)))
            print(f"{n} controls, radius {radius}: {name} backward error {be:.3e}, worst "
                  f"column {worst:.3e} ({'passes' if max(be, worst) <= 1e-6 else 'raises'} "
                  "at 1e-6)", flush=True)
