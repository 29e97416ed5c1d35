"""PyTorch port: the input linter (doctor.py) against the JAX package's
facedeform_tpu.doctor.diagnose on tests/test_doctor.py's inputs, CPU
tensors.

The findings must equal JAX's (severity, code and message, in order) and
every stat must agree within 1e-5 relative.  The solve probe's backward
error is the exception: it is each package's own refined residual, at
~1e-16 in both, so it is held to its health threshold and the findings
that print it (`solve-ok`, `ill-conditioned`) to their severity and code.
The LU growth indicator is held to JAX's within 1e-4 relative (the
measured spread is 1.1e-7).  A multilayer probe reports the indicator of
the layer with the worst backward error; those errors sit at ~1e-16 in
both packages, below float32's resolution, so the two may pick different
layers: there JAX's indicator must equal one of the port's layers'.
"""

import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
from facedeform_tpu.doctor import diagnose as jdiagnose
from facedeform_tpu.geometry.mesh import Mesh as JMesh
from facedeform_tpu.geometry.primitives import fibonacci_points, uv_sphere
from facedeform_tpu_torch import config as tcfg
from facedeform_tpu_torch.doctor import diagnose as tdiagnose
from facedeform_tpu_torch.geometry.mesh import Mesh as TMesh
from facedeform_tpu_torch.ops import fit as tfit

STAT_RTOL = 1e-5
COND_RTOL = 1e-4
SOLVE_CODES = ("solve-ok", "ill-conditioned")


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One torch intra-op thread, as the other JAX-parity tests run (see
    tests/test_torch_eval.py); never raised again."""
    torch.set_num_threads(1)


def _base(seed=42, n=30):
    rng = np.random.default_rng(seed)
    mesh = uv_sphere(25, 25)
    rig = fibonacci_points(n)
    posed = rig + 0.05 * rng.standard_normal((n, 3)).astype(np.float32)
    return mesh, rig, posed, rng


def _case_clean(M):
    mesh, rig, posed, _ = _base()
    return (M(points=mesh.points, faces=mesh.faces), M(points=rig), [M(points=posed)]), {}


def _case_duplicates(M):
    mesh, rig, _, _ = _base()
    pts = rig.copy()
    pts[5] = pts[4] + 1e-6
    return (M(points=mesh.points, faces=mesh.faces), M(points=pts)), dict(probe_solve=False)


def _case_no_overlap(M):
    mesh, rig, _, _ = _base()
    return (M(points=mesh.points, faces=mesh.faces), M(points=rig + np.float32([100, 0, 0]))), \
        dict(probe_solve=False)


def _case_scale(M):
    mesh, rig, _, _ = _base()
    tiny = (rig * 1e-3 + mesh.points.mean(0)).astype(np.float32)
    return (M(points=mesh.points, faces=mesh.faces), M(points=tiny)), dict(probe_solve=False)


def _case_radius(radius):
    def case(M):
        mesh, rig, _, _ = _base()
        return (M(points=mesh.points, faces=mesh.faces), M(points=rig)), \
            dict(probe_solve=False, params=dict(radius=radius))
    return case


def _case_symmetry(M):
    mesh, _, _, rng = _base()
    half = np.abs(fibonacci_points(20))
    sym_rig = np.concatenate([half, half * np.float32([-1, 1, 1])])
    posed = sym_rig + 0.02 * rng.standard_normal(sym_rig.shape).astype(np.float32)
    return (M(points=mesh.points, faces=mesh.faces), M(points=sym_rig), [M(points=posed)]), \
        dict(probe_solve=False)


def _case_jitter(noise):
    def case(M):
        mesh, rig, _, rng = _base()
        t = np.linspace(0, 1, 9, dtype=np.float32)[:, None, None]
        frames = rig[None] + 0.01 * t * np.float32([0, 1, 0])
        frames = frames + noise * rng.standard_normal(frames.shape).astype(np.float32)
        return (M(points=mesh.points, faces=mesh.faces), M(points=rig),
                [M(points=f) for f in frames]), dict(probe_solve=False)
    return case


def _case_confidence(model, probe):
    def case(M):
        mesh, rig, posed, _ = _base()
        r = M(points=rig)
        r.set_attr("confidence", np.float32([1.5] + [0.8] * 29))
        return (M(points=mesh.points, faces=mesh.faces), r, [M(points=posed)]), \
            dict(probe_solve=probe, cfg=dict(model=model))
    return case


def _case_count_mismatch(M):
    mesh, rig, _, _ = _base()
    return (M(points=mesh.points, faces=mesh.faces), M(points=rig), [M(points=rig[:-2])]), {}


def _case_nan(M):
    mesh, rig, _, _ = _base()
    pts = rig.copy()
    pts[0, 0] = np.nan
    return (M(points=mesh.points, faces=mesh.faces), M(points=pts)), {}


def _case_krylov_skip(M):
    _, _, _, rng = _base()
    big = rng.standard_normal((9000, 3)).astype(np.float32)
    small = rng.standard_normal((50, 3)).astype(np.float32) * 5
    return (M(points=small), M(points=big), [M(points=big)]), {}


def _case_all_coincident(M):
    mesh, rig, _, _ = _base()
    return (M(points=mesh.points, faces=mesh.faces), M(points=np.concatenate([rig, rig]))), \
        dict(probe_solve=False)


def _case_exact_copy(M):
    mesh, rig, _, _ = _base()
    pts = rig.copy()
    pts[5] = pts[4]
    return (M(points=mesh.points, faces=mesh.faces), M(points=pts)), dict(probe_solve=False)


def _case_empty(M):
    mesh, _, _, _ = _base()
    return (M(points=mesh.points, faces=mesh.faces), M(points=np.zeros((0, 3), np.float32))), {}


def _case_single(M):
    mesh, rig, _, _ = _base()
    return (M(points=mesh.points, faces=mesh.faces), M(points=rig[:1])), dict(probe_solve=False)


def _case_falloff(dofalloff):
    def case(M):
        mesh, rig, _, _ = _base()
        return (M(points=mesh.points, faces=mesh.faces), M(points=rig)), \
            dict(probe_solve=False, params=dict(radius=0.05), cfg=dict(dofalloff=dofalloff))
    return case


def _case_group(pattern):
    def case(M):
        mesh, rig, posed, _ = _base()
        m = M(points=mesh.points, faces=mesh.faces)
        m.set_group("top", np.flatnonzero(mesh.points[:, 1] > 0.3))
        m.set_group("none", np.zeros(0, np.int64))
        return (m, M(points=rig), [M(points=posed)]), dict(group=pattern)
    return case


CASES = {
    "clean": _case_clean,
    "duplicate_markers": _case_duplicates,
    "no_overlap": _case_no_overlap,
    "scale_mismatch": _case_scale,
    "radius_small": _case_radius(0.01),
    "radius_large": _case_radius(50.0),
    "symmetric_rig": _case_symmetry,
    "tracker_jitter": _case_jitter(0.05),
    "calm_track": _case_jitter(0.0),
    "confidence_qnn": _case_confidence(0, False),
    "confidence_multilayer_probe": _case_confidence(1, True),
    "rig_count_mismatch": _case_count_mismatch,
    "non_finite": _case_nan,
    "krylov_probe_skipped": _case_krylov_skip,
    "all_markers_coincident": _case_all_coincident,
    "exact_duplicate": _case_exact_copy,
    "empty_rig": _case_empty,
    "single_marker": _case_single,
    "falloff_off": _case_falloff(False),
    "falloff_on": _case_falloff(True),
    "group": _case_group("top"),
    "bad_group": _case_group("nosuchgroup"),
    "empty_group": _case_group("none"),
}


def _run(name):
    out = []
    for M, mod, diag in ((JMesh, jcfg, jdiagnose), (TMesh, tcfg, tdiagnose)):
        args, kw = CASES[name](M)
        kw = dict(kw)
        if "cfg" in kw:
            kw["cfg"] = mod.DeformConfig(**kw["cfg"])
        if "params" in kw:
            kw["params"] = mod.DeformParams(**kw["params"])
        if diag is tdiagnose:
            kw["device"] = "cpu"
        out.append(diag(*args, **kw))
    return out


@pytest.fixture
def port_layer_conds(monkeypatch):
    """Every port fit's per-layer LU growth indicators, in layer order,
    read where the fit picks the layer it reports."""
    seen = []
    pick = tfit._worst_report

    def spy(reports):
        seen.append([float(r.cond_est) for r in reports if r.cond_est is not None])
        return pick(reports)

    monkeypatch.setattr(tfit, "_worst_report", spy)
    return seen


@pytest.mark.parametrize("name", list(CASES))
def test_diagnose_matches_jax(name, port_layer_conds):
    want, got = _run(name)
    assert len(got.findings) == len(want.findings), (got.findings, want.findings)
    for g, w in zip(got.findings, want.findings):
        assert (g.severity, g.code) == (w.severity, w.code)
        if g.code not in SOLVE_CODES:
            assert g.message == w.message
    assert got.summary() == want.summary()
    assert sorted(got.stats) == sorted(want.stats)
    for k, w in want.stats.items():
        g = got.stats[k]
        if k == "solve_backward_error":
            assert g < 1e-6 and w < 1e-6, (g, w)
        elif k == "solve_cond_indicator":
            layers = next(c for c in reversed(port_layer_conds) if g in c)
            if len(layers) == 1:
                assert g == pytest.approx(w, rel=COND_RTOL), (g, w)
            else:
                assert any(c == pytest.approx(w, rel=COND_RTOL) for c in layers), (layers, w)
        elif isinstance(w, str):
            assert g == w
        else:
            assert g == pytest.approx(w, rel=STAT_RTOL, abs=1e-12), k
