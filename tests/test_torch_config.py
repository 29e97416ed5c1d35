"""PyTorch port: config surface matches the JAX package's dataclasses."""

import dataclasses

import pytest

import facedeform_tpu.config as jcfg
import facedeform_tpu_torch.config as tcfg
from facedeform_tpu_torch import convert


@pytest.mark.parametrize("name", ["RBFModelType", "PolyTerm", "RBFKernel"])
def test_enums_match(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    assert [(m.name, int(m)) for m in j] == [(m.name, int(m)) for m in t]


def test_deform_config_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.DeformConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.DeformConfig)]
    assert sorted(jf) == sorted(tf)


@pytest.mark.parametrize("kw", [
    {},
    {"model": 1, "layers": 3, "term": 1},
    {"model": 2, "kernel": 6, "term": 2, "tangent": True, "strict_parity": True},
    {"layers": 0},
])
def test_deform_config_views_match(kw):
    j, t = jcfg.DeformConfig(**kw), tcfg.DeformConfig(**kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.solve_view()) == dataclasses.asdict(t.solve_view())
    assert dataclasses.asdict(j.eval_view()) == dataclasses.asdict(t.eval_view())
    assert (j.n_poly, j.n_layers) == (t.n_poly, t.n_layers)
    assert convert.config_from_fields(dataclasses.asdict(j)) == t


@pytest.mark.parametrize("bad", [{"solver": "lu"}, {"falloff_metric": "manhattan"}])
def test_deform_config_rejects_like_jax(bad):
    with pytest.raises(ValueError):
        jcfg.DeformConfig(**bad)
    with pytest.raises(ValueError):
        tcfg.DeformConfig(**bad)


def test_deform_params_fields_and_defaults_match():
    assert jcfg.DeformParams._fields == tcfg.DeformParams._fields
    assert tuple(jcfg.DeformParams()) == tuple(tcfg.DeformParams())


@pytest.mark.parametrize("vals", [
    {},
    {"qcoef": 0.01, "zcoef": -1.0, "radius": 0.0, "lam": 0.0, "falloffrate": -2.0},
    {"qcoef": 2.5, "zcoef": 0.2, "radius": 0.3, "lam": 0.05, "falloffrate": 1.5},
])
def test_deform_params_clamped_match(vals):
    j = jcfg.DeformParams(**vals).clamped()
    t = tcfg.DeformParams(**vals).clamped()
    for name in tcfg.DeformParams._fields:
        assert float(getattr(t, name)) == pytest.approx(float(getattr(j, name)), rel=1e-7)
        assert isinstance(getattr(t, name), (int, float))
    assert convert.params_from_fields(j._asdict()) == pytest.approx(tuple(t), rel=1e-7)
