"""PyTorch port: checkpoints (utils/checkpoint.py) against the JAX
package's facedeform_tpu.utils.checkpoint, CPU tensors.

Every kind (dense with and without lo words, dense sequence, PU, PU
sequence, PSD, skinning, blendshapes) in both directions: one package
fits and saves, the other loads.  The loaded arrays must equal the
file's bit for bit, cfg and params must equal, kind() must agree, and a
loader given the wrong kind must raise the JAX package's words.  A JAX
file loaded and saved again by the port must be the same bytes (both
packages hold report scalars as float32 tensors, and a file's scalars
come from float32 values, so they round-trip exactly).  The orbax entry
points raise in the port.
"""

import numpy as np
import pytest
import torch

import facedeform_tpu.config as jcfg
from facedeform_tpu.deformer import Deformer as JDeformer
from facedeform_tpu.geometry.primitives import fibonacci_points, uv_sphere
from facedeform_tpu.ops import blendshapes as jbs
from facedeform_tpu.ops import psd as jpsd
from facedeform_tpu.ops import pu as jpu
from facedeform_tpu.ops import skinning as jsk
from facedeform_tpu.parallel import batched as jbatched
from facedeform_tpu.utils import checkpoint as jck
from facedeform_tpu_torch import config as tcfg
from facedeform_tpu_torch.deformer import Deformer as TDeformer
from facedeform_tpu_torch.ops import blendshapes as tbs
from facedeform_tpu_torch.ops import psd as tpsd
from facedeform_tpu_torch.ops import pu as tpu
from facedeform_tpu_torch.ops import skinning as tsk
from facedeform_tpu_torch.parallel import batched as tbatched
from facedeform_tpu_torch.utils import checkpoint as tck


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One torch intra-op thread, as the other JAX-parity tests run (see
    tests/test_torch_eval.py); never raised again."""
    torch.set_num_threads(1)


def _rig(n=30, frames=0, seed=0):
    rng = np.random.default_rng(seed)
    rest = fibonacci_points(n)
    if not frames:
        return rest, rest + 0.08 * rng.standard_normal(rest.shape).astype(np.float32)
    return rest, np.stack([rest + 0.08 * rng.standard_normal(rest.shape).astype(np.float32)
                           for _ in range(frames)])


def _mesh_frames(f=4, seed=1):
    pts = uv_sphere(10, 10).points
    rng = np.random.default_rng(seed)
    return pts, np.stack([pts + 0.05 * rng.standard_normal(pts.shape).astype(np.float32)
                          for _ in range(f)])


def _cfg(side, **kw):
    return (jcfg if side == "jax" else tcfg).DeformConfig(**kw)


def _params(side, **kw):
    return (jcfg if side == "jax" else tcfg).DeformParams(**kw)


def _dense(side, path, lo=False):
    rest, pose = _rig()
    if lo:
        kw = dict(model=2, kernel=1, tangent=True)
        pk = dict(radius=1.3, lam=0.02, maxedges=6)
    else:
        kw = dict(strict_parity=True)
        pk = dict(radius=0.7, falloffrate=1.5)
    cfg, params = _cfg(side, **kw), _params(side, **pk)
    if side == "jax":
        d = JDeformer.fit(rest, pose, cfg, params)
        assert d.model.w_rbf_lo is not None or not lo
        jck.save(path, d)
    else:
        d = TDeformer.fit(rest, pose, cfg, params, device="cpu")
        assert d.model.w_rbf_lo is not None or not lo
        tck.save(path, d)


def _seq(side, path):
    rest, frames = _rig(frames=3)
    cfg, params = _cfg(side, layers=2, model=1), _params(side, radius=1.2)
    if side == "jax":
        model, resid = jbatched.fit_frames(rest, frames, cfg, params)
        jck.save_seq(path, model, cfg, params, resid)
    else:
        model, resid = tbatched.fit_frames(rest, frames, cfg, params, device="cpu")
        tck.save_seq(path, model, cfg, params, resid)


def _pu(side, path):
    rest, pose = _rig(n=260)
    if side == "jax":
        jck.save_pu(path, jpu.PUDeformer.fit(rest, pose, patch_size=96))
    else:
        tck.save_pu(path, tpu.PUDeformer.fit(rest, pose, patch_size=96, device="cpu"))


def _pu_seq(side, path):
    rest, frames = _rig(n=220, frames=3)
    if side == "jax":
        jck.save_pu_seq(path, jpu.PUSeqDeformer.fit(rest, frames, patch_size=96))
    else:
        tck.save_pu_seq(path, tpu.PUSeqDeformer.fit(rest, frames, patch_size=96,
                                                     device="cpu"))


def _psd(side, path):
    rest, posed = _rig(n=20, frames=3)
    corr = 0.1 * np.random.default_rng(5).standard_normal((3, 60, 3)).astype(np.float32)
    if side == "jax":
        jck.save_psd(path, jpsd.PSDDeformer.fit(rest, posed, corr, normalize=True, align=True))
    else:
        tck.save_psd(path, tpsd.PSDDeformer.fit(rest, posed, corr, normalize=True, align=True,
                                                device="cpu"))


def _skin(side, path):
    pts, frames = _mesh_frames()
    edges = np.array([[0, 1], [1, 2], [2, 3]])
    if side == "jax":
        jck.save_skinning(path, *jsk.fit_skinning(pts, frames, n_bones=4, edges=edges))
    else:
        tck.save_skinning(path, *tsk.fit_skinning(pts, frames, n_bones=4, edges=edges,
                                                  device="cpu"))


def _shapes(side, path):
    pts, frames = _mesh_frames(f=5)
    if side == "jax":
        jck.save_blendshapes(path, *jbs.fit_blendshapes(pts, frames, rank=3))
    else:
        tck.save_blendshapes(path, *tbs.fit_blendshapes(pts, frames, rank=3, device="cpu"))


# kind -> (writer, loader name, kind() marker)
KINDS = {
    "dense": (_dense, "load", "dense"),
    "dense_lo": (lambda side, path: _dense(side, path, lo=True), "load", "dense"),
    "seq": (_seq, "load_seq", "seq"),
    "pu": (_pu, "load_pu", "pu"),
    "pu_seq": (_pu_seq, "load_pu_seq", "pu_seq"),
    "psd": (_psd, "load_psd", "psd"),
    "skin": (_skin, "load_skinning", "skin"),
    "shapes": (_shapes, "load_blendshapes", "shapes"),
}
LOADERS = sorted({v[1] for v in KINDS.values()})
SAVERS = {"load": "save", "load_seq": "save_seq", "load_pu": "save_pu",
          "load_pu_seq": "save_pu_seq", "load_psd": "save_psd",
          "load_skinning": "save_skinning", "load_blendshapes": "save_blendshapes"}


def _arr(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


_RBF = ("ctrl", "w_rbf", "w_poly", "eps", "w_rbf_lo", "w_poly_lo")
_PU = ("centers", "radii", "ctrl", "valid", "w_hi", "w_lo", "poly_hi", "poly_lo", "eps")
_PATCHES = ("centers", "radii", "idx", "counts", "spacing")
_REPORT = ("residual_norm", "rhs_norm", "scale_norm", "col_backward")


def _fields(prefix, obj, names):
    out = {}
    for n in names:
        v = getattr(obj, n, None) if obj is not None else None
        if v is not None:
            out[f"{prefix}.{n}"] = _arr(v)
    return out


def _leaves(kind, obj):
    """{name: array} of every array a loaded artifact of `kind` holds."""
    if kind in ("dense", "dense_lo"):
        return {**_fields("model", obj.model, _RBF), **_fields("report", obj.report, _REPORT)}
    if kind == "seq":
        return {**_fields("model", obj[0], _RBF), "residuals": _arr(obj[3])}
    if kind == "pu":
        return {**_fields("model", obj.model, _PU), **_fields("patches", obj.patches, _PATCHES),
                **_fields("report", obj.report, _REPORT)}
    if kind == "pu_seq":
        out = {**_fields("patches", obj.patches, _PATCHES),
               **_fields("report", obj.report, _REPORT)}
        for i, p in enumerate(obj.puds):
            out.update(_fields(f"model{i}", p.model, _PU))
        return out
    if kind == "psd":
        return {**_fields("model", obj.model, ("features", "alpha", "corrections", "eps")),
                **_fields("report", obj.report, _REPORT)}
    return _fields("model", obj[0], obj[0]._fields)     # skin, shapes


def _statics(obj):
    """The non-array state a loaded artifact carries, comparable across
    the packages (enums by value)."""
    if isinstance(obj, tuple) and not hasattr(obj, "_fields"):
        return tuple(_statics(o) for o in obj if not hasattr(o, "shape"))
    out = {}
    for k in ("cfg", "params", "kernel", "term", "auto_eps", "normalize", "align", "reduced"):
        if hasattr(obj, k):
            v = getattr(obj, k)
            out[k] = (repr(v.__dict__) if hasattr(v, "__dataclass_fields__")
                      else tuple(float(x) for x in v) if k == "params" else int(v))
    for k in ("rmse", "max_err", "bbox_diag", "weight_roughness", "energy"):
        if hasattr(obj, k):
            out[k] = getattr(obj, k)
    return out


@pytest.mark.parametrize("kind", list(KINDS))
def test_jax_writes_port_reads(tmp_path, kind):
    write, loader, marker = KINDS[kind]
    path = str(tmp_path / "a.npz")
    write("jax", path)
    assert tck.kind(path) == jck.kind(path) == marker
    got = getattr(tck, loader)(path, device="cpu")
    want = getattr(jck, loader)(path)
    gl, wl = _leaves(kind, got), _leaves(kind, want)
    assert sorted(gl) == sorted(wl)
    with np.load(path) as data:
        for name, a in gl.items():
            w = wl[name]
            assert a.dtype == w.dtype and np.array_equal(a, w), name
        for key in ("ctrl", "w_rbf", "weights", "corrections", "targets"):
            if key in data:
                assert any(a.shape == data[key].shape and np.array_equal(a, data[key])
                           for a in gl.values()), key
    if kind.startswith("dense") or kind == "seq":
        g_cfg = (got if kind != "seq" else got[1]).cfg if kind != "seq" else got[1]
        w_cfg = want.cfg if kind != "seq" else want[1]
        assert tck._cfg_to_json(g_cfg) == jck._cfg_to_json(w_cfg)
        g_par = got.params if kind != "seq" else got[2]
        w_par = want.params if kind != "seq" else want[2]
        assert tuple(g_par) == tuple(float(v) if i < 8 else v for i, v in enumerate(w_par))
    # the port's save of what it loaded is the JAX file, byte for byte
    again = str(tmp_path / "b.npz")
    saver = getattr(tck, SAVERS[loader])
    if kind == "seq":
        saver(again, *got)
    elif isinstance(got, tuple):
        saver(again, *got)
    else:
        saver(again, got)
    with open(path, "rb") as f, open(again, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_writes_jax_reads(tmp_path, kind):
    write, loader, marker = KINDS[kind]
    path = str(tmp_path / "a.npz")
    write("port", path)
    assert jck.kind(path) == tck.kind(path) == marker
    want = getattr(jck, loader)(path)
    got = getattr(tck, loader)(path, device="cpu")
    gl, wl = _leaves(kind, got), _leaves(kind, want)
    assert sorted(gl) == sorted(wl)
    for name, a in gl.items():
        if a.ndim:
            assert a.dtype == wl[name].dtype and np.array_equal(a, wl[name]), name
    assert _statics(got) == _statics(want)
    # the wrong loader raises the JAX package's words, on both sides
    for other in LOADERS:
        if other == loader:
            continue
        with pytest.raises(ValueError) as j_err:
            getattr(jck, other)(path)
        with pytest.raises(ValueError) as t_err:
            getattr(tck, other)(path, device="cpu")
        assert str(t_err.value) == str(j_err.value)


def test_a_reloaded_deformer_applies_the_same(tmp_path, rng):
    rest, pose = _rig()
    d = TDeformer.fit(rest, pose, tcfg.DeformConfig(model=2, kernel=1),
                      tcfg.DeformParams(radius=1.3, lam=0.02), device="cpu")
    path = str(tmp_path / "d")
    tck.save(path, d)
    back = tck.load(path, device="cpu")          # the .npz suffix is found
    assert back.cfg == d.cfg and back.params == d.params
    pts = rng.standard_normal((200, 3)).astype(np.float32)
    for backend in ("dense", "dense_precise"):
        a, wa = d.apply(pts, backend=backend)
        b, wb = back.apply(pts, backend=backend)
        assert torch.equal(a, b) and torch.equal(wa, wb)


def test_format_version_gate(tmp_path):
    path = str(tmp_path / "v.npz")
    _dense("port", path)
    with np.load(path) as data:
        fields = dict(data)
    fields["format_version"] = np.asarray(2)
    np.savez(path, **fields)
    with pytest.raises(ValueError) as j_err:
        jck.load(path)
    with pytest.raises(ValueError) as t_err:
        tck.load(path, device="cpu")
    assert str(t_err.value) == str(j_err.value)


def test_savers_reject_the_wrong_type(tmp_path):
    for name in ("save_pu", "save_pu_seq", "save_psd", "save_skinning", "save_blendshapes"):
        with pytest.raises(ValueError) as j_err:
            getattr(jck, name)(str(tmp_path / "x.npz"), object())
        with pytest.raises(ValueError) as t_err:
            getattr(tck, name)(str(tmp_path / "x.npz"), object())
        assert str(t_err.value) == str(j_err.value)


def test_orbax_entry_points_raise(tmp_path):
    rest, pose = _rig()
    d = TDeformer.fit(rest, pose, device="cpu")
    with pytest.raises(NotImplementedError, match=r"save\(\)/load\(\)"):
        tck.save_orbax(str(tmp_path / "o"), d)
    with pytest.raises(NotImplementedError, match=r"save\(\)/load\(\)"):
        tck.load_orbax(str(tmp_path / "o"))
