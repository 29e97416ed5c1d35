"""Deformer checkpoint/resume: solve once, evaluate across sessions (port of
facedeform_tpu/utils/checkpoint.py).

One .npz file per artifact, the JAX package's format: the same keys,
dtypes, `format_version` and `cfg_json`, so a file written by either
package loads in the other.  Loaders build the port's types with float32
tensors on `device` ("cuda" by default), through the converters of
convert.py.

The JAX package's orbax directory format (save_orbax/load_orbax) needs
orbax, which imports JAX: here those entry points raise, naming save()/
load(), which carry the same fields and which both packages read.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from facedeform_tpu_torch.config import DeformConfig, DeformParams
from facedeform_tpu_torch.deformer import Deformer
from facedeform_tpu_torch.ops.fit import RBFModel
from facedeform_tpu_torch.ops.solve import SolveReport

_FORMAT_VERSION = 1


#: marker -> (loader name, human label), in kind()'s dispatch priority
#: (a pu_seq file also carries dense-seq arrays, so pu_seq outranks seq)
_KINDS = {
    "pu_seq": ("load_pu_seq", "PU sequence"),
    "seq": ("load_seq", "dense sequence"),
    "pu": ("load_pu", "PU"),
    "psd": ("load_psd", "PSD"),
    "skin": ("load_skinning", "skinning"),
    "shapes": ("load_blendshapes", "blendshape"),
}


def _np(a) -> np.ndarray:
    """Host numpy of a tensor (any device) or array, dtype kept."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _scalar(a, device) -> torch.Tensor:
    return torch.tensor(float(a), device=device)


def _open_checkpoint(path: str, expect: str | None):
    """Shared load_* front door: .npz path fallback, kind dispatch and the
    format-version gate.  `expect` is the marker key the calling loader
    owns (None = the dense Deformer checkpoint, which has no marker).
    Returns (open NpzFile, resolved path); wrong-kind errors name the
    right loader."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    data = np.load(path, allow_pickle=False)
    found = next((k for k in _KINDS if k in data), None)
    if found != expect:
        data.close()
        if expect is None:
            loader, label = _KINDS[found]
            raise ValueError(
                f"{path} is a {label} checkpoint (use {loader}())"
            )
        _, want_label = _KINDS[expect]
        if found is None:
            raise ValueError(
                f"{path} is not a {want_label} checkpoint (use load())"
            )
        loader, label = _KINDS[found]
        raise ValueError(
            f"{path} is not a {want_label} checkpoint (it is a {label} "
            f"checkpoint — use {loader}())"
        )
    version = int(data["format_version"])
    if version > _FORMAT_VERSION:
        data.close()
        raise ValueError(
            f"checkpoint format {version} is newer than supported"
        )
    return data, path


def _cfg_to_json(cfg: DeformConfig) -> str:
    d = dataclasses.asdict(cfg)
    for k in ("model", "kernel", "term"):
        d[k] = int(d[k])
    return json.dumps(d)


def _cfg_from_json(s: str) -> DeformConfig:
    return DeformConfig(**json.loads(s))


def _params_array(params: DeformParams) -> np.ndarray:
    return np.asarray([float(v) for v in params[:8]], np.float64)


def _params_from(data) -> DeformParams:
    pvals = data["params"]
    return DeformParams(
        qcoef=float(pvals[0]), zcoef=float(pvals[1]), radius=float(pvals[2]),
        lam=float(pvals[3]), falloffrate=float(pvals[4]),
        falloffradius=float(pvals[5]), weight_lo=float(pvals[6]),
        weight_hi=float(pvals[7]), maxedges=int(data["maxedges"]),
    )


def save(path: str, deformer: Deformer) -> None:
    """Serialize a solved Deformer to one .npz file."""
    params = deformer.params
    model = deformer.model
    extra = {}
    if model.w_rbf_lo is not None:
        # the growing kernels' low weight words round-trip too
        extra["w_rbf_lo"] = _np(model.w_rbf_lo)
        extra["w_poly_lo"] = _np(model.w_poly_lo)
    np.savez(
        path,
        format_version=_FORMAT_VERSION,
        cfg_json=_cfg_to_json(deformer.cfg),
        params=_params_array(params),
        maxedges=int(params.maxedges),
        ctrl=_np(model.ctrl),
        w_rbf=_np(model.w_rbf),
        w_poly=_np(model.w_poly),
        eps=_np(model.eps),
        residual_norm=float(deformer.report.residual_norm),
        rhs_norm=float(deformer.report.rhs_norm),
        # reduced-basis regression marker (decimate.fit_reduced): keeps
        # the node's control-count-mismatch warning suppressed on resume
        reduced=int(getattr(deformer, "reduced", False)),
        **extra,
    )


def kind(path: str) -> str:
    """Checkpoint kind marker: 'dense' | 'pu' | 'seq' | 'pu_seq' | 'psd'
    | 'skin' | 'shapes'.  Each load_* still validates the marker itself."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        for k in _KINDS:
            if k in data:
                return k
    return "dense"


def load(path: str, device="cuda") -> Deformer:
    """Restore a Deformer saved by save() on `device`; ready for apply()."""
    from facedeform_tpu_torch.convert import model_from_numpy

    data, path = _open_checkpoint(path, None)
    with data:
        model = model_from_numpy({
            f: data[f] if f in data else None
            for f in ("ctrl", "w_rbf", "w_poly", "eps", "w_rbf_lo", "w_poly_lo")
        }, device)
        report = SolveReport(
            residual_norm=_scalar(data["residual_norm"], device),
            rhs_norm=_scalar(data["rhs_norm"], device),
        )
        return Deformer(model=model, cfg=_cfg_from_json(str(data["cfg_json"])),
                        params=_params_from(data), report=report,
                        reduced=bool(data["reduced"]) if "reduced" in data else False)


def _no_orbax(name: str):
    raise NotImplementedError(
        f"{name}: the orbax directory format needs orbax, which imports JAX; "
        "use save()/load() (.npz), which carry the same fields and which "
        "both packages read"
    )


def save_orbax(path: str, deformer: Deformer) -> None:
    """Not available in the port (orbax imports JAX): use save()."""
    _no_orbax("save_orbax")


def load_orbax(path: str, device="cuda") -> Deformer:
    """Not available in the port (orbax imports JAX): use load()."""
    _no_orbax("load_orbax")


# ------------------------------------------------------------- sequences
def save_seq(path: str, model: RBFModel, cfg: DeformConfig,
             params: DeformParams, residuals=None) -> None:
    """Serialize an F-stacked fit_frames model (parallel/batched.fit_frames)
    to one .npz: w_rbf carries the (F, L, N, 3) frame axis, ctrl/eps are
    frame-invariant."""
    params = params.clamped()
    f_n = int(model.w_rbf.shape[0])
    np.savez(
        path,
        format_version=_FORMAT_VERSION,
        seq=f_n,
        cfg_json=_cfg_to_json(cfg),
        params=_params_array(params),
        maxedges=int(params.maxedges),
        ctrl=_np(model.ctrl),
        w_rbf=_np(model.w_rbf),
        w_poly=_np(model.w_poly),
        eps=_np(model.eps),
        residuals=(
            np.zeros(f_n, np.float32) if residuals is None
            else np.asarray(_np(residuals), np.float32)
        ),
    )


def load_seq(path: str, device="cuda"):
    """Restore (model, cfg, params, residuals) saved by save_seq(); the
    model feeds parallel/batched.apply_frames directly."""
    from facedeform_tpu_torch.convert import model_from_numpy

    data, path = _open_checkpoint(path, "seq")
    with data:
        model = model_from_numpy({f: data[f] for f in ("ctrl", "w_rbf", "w_poly", "eps")},
                                 device)
        return (model, _cfg_from_json(str(data["cfg_json"])), _params_from(data),
                np.asarray(data["residuals"]))


def _pu_patches(data):
    from facedeform_tpu_torch.convert import pu_patches_from_numpy

    return pu_patches_from_numpy({
        "centers": data["centers"], "radii": data["radii"], "idx": data["p_idx"],
        "counts": data["p_counts"], "spacing": data["p_spacing"],
    })


def _pu_report(data, device) -> SolveReport:
    return SolveReport(
        residual_norm=_scalar(data["residual_norm"], device),
        rhs_norm=_scalar(data["rhs_norm"], device),
        scale_norm=_scalar(data["scale_norm"], device),
        cond_est=None,
        col_backward=torch.as_tensor(data["col_backward"], device=device),
    )


def save_pu_seq(path: str, seq) -> None:
    """Serialize a PUSeqDeformer (ops/pu.py) to one .npz: the shared
    static fields once, the (F, K, P, 3) weight and (F, K, m, 3) tail
    stacks with the frame axis."""
    from facedeform_tpu_torch.ops.pu import PUSeqDeformer

    if not isinstance(seq, PUSeqDeformer):
        raise ValueError(
            f"save_pu_seq expects a PUSeqDeformer, got {type(seq).__name__}"
        )
    models = [p.model for p in seq.puds]
    m, p = models[0], seq.patches
    rep = getattr(seq, "report", None)
    extra = {} if rep is None else dict(
        residual_norm=float(rep.residual_norm),
        rhs_norm=float(rep.rhs_norm),
        scale_norm=float(rep.scale_norm),
        col_backward=_np(rep.col_backward),
    )
    np.savez(
        path,
        format_version=_FORMAT_VERSION,
        pu_seq=len(models),
        kernel=int(seq.kernel),
        term=int(seq.term),
        auto_eps=int(seq.auto_eps),
        centers=_np(m.centers), radii=_np(m.radii),
        ctrl=_np(m.ctrl), valid=_np(m.valid),
        eps=_np(m.eps),
        w_hi=np.stack([_np(mm.w_hi) for mm in models]),
        w_lo=np.stack([_np(mm.w_lo) for mm in models]),
        poly_hi=np.stack([_np(mm.poly_hi) for mm in models]),
        poly_lo=np.stack([_np(mm.poly_lo) for mm in models]),
        p_idx=p.idx, p_counts=p.counts, p_spacing=p.spacing,
        **extra,
    )


def load_pu_seq(path: str, device="cuda"):
    """Restore a PUSeqDeformer saved by save_pu_seq(); the frames share
    one eval plan as a fresh fit's do."""
    from facedeform_tpu_torch.config import PolyTerm, RBFKernel
    from facedeform_tpu_torch.convert import pu_model_from_numpy
    from facedeform_tpu_torch.ops.pu import PUSeqDeformer

    data, path = _open_checkpoint(path, "pu_seq")
    with data:
        shared = {f: data[f] for f in ("centers", "radii", "ctrl", "valid", "eps")}
        stacks = {f: data[f] for f in ("w_hi", "w_lo", "poly_hi", "poly_lo")}
        models = [pu_model_from_numpy({**shared, **{f: a[i] for f, a in stacks.items()}},
                                      device)
                  for i in range(int(data["pu_seq"]))]
        seq = PUSeqDeformer(models, _pu_patches(data), RBFKernel(int(data["kernel"])),
                            PolyTerm(int(data["term"])), auto_eps=bool(int(data["auto_eps"])))
        if "residual_norm" in data:   # absent for report-less constructions
            seq.report = _pu_report(data, device)
    return seq


# -------------------------------------------------------------------- PU
def save_pu(path: str, pud) -> None:
    """Serialize a PUDeformer (ops/pu.py) to one .npz file: the fitted
    PUModel arrays, the host patch geometry (eval plans are rebuilt from
    it), the kernel/term/auto_eps statics and the aggregated report."""
    from facedeform_tpu_torch.ops.pu import PUDeformer

    if not isinstance(pud, PUDeformer):
        raise ValueError(
            f"save_pu expects a PUDeformer, got {type(pud).__name__} "
            "(use save() for global-RBF Deformers)"
        )
    m, p = pud.model, pud.patches
    np.savez(
        path,
        format_version=_FORMAT_VERSION,
        pu=1,
        kernel=int(pud.kernel),
        term=int(pud.term),
        auto_eps=int(pud.auto_eps),
        centers=_np(m.centers), radii=_np(m.radii),
        ctrl=_np(m.ctrl), valid=_np(m.valid),
        w_hi=_np(m.w_hi), w_lo=_np(m.w_lo),
        poly_hi=_np(m.poly_hi), poly_lo=_np(m.poly_lo),
        eps=_np(m.eps),
        p_idx=p.idx, p_counts=p.counts, p_spacing=p.spacing,
        residual_norm=float(pud.report.residual_norm),
        rhs_norm=float(pud.report.rhs_norm),
        scale_norm=float(pud.report.scale_norm),
        col_backward=_np(pud.report.col_backward),
    )


def load_pu(path: str, device="cuda"):
    """Restore a PUDeformer saved by save_pu() on `device`."""
    from facedeform_tpu_torch.config import PolyTerm, RBFKernel
    from facedeform_tpu_torch.convert import pu_model_from_numpy
    from facedeform_tpu_torch.ops.pu import PUDeformer

    data, path = _open_checkpoint(path, "pu")
    with data:
        pud = PUDeformer(pu_model_from_numpy(data, device), _pu_patches(data),
                         RBFKernel(int(data["kernel"])), PolyTerm(int(data["term"])),
                         auto_eps=bool(int(data["auto_eps"])))
        pud.report = _pu_report(data, device)
    return pud


def save_psd(path: str, psd) -> None:
    """Serialize a PSDDeformer (ops/psd.py) to one .npz file: the
    pose-space model (features/alpha/corrections/eps), the kernel,
    normalize and align knobs, and the solve report."""
    from facedeform_tpu_torch.ops.psd import PSDDeformer

    if not isinstance(psd, PSDDeformer):
        raise ValueError(
            f"save_psd expects a PSDDeformer, got {type(psd).__name__}"
        )
    m = psd.model
    rep = psd.report
    extra = {}
    if rep is not None:
        extra["residual_norm"] = float(rep.residual_norm)
        extra["rhs_norm"] = float(rep.rhs_norm)
        if rep.scale_norm is not None:
            extra["scale_norm"] = float(rep.scale_norm)
    np.savez(
        path,
        format_version=_FORMAT_VERSION,
        psd=1,
        kernel=int(psd.kernel),
        normalize=int(bool(psd.normalize)),
        align=int(bool(psd.align)),
        features=_np(m.features),
        alpha=_np(m.alpha),
        corrections=_np(m.corrections),
        psd_eps=_np(m.eps),
        **extra,
    )


def load_psd(path: str, device="cuda"):
    """Restore a PSDDeformer saved by save_psd() on `device`."""
    from facedeform_tpu_torch.config import RBFKernel
    from facedeform_tpu_torch.convert import psd_model_from_numpy
    from facedeform_tpu_torch.ops.psd import PSDDeformer

    data, path = _open_checkpoint(path, "psd")
    with data:
        model = psd_model_from_numpy({
            "features": data["features"], "alpha": data["alpha"],
            "corrections": data["corrections"], "eps": data["psd_eps"],
        }, device)
        report = None
        if "residual_norm" in data:
            report = SolveReport(
                residual_norm=_scalar(data["residual_norm"], device),
                rhs_norm=_scalar(data["rhs_norm"], device),
                scale_norm=(_scalar(data["scale_norm"], device)
                            if "scale_norm" in data else None),
            )
        return PSDDeformer(
            model, RBFKernel(int(data["kernel"])),
            normalize=bool(int(data["normalize"])), report=report,
            align=bool(int(data["align"])) if "align" in data else False,
        )


def save_skinning(path: str, model, report=None) -> None:
    """Serialize a SkinningModel (ops/skinning.py) to one .npz file: the
    (V, B) weights, the per-training-pose bone transforms, the rest
    positions, and the report when given."""
    from facedeform_tpu_torch.ops.skinning import SkinningModel

    if not isinstance(model, SkinningModel):
        raise ValueError(
            f"save_skinning expects a SkinningModel, got {type(model).__name__}"
        )
    extra = {}
    if report is not None:
        extra["rmse"] = float(report.rmse)
        extra["max_err"] = float(report.max_err)
        extra["bbox_diag"] = float(report.bbox_diag)
        if report.weight_roughness is not None:
            extra["weight_roughness"] = float(report.weight_roughness)
    np.savez(
        path,
        format_version=_FORMAT_VERSION,
        skin=1,
        weights=_np(model.weights),
        rotations=_np(model.rotations),
        translations=_np(model.translations),
        rest=_np(model.rest),
        **extra,
    )


def load_skinning(path: str, device="cuda"):
    """Restore (SkinningModel, SkinningReport | None) saved by
    save_skinning(), the model's tensors on `device`."""
    from facedeform_tpu_torch.convert import skinning_model_from_numpy
    from facedeform_tpu_torch.ops.skinning import SkinningReport

    data, path = _open_checkpoint(path, "skin")
    with data:
        model = skinning_model_from_numpy(data, device)
        report = None
        if "rmse" in data:
            report = SkinningReport(
                rmse=float(data["rmse"]),
                max_err=float(data["max_err"]),
                bbox_diag=float(data["bbox_diag"]),
                weight_roughness=(
                    float(data["weight_roughness"])
                    if "weight_roughness" in data else None
                ),
            )
    return model, report


def save_blendshapes(path: str, model, report=None) -> None:
    """Serialize a BlendshapeModel (ops/blendshapes.py) to one .npz file:
    rest positions, (K, V, 3) morph-target deltas and (F, K) weight
    curves, and the report when given."""
    from facedeform_tpu_torch.ops.blendshapes import BlendshapeModel

    if not isinstance(model, BlendshapeModel):
        raise ValueError(
            f"save_blendshapes expects a BlendshapeModel, got "
            f"{type(model).__name__}"
        )
    extra = {}
    if report is not None:
        extra["rmse"] = float(report.rmse)
        extra["max_err"] = float(report.max_err)
        extra["energy"] = float(report.energy)
        extra["singular_values"] = np.asarray(
            report.singular_values, np.float64
        )
    np.savez(
        path,
        format_version=_FORMAT_VERSION,
        shapes=1,
        rest=_np(model.rest),
        targets=_np(model.targets),
        weights_curves=_np(model.weights),
        **extra,
    )


def load_blendshapes(path: str, device="cuda"):
    """Restore (BlendshapeModel, BlendshapeReport | None) saved by
    save_blendshapes(), the model's tensors on `device`."""
    from facedeform_tpu_torch.convert import blendshape_model_from_numpy
    from facedeform_tpu_torch.ops.blendshapes import BlendshapeReport

    data, path = _open_checkpoint(path, "shapes")
    with data:
        model = blendshape_model_from_numpy({
            "rest": data["rest"], "targets": data["targets"],
            "weights": data["weights_curves"],
        }, device)
        report = None
        if "rmse" in data:
            report = BlendshapeReport(
                rmse=float(data["rmse"]),
                max_err=float(data["max_err"]),
                energy=float(data["energy"]),
                singular_values=np.asarray(data["singular_values"], np.float64),
            )
    return model, report
