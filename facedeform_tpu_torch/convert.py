"""Carry models and configs across from the JAX package.

A JAX-fitted model, including the low words of growing-kernel fits,
evaluates in the port after

    model = model_from_numpy({f: np.asarray(getattr(jax_model, f))
                              for f in jax_model._fields
                              if getattr(jax_model, f) is not None}, device)
    cfg = config_from_fields(dataclasses.asdict(jax_cfg))
    params = params_from_fields(jax_params._asdict())

A frames-stacked model of parallel.batched.fit_frames (w_rbf (F, L, N, 3),
w_poly (F, m, 3), with the lo words of the per-pose route or without them,
as the shared-factorization route returns it) carries over the same way.
A partition-of-unity model and its patches carry over the same way:

    model = pu_model_from_numpy({f: np.asarray(getattr(jax_model, f))
                                 for f in jax_model._fields}, device)
    patches = pu_patches_from_numpy(jax_patches._asdict())

Host geometry, a DBSE basis, a blendshape bake, a capture result, a
pose-space (PSD) model and a skinning decomposition carry over the same way
(mesh_from_fields, dbse_model_from_numpy, blendshape_model_from_numpy,
capture_result_from_numpy, psd_model_from_numpy,
skinning_model_from_numpy), so both packages compute from the same state
(a PSDDeformer wraps the model for cook(psd=...)); utils/checkpoint.py
loads every model kind through these converters:

    mesh = mesh_from_fields(dataclasses.asdict(jax_mesh))
    dbse = dbse_model_from_numpy({f: np.asarray(getattr(jax_dbse, f))
                                  for f in jax_dbse._fields}, device)

The inputs are plain numpy arrays and dicts, so this module needs no JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from facedeform_tpu_torch.capture.capture import CaptureResult
from facedeform_tpu_torch.config import DeformConfig, DeformParams
from facedeform_tpu_torch.geometry.mesh import Mesh
from facedeform_tpu_torch.ops.blendshapes import BlendshapeModel
from facedeform_tpu_torch.ops.dbse import DBSEModel
from facedeform_tpu_torch.ops.fit import RBFModel
from facedeform_tpu_torch.ops.psd import PSDModel
from facedeform_tpu_torch.ops.pu import PUModel, PUPatches
from facedeform_tpu_torch.ops.skinning import SkinningModel


def model_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> RBFModel:
    """RBFModel from {field: array} (the JAX RBFModel's field names);
    w_rbf_lo / w_poly_lo may be missing or None."""
    return RBFModel(**{
        f: None if a is None else torch.tensor(np.asarray(a, np.float32), device=device)
        for f, a in arrays.items()
    })


def config_from_fields(fields: Mapping[str, Any]) -> DeformConfig:
    """DeformConfig from dataclasses.asdict(jax DeformConfig); enums are
    carried by value."""
    return DeformConfig(**fields)


def params_from_fields(fields: Mapping[str, Any]) -> DeformParams:
    """DeformParams from jax DeformParams._asdict(); 0-d arrays become
    Python numbers."""
    return DeformParams(**{
        k: v if isinstance(v, (int, float)) else np.asarray(v).item()
        for k, v in fields.items()
    })


def pu_model_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> PUModel:
    """PUModel from {field: array} (the JAX PUModel's field names), every
    array as float32 on `device`."""
    return PUModel(**{
        f: torch.tensor(np.asarray(arrays[f], np.float32), device=device)
        for f in PUModel._fields
    })


def pu_patches_from_numpy(arrays: Mapping[str, np.ndarray]) -> PUPatches:
    """PUPatches (host numpy) from {field: array} (the JAX PUPatches')."""
    dtypes = {"idx": np.int32, "counts": np.int32}
    return PUPatches(**{
        f: np.ascontiguousarray(arrays[f], dtypes.get(f, np.float32))
        for f in PUPatches._fields
    })


def mesh_from_fields(fields: Mapping[str, Any]) -> Mesh:
    """Mesh from dataclasses.asdict(jax Mesh) (or any mapping of its public
    fields): points, faces, point/detail attributes, groups and typeinfo,
    copied.  The data ids are the port's own, fresh."""
    def arrays(name):
        return {k: np.array(v, copy=True) for k, v in (fields.get(name) or {}).items()}

    faces = fields.get("faces")
    return Mesh(
        points=np.array(fields["points"], np.float32, copy=True),
        faces=None if faces is None else np.array(faces, np.int32, copy=True),
        point_attrs=arrays("point_attrs"),
        detail_attrs=arrays("detail_attrs"),
        point_groups=arrays("point_groups"),
        attr_typeinfo=dict(fields.get("attr_typeinfo") or {}),
    )


def dbse_model_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> DBSEModel:
    """DBSEModel from {field: array} (the JAX DBSEModel's: deltas,
    packed_qr), float32 on `device`."""
    return DBSEModel(**{
        f: torch.tensor(np.asarray(arrays[f], np.float32), device=device)
        for f in DBSEModel._fields
    })


def blendshape_model_from_numpy(arrays: Mapping[str, np.ndarray],
                                device="cuda") -> BlendshapeModel:
    """BlendshapeModel from {field: array} (the JAX BlendshapeModel's:
    rest, targets, weights), float32 on `device`."""
    return BlendshapeModel(**{
        f: torch.tensor(np.asarray(arrays[f], np.float32), device=device)
        for f in BlendshapeModel._fields
    })


def capture_result_from_numpy(fields: Mapping[str, Any]) -> CaptureResult:
    """CaptureResult (host numpy) from dataclasses.asdict(jax CaptureResult)."""
    return CaptureResult(
        captured=np.array(fields["captured"], bool, copy=True),
        dist2=np.array(fields["dist2"], np.float32, copy=True),
        islands={int(k): np.array(v, bool, copy=True)
                 for k, v in fields["islands"].items()},
        color=np.array(fields["color"], np.float32, copy=True),
        seed_vertices=np.array(fields["seed_vertices"], np.int64, copy=True),
    )


def psd_model_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> PSDModel:
    """PSDModel from {field: array} (the JAX PSDModel's: features, alpha,
    corrections, eps), float32 on `device`."""
    return PSDModel(**{
        f: torch.tensor(np.asarray(arrays[f], np.float32), device=device)
        for f in PSDModel._fields
    })


def skinning_model_from_numpy(arrays: Mapping[str, np.ndarray],
                              device="cuda") -> SkinningModel:
    """SkinningModel from {field: array} (the JAX SkinningModel's: weights,
    rotations, translations, rest), float32 on `device`."""
    return SkinningModel(**{
        f: torch.tensor(np.asarray(arrays[f], np.float32), device=device)
        for f in SkinningModel._fields
    })
