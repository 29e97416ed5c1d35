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

The inputs are plain numpy arrays and dicts, so this module needs no JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from facedeform_tpu_torch.config import DeformConfig, DeformParams
from facedeform_tpu_torch.ops.fit import RBFModel
from facedeform_tpu_torch.ops.pu import PUModel, PUPatches


def model_from_numpy(arrays: Mapping[str, np.ndarray], device="cpu") -> RBFModel:
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


def pu_model_from_numpy(arrays: Mapping[str, np.ndarray], device="cpu") -> PUModel:
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
