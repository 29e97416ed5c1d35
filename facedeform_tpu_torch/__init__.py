"""facedeform-tpu on PyTorch and CUDA: the port of facedeform_tpu to one
NVIDIA H100.

Same math and public names as the JAX package (which stays the reference):
  DeformConfig / DeformParams  — the node's parameter surface
  Deformer                     — fit(rest_rig, deformed_rig, device=...)
                                 -> apply(points), jacobian(points),
                                 transform_attrs(points, attrs, weight)
  parallel.batched             — the animated shot: fit_frames ->
                                 apply_frames -> transport_frames
  ops.temporal                 — Savitzky-Golay rig smoothing of a shot
The GPU kernels (dense, culled and frames eval, Jacobian, and the float64
precise eval of the growing kernels) are CUDA C++ in csrc/, compiled for
sm_90a at first use (ops/cuda_eval.py); importing the package builds
nothing and imports no JAX.
"""

from facedeform_tpu_torch.config import (
    DeformConfig,
    DeformParams,
    PolyTerm,
    RBFKernel,
    RBFModelType,
)
from facedeform_tpu_torch.deformer import Deformer
from facedeform_tpu_torch.ops.fit import RBFModel
from facedeform_tpu_torch.ops.solve import SolveReport

__all__ = [
    "DeformConfig",
    "DeformParams",
    "Deformer",
    "PolyTerm",
    "RBFKernel",
    "RBFModel",
    "RBFModelType",
    "SolveReport",
]
