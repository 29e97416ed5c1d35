"""facedeform-tpu on PyTorch and CUDA: the port of facedeform_tpu to one
NVIDIA H100.

Same math and public names as the JAX package (which stays the reference):
  DeformConfig / DeformParams  — the node's parameter surface
  Deformer                     — fit(rest_rig, deformed_rig, device=...)
                                 -> apply(points), jacobian(points),
                                 transform_attrs(points, attrs, weight);
                                 dense up to 8192 controls, matrix-free
                                 Krylov past it
  FitPlan                      — Deformer.fit_with_plan / FitPlan.prepare
                                 -> refit(pose): a new pose of the same
                                 rest rig at O(n^2) (the marker drag)
  models                       — QNN / Multilayer / KernelZoo /
                                 PartitionOfUnity fronts
  parallel.batched             — the animated shot: fit_frames ->
                                 apply_frames -> transport_frames
  ops.temporal                 — Savitzky-Golay rig smoothing of a shot
  ProximityCapture             — capture: islands around the markers and
                                 the capture distances apply(dist2=) reads
                                 (capture/; host geometry in geometry/ and
                                 native/, distances on the device)
  ops.dbse                     — morph-space (DBSE) weights and morph_apply
  ops.blendshapes              — bake a shot to morph targets
  ops.decimate, ops.loocv      — rig decimation (select_markers,
                                 reduce_rig, fit_reduced) and LOOCV
                                 radius selection (autotune, fit_auto)
  FaceDeformNode / CookResult  — the node's cook: capture -> solve (FitPlan
                                 refit on a drag) -> eval (dense/culled
                                 autotune) -> DBSE morph -> pose-space
                                 correction (ops.psd) -> attribute
                                 transport -> secondary meshes, with
                                 symmetry (ops.symmetry) and stage timing
                                 (utils.profiling)
  fit_rig / InverseRigResult   — inverse rig fitting: the rig pose that
                                 reproduces a target mesh (inverse.py)
  ops.skinning, geometry.gltf_io, utils.checkpoint, doctor, houdini
                               — the LBS skinning bake, glTF I/O, .npz
                                 checkpoints of every model kind, input
                                 linting and the Houdini Python SOP
The GPU kernels (dense, culled and frames eval, Jacobian, and the float64
precise eval of the growing kernels) are CUDA C++ in csrc/, compiled for
sm_90a at first use (ops/cuda_eval.py); importing the package builds
nothing and imports no JAX.
"""

from facedeform_tpu_torch.capture.capture import CaptureResult, ProximityCapture
from facedeform_tpu_torch.config import (
    DeformConfig,
    DeformParams,
    PolyTerm,
    RBFKernel,
    RBFModelType,
)
from facedeform_tpu_torch.deformer import Deformer, FitPlan
from facedeform_tpu_torch.geometry import Mesh, load_mesh, save_mesh
from facedeform_tpu_torch.inverse import InverseRigResult, fit_rig
from facedeform_tpu_torch.node import CookResult, FaceDeformNode
from facedeform_tpu_torch.models import (
    KernelZooDeformModel,
    MultilayerDeformModel,
    PartitionOfUnityModel,
    QNNDeformModel,
)
from facedeform_tpu_torch.ops.blendshapes import BlendshapeModel, fit_blendshapes
from facedeform_tpu_torch.ops.dbse import DBSEModel
from facedeform_tpu_torch.ops.fit import RBFModel
from facedeform_tpu_torch.ops.solve import SolveReport
from facedeform_tpu_torch.utils.errors import CaptureError

__all__ = [
    "BlendshapeModel",
    "CaptureError",
    "CaptureResult",
    "CookResult",
    "DBSEModel",
    "DeformConfig",
    "DeformParams",
    "Deformer",
    "FaceDeformNode",
    "FitPlan",
    "InverseRigResult",
    "KernelZooDeformModel",
    "Mesh",
    "MultilayerDeformModel",
    "PartitionOfUnityModel",
    "PolyTerm",
    "ProximityCapture",
    "QNNDeformModel",
    "RBFKernel",
    "RBFModel",
    "RBFModelType",
    "SolveReport",
    "fit_blendshapes",
    "fit_rig",
    "load_mesh",
    "save_mesh",
]
