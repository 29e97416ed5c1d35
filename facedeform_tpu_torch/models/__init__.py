"""Model families (port of facedeform_tpu/models): thin typed fronts over
Deformer.fit, one per family of the reference's menu plus the kernel zoo
and the partition-of-unity rigs.

    QNNDeformModel        - adaptive per-point-radius gaussians, exact
                            interpolation
    MultilayerDeformModel - coarse-to-fine residual-fitted gaussian layers
    KernelZooDeformModel  - a chosen basis with a global radius and ridge
    PartitionOfUnityModel - overlapping patches solved apart and blended
                            (ops.pu.PUDeformer)

Each front fits on its `device` ("cuda" unless the caller asks for the
CPU).  Use Deformer directly for the full falloff/tangent/group pipeline.
"""

from __future__ import annotations

import dataclasses

from facedeform_tpu_torch.config import (
    DeformConfig, DeformParams, PolyTerm, RBFKernel, RBFModelType,
)
from facedeform_tpu_torch.deformer import Deformer


@dataclasses.dataclass(frozen=True)
class _DeformModelBase:
    """Shared fit plumbing of the model families."""

    term: PolyTerm = PolyTerm.LINEAR
    device: str = "cuda"

    def _config(self) -> DeformConfig:
        raise NotImplementedError

    def _params(self) -> DeformParams:
        return DeformParams()

    def fit(self, rest_ctrl, deformed_ctrl) -> Deformer:
        """Solve rest -> deformed control displacement; returns a Deformer."""
        return Deformer.fit(rest_ctrl, deformed_ctrl, self._config(), self._params(),
                            device=self.device)


@dataclasses.dataclass(frozen=True)
class QNNDeformModel(_DeformModelBase):
    """Exact-interpolating gaussians with per-point adaptive radii: qcoef
    scales each basis to its local point spacing, zcoef caps how far an
    isolated marker reaches."""

    qcoef: float = 1.0
    zcoef: float = 5.0

    def _config(self) -> DeformConfig:
        return DeformConfig(model=RBFModelType.QNN, term=self.term)

    def _params(self) -> DeformParams:
        return DeformParams(qcoef=self.qcoef, zcoef=self.zcoef)


@dataclasses.dataclass(frozen=True)
class MultilayerDeformModel(_DeformModelBase):
    """Coarse-to-fine gaussian layers with ridge regularization: radius is
    the first layer's scale, halving per layer; lam is the ridge."""

    radius: float = 1.0
    layers: int = 4
    lam: float = 0.1

    def _config(self) -> DeformConfig:
        return DeformConfig(model=RBFModelType.MULTILAYER, layers=self.layers, term=self.term)

    def _params(self) -> DeformParams:
        return DeformParams(radius=self.radius, lam=self.lam)


@dataclasses.dataclass(frozen=True)
class KernelZooDeformModel(_DeformModelBase):
    """An explicit basis with a global radius and ridge."""

    kernel: RBFKernel = RBFKernel.GAUSSIAN
    radius: float = 1.0
    lam: float = 0.01

    def _config(self) -> DeformConfig:
        return DeformConfig(model=RBFModelType.KERNEL, kernel=self.kernel, term=self.term)

    def _params(self) -> DeformParams:
        return DeformParams(radius=self.radius, lam=self.lam)


@dataclasses.dataclass(frozen=True)
class PartitionOfUnityModel(_DeformModelBase):
    """Any-N rigs: overlapping kd-cell patches, dense float64 solves,
    Wendland-blended eval.  fit() returns an ops.pu.PUDeformer
    (displacement-only surface)."""

    kernel: RBFKernel = RBFKernel.THIN_PLATE
    eps: object = "auto"     # per-patch shape parameter, or a float
    lam: float = 0.01
    patch_size: int = 192
    overlap: float = 1.3

    def fit(self, rest_ctrl, deformed_ctrl):
        from facedeform_tpu_torch.ops.pu import PUDeformer

        return PUDeformer.fit(
            rest_ctrl, deformed_ctrl, kernel=self.kernel, term=self.term,
            eps=self.eps, lam=self.lam, patch_size=self.patch_size,
            overlap=self.overlap, device=self.device,
        )


__all__ = [
    "QNNDeformModel",
    "MultilayerDeformModel",
    "KernelZooDeformModel",
    "PartitionOfUnityModel",
]
