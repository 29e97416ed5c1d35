"""Configuration surface: the PyTorch port of facedeform_tpu/config.py.

Same enums, fields, defaults and clamps as the JAX package, so a config
built there carries over field for field (convert.config_from_fields).
PyTorch runs eagerly, so nothing here keys a compile cache; solve_view and
eval_view stay because callers and the JAX package's semantics use them to
say which fields a stage reads.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple


class RBFModelType(enum.IntEnum):
    """RBF algorithm family (QNN / MULTILAYER mirror the reference's two
    ALGLIB algorithms; KERNEL is the explicit kernel-zoo mode)."""

    QNN = 0
    MULTILAYER = 1
    KERNEL = 2


class PolyTerm(enum.IntEnum):
    """Polynomial tail appended to the RBF system."""

    LINEAR = 0    # 1, x, y, z  (4 extra rows/cols)
    CONSTANT = 1  # 1            (1 extra row/col)
    ZERO = 2      # none


class RBFKernel(enum.IntEnum):
    """Radial basis function zoo (phi of r/eps)."""

    GAUSSIAN = 0              # exp(-(r/eps)^2)
    THIN_PLATE = 1            # (r/eps)^2 log(r/eps)
    MULTIQUADRIC = 2          # sqrt(1 + (r/eps)^2)
    INVERSE_MULTIQUADRIC = 3  # 1/sqrt(1 + (r/eps)^2)
    LINEAR = 4                # r/eps
    CUBIC = 5                 # (r/eps)^3
    WENDLAND_C2 = 6           # (1-r/eps)^4_+ (4 r/eps + 1), compact support


@dataclasses.dataclass(frozen=True)
class DeformConfig:
    """Structure-affecting configuration (see facedeform_tpu.config for the
    per-field provenance in the reference node)."""

    model: RBFModelType = RBFModelType.QNN
    kernel: RBFKernel = RBFKernel.GAUSSIAN   # used when model == KERNEL
    term: PolyTerm = PolyTerm.LINEAR
    layers: int = 4                          # multilayer layer count
    tangent: bool = False                    # project to tangent plane
    morphspace: bool = False                 # DBSE blendshape projection
    doclampweight: bool = False              # clamp per-shape weights
    dofalloff: bool = False                  # real capture distances
    falloff_metric: str = "euclidean"
    # keep the reference's d2 quirks (uncaptured = 0, d2 = -1 amplifies)
    strict_parity: bool = False
    n_refine: int = 2                        # refinement sweeps of the solve
    dbse_lstsq: bool = True
    dbse_robust: bool = False
    solver: str = "auto"

    def __post_init__(self):
        object.__setattr__(self, "model", RBFModelType(self.model))
        object.__setattr__(self, "kernel", RBFKernel(self.kernel))
        object.__setattr__(self, "term", PolyTerm(self.term))
        if self.layers < 1:
            object.__setattr__(self, "layers", 1)
        if self.solver not in ("auto", "direct", "krylov", "pu"):
            raise ValueError(
                "solver must be 'auto', 'direct', 'krylov' or 'pu', "
                f"got {self.solver!r}"
            )
        if self.falloff_metric not in ("euclidean", "geodesic"):
            raise ValueError(
                "falloff_metric must be 'euclidean' or 'geodesic', "
                f"got {self.falloff_metric!r}"
            )

    @property
    def n_poly(self) -> int:
        """Number of polynomial tail basis functions."""
        return {PolyTerm.LINEAR: 4, PolyTerm.CONSTANT: 1, PolyTerm.ZERO: 0}[self.term]

    def solve_view(self) -> "DeformConfig":
        """This config reduced to the fields the RBF solve consumes."""
        return dataclasses.replace(
            self, tangent=False, morphspace=False, dofalloff=False,
            doclampweight=False, strict_parity=False, dbse_lstsq=True,
            dbse_robust=False, falloff_metric="euclidean",
        )

    def eval_view(self) -> "DeformConfig":
        """Reduced to the fields the eval path consumes."""
        return dataclasses.replace(
            self, morphspace=False, dofalloff=False, doclampweight=False,
            dbse_lstsq=True, dbse_robust=False, solver="auto", n_refine=2,
            falloff_metric="euclidean",
        )

    @property
    def n_layers(self) -> int:
        """Number of solve layers (1 unless MULTILAYER)."""
        return self.layers if self.model == RBFModelType.MULTILAYER else 1


class DeformParams(NamedTuple):
    """Continuous knobs, plain Python floats (reference cook-time reads)."""

    qcoef: float = 1.0          # QNN smoothness q, clamp >= 0.1
    zcoef: float = 5.0          # QNN deviation z, clamp >= 0.1
    radius: float = 1.0         # RBF base radius AND deform cutoff, >= 0.01
    lam: float = 0.1            # multilayer regularization, >= 0.01
    falloffrate: float = 1.0    # falloff exponent, >= 0
    falloffradius: float = 1.0  # morph-space-only residual scale
    weight_lo: float = 0.0      # blendshape weight clamp range
    weight_hi: float = 1.0
    maxedges: int = 4           # capture flood-fill rings (host-side)

    def clamped(self) -> "DeformParams":
        """Apply the reference's cook-time clamps; maxedges is clamped at
        its point of use, as in the JAX package."""
        return self._replace(
            qcoef=max(float(self.qcoef), 0.1),
            zcoef=max(float(self.zcoef), 0.1),
            radius=max(float(self.radius), 0.01),
            lam=max(float(self.lam), 0.01),
            falloffrate=max(float(self.falloffrate), 0.0),
        )
