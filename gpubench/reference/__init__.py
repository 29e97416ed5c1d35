"""The plain reference: the node's cook and the animated shot worked out
again, in plain PyTorch, from the inputs the benchmark made.

It imports neither JAX, nor facedeform_tpu, nor anything of
facedeform_tpu_torch, and reads nothing the program made: it recomputes the
capture (islands and distances), the falloff, the fit of each pose, the
eval, the DBSE weights, the morph and the transported normals.  A frozen
copy of the float64 oracle's formulas (tests/oracle.py) in torch, so it
runs on the card in blocks of rows.

Prec says in what precision it runs: JUDGE (float64 throughout) decides
`correct`; each control puts one stage one step below what a configuration
states for it.  A configuration names its reference family, a file here
(rbf_dbse.py) that builds the reference's outputs from these pieces.
"""

from gpubench.reference.prec import JUDGE, Prec, controls
from gpubench.reference.capture import capture_dist2, falloff
from gpubench.reference.rbf import KERNELS, Kernel, Model, evaluate, fit, transport_normals
from gpubench.reference.dbse import Blendshapes

__all__ = ["JUDGE", "Prec", "controls", "capture_dist2", "falloff", "KERNELS", "Kernel", "Model",
           "fit", "evaluate", "transport_normals", "Blendshapes"]
