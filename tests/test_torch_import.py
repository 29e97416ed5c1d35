"""PyTorch port: importing the package and every module of the port pulls
in no JAX and nothing of the JAX package, and builds nothing."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_import_loads_no_jax_and_builds_nothing(tmp_path):
    code = (
        "import sys, facedeform_tpu_torch\n"
        "import facedeform_tpu_torch.benchmark, facedeform_tpu_torch.convert\n"
        "import facedeform_tpu_torch.ops.cuda_eval as ce\n"
        "import facedeform_tpu_torch.ops.cuda_jacobian as cj\n"
        "import facedeform_tpu_torch.ops.jacobian, facedeform_tpu_torch.ops.temporal\n"
        "import facedeform_tpu_torch.parallel.batched\n"
        "import facedeform_tpu_torch.ops.cuda_precise as cp\n"
        "from facedeform_tpu_torch.utils.profiling import counter\n"
        "import facedeform_tpu_torch.ops.krylov, facedeform_tpu_torch.ops.precise_eval\n"
        "import facedeform_tpu_torch.ops.pu, facedeform_tpu_torch.ops.cuda_pu as cpu_\n"
        "import facedeform_tpu_torch.models\n"
        "from facedeform_tpu_torch import FitPlan, QNNDeformModel, ProximityCapture, Mesh\n"
        "import facedeform_tpu_torch.native as nat, facedeform_tpu_torch.capture.geodesic\n"
        "import facedeform_tpu_torch.ops.dbse, facedeform_tpu_torch.ops.blendshapes\n"
        "import facedeform_tpu_torch.ops.decimate, facedeform_tpu_torch.ops.loocv\n"
        "import facedeform_tpu_torch.ops.distances, facedeform_tpu_torch.geometry.geo_io\n"
        "import facedeform_tpu_torch.ops.skinning, facedeform_tpu_torch.geometry.gltf_io\n"
        "import facedeform_tpu_torch.utils.checkpoint, facedeform_tpu_torch.inverse\n"
        "import facedeform_tpu_torch.doctor, facedeform_tpu_torch.houdini\n"
        "from facedeform_tpu_torch import fit_rig, InverseRigResult\n"
        "assert nat._lib is None and not nat._tried\n"
        "jax = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'optax', 'orbax', 'facedeform_tpu')]\n"
        "assert not jax, jax\n"
        "from facedeform_tpu_torch.utils.profiling import counter\n"
        "assert ce._lib is None\n"
        "for k in ('evaluate_cuda', 'evaluate_cuda_culled', 'evaluate_cuda_frames',\n"
        "          'evaluate_cuda_precise', 'evaluate_cuda_diff', 'jacobian_cuda',\n"
        "          'jacobian_cuda_frames', 'evaluate_pu_tiles', 'evaluate_pu_tiles_frames'):\n"
        "    assert counter('launches.' + k) == 0, k\n"
    )
    build = REPO / "facedeform_tpu_torch" / "csrc" / "build"
    before = sorted(build.glob("*")) if build.exists() else []
    subprocess.run(
        [sys.executable, "-c", code], check=True, cwd=tmp_path,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"}, timeout=120,
    )
    after = sorted(build.glob("*")) if build.exists() else []
    assert after == before


def test_every_port_module_and_chip_smoke_load_no_jax(tmp_path):
    """Every module under facedeform_tpu_torch/ (found by walking the
    package, so a new module is covered) and chip_smoke.py import without
    JAX, optax, orbax or the JAX package; the precise kernel's counters
    start at 0."""
    code = (
        "import importlib.util, pkgutil, sys, facedeform_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "spec = importlib.util.spec_from_file_location(\n"
        f"    'chip_smoke', {str(REPO / 'chip_smoke.py')!r})\n"
        "smoke = importlib.util.module_from_spec(spec); spec.loader.exec_module(smoke)\n"
        "jax = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'optax', 'orbax', 'facedeform_tpu')]\n"
        "assert not jax, jax\n"
        "assert len(names) > 20, names\n"
        "new = {'ops.skinning', 'geometry.gltf_io', 'utils.checkpoint', 'inverse', 'doctor',\n"
        "       'houdini'}\n"
        "assert new <= {n.split('.', 1)[1] for n in names}, names\n"
        "import facedeform_tpu_torch.ops.cuda_precise as cp\n"
        "from facedeform_tpu_torch.utils.profiling import counter\n"
        "assert counter('launches.evaluate_cuda_precise_frames') == 0\n"
        "assert counter('launches.device_log') == 0\n"
    )
    subprocess.run(
        [sys.executable, "-c", code], check=True, cwd=tmp_path,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"}, timeout=120,
    )
