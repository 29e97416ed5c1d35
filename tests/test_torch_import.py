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
        "import facedeform_tpu_torch.ops.krylov, facedeform_tpu_torch.ops.precise_eval\n"
        "import facedeform_tpu_torch.ops.pu, facedeform_tpu_torch.ops.cuda_pu as cpu_\n"
        "jax = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'facedeform_tpu')]\n"
        "assert not jax, jax\n"
        "assert ce._lib is None\n"
        "assert (ce.evaluate_cuda.launches, ce.evaluate_cuda_culled.launches) == (0, 0)\n"
        "assert ce.evaluate_cuda_frames.launches == 0\n"
        "assert (cp.evaluate_cuda_precise.launches, ce.evaluate_cuda_diff.launches) == (0, 0)\n"
        "assert (cj.jacobian_cuda.launches, cj.jacobian_cuda_frames.launches) == (0, 0)\n"
        "assert cpu_.evaluate_pu_tiles_frames.launches == 0\n"
    )
    build = REPO / "facedeform_tpu_torch" / "csrc" / "build"
    before = sorted(build.glob("*")) if build.exists() else []
    subprocess.run(
        [sys.executable, "-c", code], check=True, cwd=tmp_path,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"}, timeout=120,
    )
    after = sorted(build.glob("*")) if build.exists() else []
    assert after == before
