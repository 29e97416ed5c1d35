"""Fixtures of the benchmark's tests: a copy of the benchmark cut to test
sizes, and the `card` marker for tests that need an NVIDIA card."""

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent      # gpubench/
ROOT = HERE.parent

#: test sizes: a 24 x 24 sphere, 4 shapes, 3 frames; the rig's by its route (rig_size)
TINY_MESH, TINY_SHAPES, TINY_FRAMES = 24, 4, 3
#: KERNEL's growing kernels: their float32 control reads past its limits from some
#: hundreds of markers, so their rigs keep 400
GROWING = ("THIN_PLATE", "MULTIQUADRIC", "LINEAR", "CUBIC")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """Skip unless torch sees a CUDA card (decided here, at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda:0")


def rig_size(config: dict) -> tuple:
    """(markers, radius) of a configuration at test sizes, by the route it
    takes; radius None keeps the configuration's.

    - a partition-of-unity rig (solver "pu"): 2000 markers.  At 400 (the
      KERNEL size it had before) a patch spans a quarter of the sphere and
      the program's honest p_err reads ~57% of the 5e-5 limit; at 2000
      ~5e-6 (tests/test_torch_pu_take.py).
    - a growing kernel under KERNEL: 400 markers (see GROWING).
    - every other family, QNN, MULTILAYER and any the fixture has not
      seen: 40 markers and radius 0.5, the capture radius over the sparser
      rig.
    """
    dc = config["deform_config"]
    if dc.get("solver") == "pu":
        return 2000, None
    if dc["model"] == "KERNEL" and dc.get("kernel") in GROWING:
        return 400, None
    return 40, 0.5


def shrink(root: Path) -> None:
    """Cut every configuration and mix under root/gpubench to test sizes."""
    for path in (root / "gpubench" / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c["mesh"]["n_u"] = c["mesh"]["n_v"] = TINY_MESH
        c["rig"]["markers"], radius = rig_size(c)
        c["shapes"]["count"] = TINY_SHAPES
        if radius is not None:
            c["deform_params"]["radius"] = radius
        path.write_text(json.dumps(c))
    for path in (root / "gpubench" / "traffic").glob("*.json"):
        m = json.loads(path.read_text())
        if "frames" in m:
            m["frames"] = TINY_FRAMES
        path.write_text(json.dumps(m))


@pytest.fixture
def tiny(tmp_path) -> Path:
    """A checkout of the benchmark alone (BENCHMARK.json and gpubench/) at
    test sizes; the program is imported from the repository."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("out", "__pycache__", "tests"))
    shrink(tmp_path)
    return tmp_path
