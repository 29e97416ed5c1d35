"""Fixtures of the benchmark's tests: a copy of the benchmark cut to test
sizes, and the `card` marker for tests that need an NVIDIA card."""

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent      # gpubench/
ROOT = HERE.parent

#: test sizes: a 24 x 24 sphere, 40 QNN or 400 TPS markers (the float32 control of
#: a TPS rig reads past its limits from some hundreds of markers), 4 shapes, 3 frames
TINY_MESH, TINY_MARKERS, TINY_SHAPES, TINY_FRAMES = 24, {"QNN": 40, "KERNEL": 400}, 4, 3


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """Skip unless torch sees a CUDA card (decided here, at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda:0")


def shrink(root: Path) -> None:
    """Cut every configuration and mix under root/gpubench to test sizes."""
    for path in (root / "gpubench" / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c["mesh"]["n_u"] = c["mesh"]["n_v"] = TINY_MESH
        c["rig"]["markers"] = TINY_MARKERS[c["deform_config"]["model"]]
        c["shapes"]["count"] = TINY_SHAPES
        if c["deform_config"]["model"] == "QNN":
            c["deform_params"]["radius"] = 0.5   # the capture radius over the sparser rig
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
