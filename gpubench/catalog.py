"""Finds a cell's files by the names BENCHMARK.json and the data files
give.  Adding a configuration, a mix, a kind of loop, a scene, a
reference family, a metric, a roofline count or a cell's limits is adding
a file and an entry: nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def benchmark(root: Path) -> dict:
    """BENCHMARK.json at the root of the checkout."""
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config(name: str, base: Path = HERE) -> dict:
    return _json(base / "configs" / f"{name}.json")


def traffic(name: str, base: Path = HERE) -> dict:
    return _json(base / "traffic" / f"{name}.json")


def limits(cell_name: str, base: Path = HERE) -> dict:
    return _json(base / "limits" / f"{cell_name}.json")


def _module(path: Path):
    name = "gpubench_file_" + "_".join(path.parts[-2:]).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop(name: str, base: Path = HERE):
    """A kind of loop (a mix's "loop"): the module with Loop and compare
    (see drive.py)."""
    return _module(base / "loops" / f"{name}.py")


def scene(name: str, base: Path = HERE):
    """A configuration's "scene": make(config, seed, device) -> inputs.Scene."""
    return _module(base / "scenes" / f"{name}.py").make


def reference(name: str, base: Path = HERE):
    """A configuration's "reference" family: Reference(scene, config,
    device, prec)."""
    return _module(base / "reference" / f"{name}.py").Reference


def metric(name: str, base: Path = HERE):
    """The reader of a metric: read(run) -> number or None."""
    return _module(base / "metrics" / f"{name}.py").read


def roofline(layer: str, base: Path = HERE):
    """The work one request needs of a layer: work(ctx) -> peaks.Work."""
    return _module(base / "roofline" / f"{layer}.py").work


def metrics_of(bench: dict, cell_name: str, kind: str) -> list:
    """The cell's metrics of one kind ("end_to_end" or "per_layer"): those
    that list it, or list no cells."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]
