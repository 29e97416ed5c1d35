"""The harness at test sizes on the CPU: determinism of the inputs by seed,
the roofline counts, the contract of BENCHMARK.json, the loader finding
files a change adds, the control and the planted faults failing
`correct`, and the guards that end a run without a result."""

import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import catalog, compare, drive, harness, inputs, peaks, reference

from .conftest import HERE, ROOT, TINY_MESH, TINY_SHAPES, shrink

SEED = 2**31 + 12345          # seeds reach past 32 signed bits
BENCH = catalog.benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
#: a traced window's requests up to the end of its profiled part
TRACED = harness.PROFILE_FROM + harness.PROFILE_MIN


def _run(tiny, cell, seed=SEED, seconds=0.4, trace=False, controls=None, min_requests=1):
    """A run at test sizes; its window waits for `min_requests` requests
    however slow the CPU is, so a verdict always judges some."""
    return harness.run(tiny, cell, seed, seconds, trace, time.perf_counter(), device="cpu",
                       base=tiny / "gpubench", controls=controls, min_requests=min_requests)


def _unit(cell):
    """What the cell's loop delivers: "cooks" or "frames"."""
    mix = catalog.traffic(catalog.cell(BENCH, cell)["traffic"])
    return catalog.loop(mix["loop"]).Loop.unit


# ------------------------------------------------------------------ inputs
def test_inputs_repeat_by_seed_and_differ_across_seeds():
    rest = inputs.fibonacci_points(100)
    pose = {"amplitude": 0.05, "harmonics": 4, "wavenumber": 3.0}
    a = inputs.shot_poses(rest, pose, 5, 24.0, SEED, 3)
    assert torch.equal(a, inputs.shot_poses(rest, pose, 5, 24.0, SEED, 3))
    assert not torch.equal(a, inputs.shot_poses(rest, pose, 5, 24.0, SEED, 4))
    assert not torch.equal(a, inputs.shot_poses(rest, pose, 5, 24.0, SEED + 1, 3))
    assert 0.01 < float((a - torch.as_tensor(rest)).abs().max()) < 0.2

    def drags(seed):
        g = inputs.drags(inputs.start_pose(rest, pose, seed), 10, 0.01,
                         inputs.rng(seed, inputs.STREAM_DRAGS))
        return [next(g) for _ in range(4)]

    d1, d2 = drags(SEED), drags(SEED)
    assert all(np.array_equal(x, y) for x, y in zip(d1, d2))
    assert int((d1[1] != d1[0]).any(1).sum()) == 10           # 10 markers a drag
    pts = torch.as_tensor(inputs.uv_sphere(12, 12)[0])
    s1 = inputs.bump_shapes(pts, 3, 0.2, 0.05, SEED)
    assert torch.equal(s1, inputs.bump_shapes(pts, 3, 0.2, 0.05, SEED))
    assert not torch.equal(s1, inputs.bump_shapes(pts, 3, 0.2, 0.05, 7))


def test_reservoir_is_uniform_and_seeded():
    def picks(seed):
        r = drive.Reservoir(4, np.random.default_rng(seed))
        for i in range(200):
            slot = r.slot()
            if slot is not None:
                r.items[slot] = i
        return r.items

    assert picks(1) == picks(1) and picks(1) != picks(2)
    counts = np.zeros(200)
    for s in range(400):
        counts[picks(s)] += 1
    assert counts[:100].sum() == pytest.approx(counts[100:].sum(), rel=0.2)


# -------------------------------------------------------------- rooflines
def test_roofline_counts():
    ctx = {"V": 1_000_000, "N": 1000, "S": 52, "F": 48,
           "pairs": 10 ** 8, "phi_ops": 2, "precision": "float32", "real_bytes": 4}
    ev = catalog.roofline("eval")(ctx)
    assert ev.ops == ((11e8, peaks.PEAK_F32), (6e8, peaks.PEAK_TF32 / 3))
    assert ev.bytes == 32e6 + 28e3
    assert ev.seconds() == pytest.approx(11e8 / 67e12)
    fe = catalog.roofline("frames_eval")(ctx)
    assert fe.seconds() == pytest.approx(max(6 * 48 * 1e8 / (495e12 / 3),
                                             (16e6 + 12 * 48e6 + 4e3 * 148) / 3.35e12))
    jac = catalog.roofline("jacobian")(ctx)
    assert jac.seconds() == pytest.approx(18 * 48 * 1e8 / (495e12 / 3))
    morph = catalog.roofline("morph")(ctx)
    assert morph.seconds() == pytest.approx((12 * 52 * 1e6 + 36e6) / 3.35e12)
    tps = dict(ctx, phi_ops=5, precision="float64", real_bytes=8)
    assert catalog.roofline("eval")(tps).ops == ((14e8, 34e12), (6e8, 67e12))
    assert catalog.roofline("refit")(tps).seconds() == pytest.approx(8 * 1004 ** 2 / 3.35e12)


# ------------------------------------------------------- BENCHMARK.json
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def test_benchmark_json_keeps_the_contract():
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["gpubench"] and 1 <= b["run_seconds"] <= 51
    assert len(b["command"]) <= 32 and not any(w.startswith("/") or ".." in w
                                                for w in b["command"])
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("gpubench/") and (ROOT / c["file"]).exists()
        assert LINE.match(c["source"]) and LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
        assert (HERE / "scenes" / f"{data['scene']}.py").exists()
        assert (HERE / "reference" / f"{data['reference']}.py").exists()
        names.add(c["name"])
    used, pairs = set(), set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in names and w["chips"] == 1 and LINE.match(w["why"])
        assert NAME.match(w["traffic"])
        mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert (HERE / "loops" / f"{mix['loop']}.py").exists()
        assert (HERE / "limits" / f"{w['name']}.json").exists()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == names
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells and LINE.match(m["layer"])
        if "roofline" in m["name"]:     # a kernel's share of its roofline: <kernel>_roofline
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
        moved = e2e[m["moves"]].get("workloads", list(cells))
        assert set(m["workloads"]) <= set(moved)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                 "higher")
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
    for w in cells:     # every cell: setup_s, another end-to-end metric, a per-layer one
        assert len(catalog.metrics_of(b, w, "end_to_end")) >= 2
        assert catalog.metrics_of(b, w, "per_layer")


# ------------------------------------------------------------ test sizes
#: each configuration's rig at test sizes, (markers, radius): a change to
#: conftest.shrink that moves one shows here.  multilayer_tangent is not in
#: the benchmark: the reference node's second family as it ships (MULTILAYER,
#: layers 4, radius 1, lambda 0.1, tangent), written into the copy as a new file.
TEST_RIGS = {"face1m_gauss_rig1k": (40, 0.5), "face1m_tps_rig4k": (400, 1.0),
             "face1m_pu_bfm53k": (2000, 0.1), "multilayer_tangent": (40, 0.5)}


@pytest.mark.parametrize("name", sorted(TEST_RIGS))
def test_shrink_cuts_each_configuration_to_its_test_rig(tiny, name):
    path = tiny / "gpubench" / "configs" / f"{name}.json"
    if name == "multilayer_tangent":
        c = catalog.config("face1m_gauss_rig1k")
        c["deform_config"].update(model="MULTILAYER", layers=4, tangent=True)
        c["deform_params"].update(radius=1.0, lam=0.1)
        path.write_text(json.dumps(dict(c, name=name)))
        shrink(tiny)
    c = json.loads(path.read_text())
    assert (c["rig"]["markers"], c["deform_params"]["radius"]) == TEST_RIGS[name]
    assert c["mesh"]["n_u"] == c["mesh"]["n_v"] == TINY_MESH
    assert c["shapes"]["count"] == TINY_SHAPES


# ------------------------------------------------------------ the runs
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_cpu(tiny, cell):
    out = _run(tiny, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    b = catalog.benchmark(tiny)
    assert set(out["metrics"]) == {m["name"] for m in catalog.metrics_of(b, cell, "end_to_end")}
    assert list(out)[-1] == "checks"


def test_traced_run_reads_its_stages(tiny):
    out = _run(tiny, "gauss1k.drag", seconds=1.0, trace=True, min_requests=TRACED)
    assert out["correct"]
    for name in ("cook.host_ms", "cook.solve_ms", "cook.eval_ms", "cook.morph_ms"):
        assert out["metrics"][name]["value"] > 0.0
    assert out["device"]["window_s"] > 0.0 and "breakdown" in out


#: a shot never morphs, so the DBSE control has no stage to step down there
CONTROLS = [(c, k) for c in CELLS for k in reference.controls("float32")
            if not (k == "dbse_tf32" and c.endswith(".shot"))]


@pytest.mark.parametrize("cell,control", CONTROLS, ids=[f"{c}-{k}" for c, k in CONTROLS])
def test_control_comes_out_not_correct(tiny, cell, control):
    """Each control (the reference with one stage one precision step below
    the configuration, in the program's place) is judged by the verdict
    that decides `correct`, and comes out not correct, on the same
    requests as a run of the program that comes out correct."""
    cfg = catalog.config(catalog.cell(catalog.benchmark(tiny), cell)["config"], tiny / "gpubench")
    prec = reference.controls(cfg["precision"])[control]
    out = _run(tiny, cell, controls={control: prec})
    assert out["correct"], out["checks"]
    judged = out["controls"][control]
    assert not judged["correct"], judged
    limits = catalog.limits(cell, tiny / "gpubench")
    assert judged["correct"] == compare.verdict(judged["numbers"], limits)[1]


def test_verdict_needs_every_limited_number_within_its_limit():
    limits = {"a": 1.0, "b": 2.0}
    assert compare.verdict({"a": 0.5, "b": 2.0}, limits)[1]
    assert not compare.verdict({"a": 0.5, "b": 2.5}, limits)[1]
    assert not compare.verdict({"a": 0.5}, limits)[1]
    assert not compare.verdict({"a": 0.5, "b": float("nan")}, limits)[1]
    assert not compare.verdict({"a": 0.5, "b": 1.0, "c": 0.0}, limits)[1]
    assert not compare.verdict({"a": 0.5, "b": 1.0}, limits, failed=1)[1]


# ------------------------------------------------------ planted faults
def _stale_cook(monkeypatch):
    from facedeform_tpu_torch.node import FaceDeformNode

    real, first = FaceDeformNode.cook, {}

    def cook(self, *a, **k):
        res = real(self, *a, **k)
        return first.setdefault(id(self), res)

    monkeypatch.setattr(FaceDeformNode, "cook", cook)


def _altered_cook(monkeypatch):
    """One vertex of the eval's output moved by 1e-3 where it is produced,
    on every route the node cooks: the global model's Deformer.apply and
    the partition-of-unity facade's PUNodeDeformer.apply."""
    from facedeform_tpu_torch.deformer import Deformer
    from facedeform_tpu_torch.ops.pu import PUNodeDeformer

    for cls in (Deformer, PUNodeDeformer):
        real = cls.apply

        def apply(self, *a, _real=real, **k):
            p, w = _real(self, *a, **k)
            p = p.clone()
            p[len(p) // 2] += 1e-3
            return p, w

        monkeypatch.setattr(cls, "apply", apply)


def _stale_shot(monkeypatch):
    from facedeform_tpu_torch.parallel import batched

    real, first = batched.fit_frames, []

    def fit_frames(*a, **k):
        out = real(*a, **k)
        if not first:
            first.append(out)
        return first[0]

    monkeypatch.setattr(batched, "fit_frames", fit_frames)


def _half_shot(monkeypatch):
    from facedeform_tpu_torch.parallel import batched

    real = batched.apply_frames

    def apply_frames(model, *a, **k):
        pos, w = real(model, *a, **k)
        half = max(1, pos.shape[0] // 2)
        pos = pos.clone()
        pos[half:] = pos[:half].mean(0)
        return pos, w

    monkeypatch.setattr(batched, "apply_frames", apply_frames)


def _altered_shot(monkeypatch):
    from facedeform_tpu_torch.parallel import batched

    real = batched.apply_frames

    def apply_frames(*a, **k):
        pos, w = real(*a, **k)
        pos = pos.clone()
        pos[-1, pos.shape[1] // 2] += 1e-3
        return pos, w

    monkeypatch.setattr(batched, "apply_frames", apply_frames)


#: the faults planted in each unit a loop delivers: a state returned
#: unchanged, half of a batch replaced by the mean of the rest, an answer
#: altered where it is produced
FAULTS_OF = {"cooks": (_stale_cook, _altered_cook),
             "frames": (_stale_shot, _half_shot, _altered_shot)}
FAULTS = [(c, f) for c in CELLS for f in FAULTS_OF.get(_unit(c), ())]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_planted_fault_fails_correct(tiny, monkeypatch, cell, fault):
    """The fault is read by the comparison: every request came back, and a
    number the cell compares is past its limit."""
    fault(monkeypatch)
    out = _run(tiny, cell, seconds=0.6)
    assert not out["correct"], out["checks"]
    assert out["failed"] == 0
    assert any(c["value"] > c["limit"] for c in out["checks"].values()), out["checks"]


def test_planted_faults_cover_every_cell():
    """Every cell of BENCHMARK.json has a stale state and an altered answer
    planted under it."""
    for cell in CELLS:
        planted = {f.__name__ for c, f in FAULTS if c == cell}
        assert any("stale" in f for f in planted), cell
        assert any("altered" in f for f in planted), cell


# --------------------------------------------- adding files, not editing
def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_config_mix_and_metric_are_new_files_only(tiny):
    base = tiny / "gpubench"
    before = _digests(tiny)
    cfg = json.loads((base / "configs" / "face1m_gauss_rig1k.json").read_text())
    cfg.update(name="new_rig", deform_config=dict(cfg["deform_config"], morphspace=False))
    (base / "configs" / "new_rig.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "drag.json").read_text())
    mix.update(moved=3, sigma=0.02)
    (base / "traffic" / "small_drag.json").write_text(json.dumps(mix))
    (base / "metrics" / "cook.wall_ms.py").write_text(
        "def read(run):\n    return run.mean('wall')\n")
    (base / "limits" / "new.small_drag.json").write_text(
        json.dumps({"p_err": 1e-4, "falloff_err": 1e-4}))
    b = json.loads((tiny / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "new_rig", "source": "a test", "reduced": [],
                         "file": "gpubench/configs/new_rig.json"})
    b["workloads"].append({"name": "new.small_drag", "config": "new_rig",
                           "traffic": "small_drag", "chips": 1, "why": "a test"})
    b["end_to_end"][0]["workloads"].append("new.small_drag")
    b["per_layer"].append({"name": "cook.wall_ms", "unit": "ms", "better": "lower",
                           "source": "host_clock", "layer": "node (node.py)",
                           "moves": "cooks_per_s", "workloads": ["new.small_drag"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(b))
    out = _run(tiny, "new.small_drag", trace=True, seconds=1.0)
    assert out["correct"] and out["metrics"]["cook.wall_ms"]["value"] > 0.0
    assert set(out["checks"]) == {"p_err", "falloff_err"}
    after = _digests(tiny)
    changed = {p for p in before if p != Path("BENCHMARK.json") and before[p] != after.get(p)}
    assert not changed


SCRUB_LOOP = '''"""A tracked take played in the viewport: every marker moves each cook,
along the mix's smooth seeded motion sampled at fps."""
import numpy as np

from gpubench import inputs
from gpubench.loops import cook

compare = cook.compare


class Loop(cook.Loop):
    def __init__(self, scene, config, mix, seed, device):
        super().__init__(scene, config, mix, seed, device)
        self.rest_points = scene.rest

    def requests(self, poses, sweeps):
        waves = inputs.Waves.draw(poses, **self.mix["pose"])
        for k in range(1 << 30):
            pose = waves.at(self.rest_points, np.array([k / self.mix["fps"]]))[0].numpy()
            yield self.Mesh(points=pose), pose, self.params
'''

ELLIPSOID_SCENE = '''"""The sphere scene stretched along the axes the configuration's mesh gives."""
import numpy as np

from gpubench import inputs
from gpubench.scenes import sphere_markers


def make(config, seed, device):
    s = sphere_markers.make(config, seed, device)
    axes = np.asarray(config["mesh"]["axes"], np.float32)
    normals = s.normals / axes
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    shapes = None if s.shapes is None else s.shapes * axes
    return inputs.Scene(s.points * axes, s.faces, normals, s.rest * axes, s.classes, shapes)
'''

MQ_REFERENCE = '''"""RBF rigs of the multiquadric sqrt(1 + s), with capture and DBSE."""
import torch

from gpubench import reference as ref
from gpubench.reference import rbf_dbse


class Reference(rbf_dbse.Reference):
    kernels = dict(ref.KERNELS, MULTIQUADRIC=ref.Kernel(
        "multiquadric", lambda s: torch.sqrt(1.0 + s), lambda s: 0.5 * torch.rsqrt(1.0 + s), 3))
'''


def test_a_new_kind_of_mix_and_a_new_model_family_are_new_files_only(tiny):
    """A kind of loop, a scene, a reference family, a configuration, a mix
    and limits, each a new file, and entries in BENCHMARK.json: the cell
    runs `correct` and no file that was there changes."""
    base = tiny / "gpubench"
    before = _digests(tiny)
    (base / "loops" / "scrub.py").write_text(SCRUB_LOOP)
    (base / "scenes" / "ellipsoid_markers.py").write_text(ELLIPSOID_SCENE)
    (base / "reference" / "rbf_mq.py").write_text(MQ_REFERENCE)
    cfg = json.loads((base / "configs" / "face1m_tps_rig4k.json").read_text())
    cfg.update(name="mq_rig", scene="ellipsoid_markers", reference="rbf_mq",
               mesh=dict(cfg["mesh"], axes=[1.2, 0.9, 1.0]),
               deform_config=dict(cfg["deform_config"], kernel="MULTIQUADRIC"))
    (base / "configs" / "mq_rig.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "drag.json").read_text())
    mix.update(loop="scrub", fps=24)
    (base / "traffic" / "scrub.json").write_text(json.dumps(mix))
    (base / "limits" / "mq.scrub.json").write_text(
        json.dumps({"p_err": 3e-5, "falloff_err": 1e-6, "weights_err": 3e-5}))
    b = json.loads((tiny / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "mq_rig", "source": "a test", "reduced": [],
                         "file": "gpubench/configs/mq_rig.json"})
    b["workloads"].append({"name": "mq.scrub", "config": "mq_rig", "traffic": "scrub",
                           "chips": 1, "why": "a test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "gauss1k.drag" in m.get("workloads", []):
            m["workloads"].append("mq.scrub")
    (tiny / "BENCHMARK.json").write_text(json.dumps(b))
    out = _run(tiny, "mq.scrub", seconds=0.0, min_requests=2)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["metrics"]["cooks_per_s"]["value"] > 0.0
    traced = _run(tiny, "mq.scrub", seconds=0.0, trace=True, min_requests=TRACED)
    assert traced["correct"] and traced["metrics"]["cook.eval_ms"]["value"] > 0.0
    after = _digests(tiny)
    changed = {p for p in before if p != Path("BENCHMARK.json") and before[p] != after.get(p)}
    assert not changed


# ------------------------------------------------------------- guards
def test_run_without_a_card_ends_without_a_result():
    out = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", CELLS[0],
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(ROOT)})
    assert out.returncode != 0 and "correct" not in out.stdout


def test_only_tests_hold_a_window_open_for_requests():
    """min_requests keeps a window open past its seconds until that many
    requests were attempted; a benchmark run never passes it, so its
    window is its seconds alone."""
    class Loop:
        def step(self, times):
            return 0.0, 1

    assert harness._window(Loop(), 0.0, False, min_requests=3)[1:3] == (3, 3)
    assert harness._window(Loop(), 0.0, False)[2] == 0
    assert "min_requests" not in (HERE / "run.py").read_text()


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "facedeform_tpu_torch_fake", sys)
    assert harness.forbidden_modules() == [m for m in harness.FORBIDDEN if m in
                                           {n.split(".")[0] for n in sys.modules}]
    monkeypatch.setitem(sys.modules, "facedeform_tpu.fake", sys)
    assert "facedeform_tpu" in harness.forbidden_modules()
