"""PyTorch port: the spans and counters of utils/profiling.py on the CPU.

A test-size cook and a shot (fit_frames -> apply_frames -> transport_frames)
under torch.profiler record their span trees, one request id per root;
nothing records without a profiler; StageTimes holds the stages it held
before spans existed; the spans trace() exports sit on the trace's clock,
each within 50 us of its own range; a refit counts its LU solves; the sync
helper counts calls and bytes only where data crosses devices; every
counter is registered when its module is imported, and an unknown name is
refused."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from facedeform_tpu_torch import DeformConfig, DeformParams, FaceDeformNode, FitPlan, Mesh
from facedeform_tpu_torch.config import RBFModelType
from facedeform_tpu_torch.geometry.primitives import fibonacci_points, uv_sphere
from facedeform_tpu_torch.parallel import batched
from facedeform_tpu_torch.utils import profiling
from facedeform_tpu_torch.utils.profiling import StageTimes

CFG = DeformConfig(dofalloff=True, morphspace=True)
PARAMS = DeformParams(radius=0.8, maxedges=8)
#: the stages a cold cook and a drag of this scene time (as before spans)
COLD_STAGES = {"copy", "capture", "dbse_build", "solve", "eval", "morph", "output"}
DRAG_STAGES = {"copy", "solve", "eval", "morph", "output"}
#: the spans a drag records under its root, by parent
DRAG_TREE = {
    "FaceDeformNode.cook": {"copy", "solve", "cook.report", "eval", "morph", "output"},
    "solve": {"fit.refit"},
    "fit.refit": {"fit.refine"},
    "eval": {"eval.apply", "eval.falloff_copy"},
    "morph": {"morph.weights", "morph.apply"},
}
SHOT_TREE = {
    "batched.fit_frames": {"fit.assemble", "fit.factor", "fit.refine"},
    "batched.apply_frames": {"eval.falloff_weight", "eval.frames"},
    "batched.transport_frames": {"transport.jacobian", "transport.rules", "transport.stack"},
}


def _pose(rest, amp):
    bump = amp * np.exp(-2 * np.sum((rest - np.float32([0, 1, 0])) ** 2, -1, keepdims=True))
    return (rest + bump * np.float32([0.3, 1.0, 0.0])).astype(np.float32)


@pytest.fixture
def scene():
    """(node, [mesh, rest rig] , shapes, rest) of a 24 x 24 sphere, 30
    markers and 3 blendshapes, cooked once (capture, DBSE, the plan)."""
    sphere = uv_sphere(24, 24)
    mesh = Mesh(points=sphere.points.copy(), faces=sphere.faces.copy())
    rest = fibonacci_points(30)
    rng = np.random.default_rng(3)
    shapes = [Mesh(points=(mesh.points + 0.02 * rng.standard_normal(mesh.points.shape)
                           ).astype(np.float32)) for _ in range(3)]
    node = FaceDeformNode(device="cpu")
    return node, [mesh, Mesh(points=rest)], shapes, rest


def _cook(scene, amp, times=None):
    node, (mesh, rest_rig), shapes, rest = scene
    return node.cook([mesh, rest_rig, Mesh(points=_pose(rest, amp))] + shapes, CFG, PARAMS,
                     times=times)


def _new_spans(first):
    return [s for s in profiling.spans() if s.id >= first]


def _tree(recorded):
    """{parent name: {child names}} and the roots, checking that every
    span shares its root's request id."""
    by_id = {s.id: s for s in recorded}
    tree, roots = {}, []
    for s in recorded:
        if s.parent is None:
            roots.append(s)
            continue
        up = by_id[s.parent]
        assert s.request == up.request and up.t0_ns <= s.t0_ns <= s.t1_ns <= up.t1_ns
        tree.setdefault(up.name, set()).add(s.name)
    return tree, roots


def _profiled(fn):
    first = profiling._REC.next_id
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return _new_spans(first)


def test_cook_records_its_span_tree_under_one_request_id(scene):
    _cook(scene, 0.2)
    recorded = _profiled(lambda: (_cook(scene, 0.25), _cook(scene, 0.3)))
    tree, roots = _tree(recorded)
    assert [r.name for r in roots] == ["FaceDeformNode.cook"] * 2
    assert roots[0].request != roots[1].request
    for parent, children in DRAG_TREE.items():
        assert children <= tree[parent], (parent, tree.get(parent))
    assert {s.request for s in recorded} == {r.request for r in roots}
    # the node's own counters move over its root: the refit's LU solves
    assert all(r.counters.get("fit.lu_solves", 0) > 0 for r in roots)


def test_shot_records_three_roots_with_their_spans():
    rest = fibonacci_points(20)
    poses = torch.as_tensor(np.stack([_pose(rest, a) for a in (0.1, 0.2, 0.3)]))
    sphere = uv_sphere(16, 16)
    pts = torch.as_tensor(sphere.points)
    normals = pts / torch.linalg.norm(pts, dim=1, keepdim=True)
    cfg = DeformConfig()

    def shot():
        model, _ = batched.fit_frames(rest, poses, cfg, PARAMS, device="cpu")
        _, w = batched.apply_frames(model, pts, torch.zeros(len(pts)), torch.ones(len(pts)),
                                    cfg, PARAMS)
        batched.transport_frames(model, pts, (normals,), w, cfg, ("normal",))

    tree, roots = _tree(_profiled(shot))
    assert [r.name for r in roots] == list(SHOT_TREE)
    assert len({r.request for r in roots}) == 3
    for parent, children in SHOT_TREE.items():
        assert tree[parent] == children, parent


def test_nothing_records_and_no_range_opens_without_a_profiler(scene, monkeypatch):
    _cook(scene, 0.2)
    opened = []
    real = torch.profiler.record_function

    def counted(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    first = profiling._REC.next_id
    _cook(scene, 0.25)
    with profiling.span("outside a profiler"):
        pass
    assert profiling._REC.next_id == first and not _new_spans(first)
    # the stages keep their ranges, the new spans open none
    assert set(opened) == DRAG_STAGES


def test_stage_times_keep_their_stages_with_and_without_a_profiler(scene):
    cold, plain, traced = StageTimes(), StageTimes(), StageTimes()
    _cook(scene, 0.2, cold)
    _cook(scene, 0.25, plain)
    with profile(activities=[ProfilerActivity.CPU]):
        _cook(scene, 0.3, traced)
    assert set(cold.ms) == COLD_STAGES
    assert set(plain.ms) == set(traced.ms) == DRAG_STAGES
    assert plain.counts == traced.counts == {k: 1 for k in DRAG_STAGES}


def _trace_cook(scene, logdir, amp):
    """(exported spans and counters, trace events) of one traced cook, and
    each span's distance from its own range's `ts`, us."""
    with profiling.trace(logdir):
        _cook(scene, amp)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    with open(os.path.join(logdir, "spans.json")) as f:
        exported = json.load(f)
    ranges = {}
    for e in sorted(events, key=lambda e: float(e.get("ts", 0))):
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(float(e["ts"]))
    seen, off = {}, []
    for s in exported["spans"]:          # the k-th span of a name is its k-th range
        k = seen[s["name"]] = seen.get(s["name"], -1) + 1
        off.append(abs(s["ts"] - ranges[s["name"]][k]))
    return exported, events, off


def test_exported_spans_sit_on_the_trace_clock(scene, tmp_path):
    """Every span of a traced cook starts within 50 us of its range.  A
    host that deschedules the process while a range opens delays that one
    stamp by up to milliseconds, so the best of three cooks is held to it."""
    _cook(scene, 0.2)
    runs = [_trace_cook(scene, str(tmp_path / f"trace{i}"), 0.25 + 0.01 * i) for i in range(3)]
    assert min(max(off) for _, _, off in runs) <= 50.0, [max(off) for _, _, off in runs]
    exported, events, _ = runs[0]
    assert len(exported["spans"]) == len(DRAG_TREE["FaceDeformNode.cook"]) + 7
    assert exported["counters"]["fit.lu_solves"] > 0
    lu = [e for e in events if e.get("ph") == "C" and e["name"] == "fit.lu_solves"]
    assert lu and max(e["args"]["value"] for e in lu) == exported["counters"]["fit.lu_solves"]


@pytest.mark.parametrize("model,layers", [(RBFModelType.QNN, 1), (RBFModelType.MULTILAYER, 3)])
def test_refit_counts_layers_times_one_plus_n_refine_lu_solves(model, layers):
    cfg = DeformConfig(model=model, layers=layers, n_refine=2)
    rest = fibonacci_points(25)
    plan = FitPlan.prepare(rest, cfg, DeformParams(), device="cpu")
    before = profiling.counter("fit.lu_solves")
    plan.refit(_pose(rest, 0.2))
    assert cfg.n_layers == layers
    assert profiling.counter("fit.lu_solves") - before == layers * (1 + cfg.n_refine)


def test_sync_helper_counts_only_across_devices(monkeypatch):
    names = ("sync.count", "sync.wait_ns", "fence.count", "copy.dtoh_bytes", "copy.htod_bytes")

    def moved(before):
        return {k: profiling.counter(k) - before[k] for k in names}

    t = torch.arange(10, dtype=torch.float32)
    host = np.arange(5, dtype=np.float64)
    before = {k: profiling.counter(k) for k in names}
    assert torch.equal(profiling.to_host(t), t)
    assert profiling.to_device(host, "cpu", torch.float32).dtype == torch.float32
    with profiling.blocking("cpu"):
        pass
    assert moved(before) == dict.fromkeys(names, 0)

    # a fake boundary: the CPU stands for a card
    monkeypatch.setattr(profiling, "_on_card", lambda device: True)
    before = {k: profiling.counter(k) for k in names}
    assert torch.equal(profiling.to_host(t), t)
    out = profiling.to_device(host, "cpu", torch.float32)
    assert torch.equal(out, torch.arange(5, dtype=torch.float32))
    profiling.to_device(t, "cpu")            # already "on the card": no crossing
    with profiling.blocking("cpu", "fence"):
        pass
    got = moved(before)
    assert got["sync.wait_ns"] >= 0
    assert {k: v for k, v in got.items() if k != "sync.wait_ns"} == {
        "sync.count": 2, "fence.count": 1, "copy.dtoh_bytes": 40, "copy.htod_bytes": 20}


def test_span_buffer_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(profiling, "_REC", profiling._Recorder(capacity=4))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(6):
            with profiling.span(f"s{i}"):
                profiling.count("test.buffer")
    kept = profiling.spans()
    assert [s.name for s in kept] == ["s2", "s3", "s4", "s5"]
    assert [s.request for s in kept] == [2, 3, 4, 5]
    assert all(s.counters == {"test.buffer": 1} for s in kept)


def test_a_failing_span_or_stage_closes_and_the_next_is_a_root():
    with profile(activities=[ProfilerActivity.CPU]):
        for ctx in (profiling.span("fails"), profiling.stage("fails too")):
            with pytest.raises(RuntimeError):
                with ctx:
                    raise RuntimeError("x")
            with profiling.span("after"):
                pass
    *_, f1, a1, f2, a2 = profiling.spans()
    assert [s.name for s in (f1, a1, f2, a2)] == ["fails", "after", "fails too", "after"]
    assert all(s.parent is None for s in (f1, a1, f2, a2))


def test_counters_are_registered_at_import_and_an_unknown_name_is_refused():
    from facedeform_tpu_torch.ops import cuda_eval, cuda_jacobian, cuda_precise, cuda_pu, cuda_solve

    mods = (cuda_eval, cuda_jacobian, cuda_precise, cuda_pu, cuda_solve)
    launches = [k for k in profiling.counters() if k.startswith("launches.")]
    assert len(launches) == 15
    for k in launches:
        wrappers = [m for m in mods if callable(getattr(m, k.split(".", 1)[1], None))]
        assert len(wrappers) == 1, k
    for k in ("sync.count", "sync.wait_ns", "fence.count", "fence.wait_ns", "copy.dtoh_bytes",
              "copy.htod_bytes", "fit.lu_solves", "fit.gmres_restarts", "eval.autotune_runs"):
        assert profiling.counter(k) >= 0
    with pytest.raises(KeyError, match="launches.evaluate_cuda_typo"):
        profiling.counter("launches.evaluate_cuda_typo")
