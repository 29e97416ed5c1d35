"""The scan-density partition-of-unity configuration of the benchmark
(gpubench/configs/face1m_pu_bfm53k.json, cell pu53k.take) at test sizes on
the CPU: the port's node cook with solver="pu" against the benchmark's
plain PU reference (gpubench/reference/pu_dbse.py), the reference's patch
geometry against the port's, the configuration's method settings against
the port's defaults, the PU route's spans and counters, and the metrics
that read them."""

import inspect
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from facedeform_tpu_torch import FaceDeformNode, Mesh
from facedeform_tpu_torch.ops import cuda_pu, pu
from facedeform_tpu_torch.utils import profiling
from gpubench import catalog, compare, drive, harness, inputs, peaks
from gpubench import reference as ref
from gpubench.reference import pu as ref_pu
from gpubench.reference import pu_dbse

CONFIG, CELL = "face1m_pu_bfm53k", "pu53k.take"
SEED = 2**31 + 4242
# The port's P against the float64 reference, over the largest displacement:
# the f32 eval of a thin-plate patch is a small difference of sum |w phi|
# terms ~10^3 times larger, so the f32 rounding of the centered distances
# (~6e-8) leaves up to ~5e-5 at these sparse rigs (a patch spans a quarter
# of the sphere at 400 markers); the TF32 control misses it by ~10^3.
P_TOL = 1.5e-4
# fd_falloff: the f32 falloff of f32 capture distances against float64, a
# few ulps of 1.
FALLOFF_TOL = 1e-6
# DBSE weights over their largest: B^T d follows P's error.
WEIGHTS_TOL = 1.5e-4


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """The PU fits' LAPACK calls on one intra-op thread (see
    test_torch_eval.py: this torch's LAPACK faults once the count is raised
    after being lowered, so it is never raised again)."""
    torch.set_num_threads(1)


def _config(markers: int, n_side: int = 40) -> dict:
    c = catalog.config(CONFIG)
    c["mesh"] = {"n_u": n_side, "n_v": n_side}
    c["rig"] = dict(c["rig"], markers=markers)
    c["shapes"] = dict(c["shapes"], count=4)
    return c


def _cook(node, scene, cfg, params, pose):
    mesh = Mesh(points=scene.points, faces=scene.faces)
    rest = Mesh(points=scene.rest)
    rest.set_attr("class", scene.classes)
    shapes = [Mesh(points=s) for s in scene.shapes]
    return node.cook([mesh, rest, Mesh(points=pose)] + shapes, cfg, params)


@pytest.mark.parametrize("markers", [400, 2000])
def test_node_cook_matches_the_pu_reference(markers):
    """Seeded random poses (frames of seeded takes) cooked by the port's
    node through the PU route, each held to the plain float64 reference;
    the reference's TF32 `precision` control misses P's tolerance."""
    c = _config(markers)
    scene = catalog.scene("sphere_markers")(c, SEED, torch.device("cpu"))
    cfg, params = drive.program_config(c)
    assert cfg.solver == "pu"
    judge = pu_dbse.Reference(scene, c, torch.device("cpu"), ref.JUDGE)
    tf32 = pu_dbse.Reference(scene, c, torch.device("cpu"), ref.controls("float32")["precision"])
    assert 4 <= len(judge.geo.members) <= 16
    node = FaceDeformNode(device="cpu")
    control = 0.0
    for take in range(3):
        pose = inputs.shot_poses(scene.rest, {"amplitude": 0.05, "harmonics": 4,
                                              "wavenumber": 3.0}, 2, 24.0, SEED, take)[1].numpy()
        res = _cook(node, scene, cfg, params, pose)
        want_p, want_f, want_w = judge.cook(pose, params._asdict())
        got_p = compare.as64(res.mesh.points, "cpu")
        assert compare.p_err(got_p, want_p, judge.points) < P_TOL
        assert compare.max_abs(compare.as64(res.mesh.attr("fd_falloff"), "cpu"), want_f) < \
            FALLOFF_TOL
        assert compare.rel_max(compare.as64(res.weights, "cpu"), want_w) < WEIGHTS_TOL
        ctrl_p = tf32.cook(pose, params._asdict())[0].double()
        control = max(control, compare.p_err(ctrl_p, want_p, judge.points))
    assert control > 10 * P_TOL


@pytest.mark.parametrize("markers", [400, 2000, 53490])
def test_reference_patches_equal_build_patches(markers):
    """The reference builds the patch geometry by the published rule
    itself; its patches hold the same controls as the port's, in the same
    order, with the same support radii and basis radii up to float32
    rounding."""
    rest = inputs.fibonacci_points(markers)
    mine = pu.build_patches(rest)
    theirs = ref_pu.patches(rest, 192, 1.3)
    assert len(theirs.members) == mine.idx.shape[0]
    for row, members in zip(mine.idx, theirs.members):
        assert np.array_equal(np.sort(row[row >= 0]), members)
    # the port's radii, centers and spacings are float32, the reference's float64
    np.testing.assert_allclose(theirs.radii, mine.radii, rtol=0, atol=1e-6)
    np.testing.assert_allclose(theirs.eps, 2.0 * mine.spacing, rtol=1e-6)
    np.testing.assert_allclose(theirs.centers, mine.centers, atol=1e-6)
    if markers == 53490:
        assert mine.idx.shape == (512, 640)


def test_configuration_states_the_ports_pu_defaults():
    """The configuration's "pu" block is what the node's PU fit takes: the
    facade's defaults, which the node's fit (PUFitPlan.refit, whose first
    pose builds the patches) does not override, and eps "auto"."""
    method = catalog.config(CONFIG)["pu"]
    fit = inspect.signature(pu.PUDeformer.fit).parameters
    assert method["patch_size"] == fit["patch_size"].default == 192
    assert method["overlap"] == fit["overlap"].default == 1.3
    assert method["eps"] == fit["eps"].default == "auto"
    build = inspect.signature(pu.build_patches).parameters
    assert build["patch_size"].default == 192 and build["overlap"].default == 1.3
    node_fit = inspect.getsource(pu.PUFitPlan.refit)
    assert 'eps="auto"' in node_fit and "patch_size" not in node_fit and "overlap" not in node_fit


def test_the_pu_reference_imports_nothing_of_the_program():
    """The PU reference family and its roofline counts load neither the
    port, nor the JAX package, nor JAX."""
    code = ("import sys\n"
            "from gpubench import catalog\n"
            "catalog.reference('pu_dbse'); catalog.roofline('pu_fit'); catalog.roofline('pu_eval')\n"
            "import gpubench.reference.pu\n"
            "names = {m.split('.')[0] for m in sys.modules}\n"
            "bad = names & {'facedeform_tpu_torch', 'facedeform_tpu', 'jax', 'jaxlib', 'flax'}\n"
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=catalog.HERE.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_pu_roofline_counts():
    ctx = {"V": 1_000_000, "S": 52, "K": 512, "live": 160_000, "systems": 512 * 300 ** 2,
           "pairs": 10 ** 9, "precision": "float32", "real_bytes": 4}
    fit = catalog.roofline("pu_fit")(ctx)
    assert fit.ops == ((12 * 512 * 300 ** 2, peaks.PEAK_TF32 / 3),)
    assert fit.bytes == 4 * 512 * 300 ** 2
    ev = catalog.roofline("pu_eval")(ctx)
    assert ev.ops == ((21e9, peaks.PEAK_F32),)
    assert ev.bytes == 32e6 + 4 * (6 * 160_000 + 17 * 512)
    assert ev.seconds() == pytest.approx(21e9 / 67e12)


# ------------------------------------------- the eval plan across pose refits
def _scene400():
    c = _config(400, 24)
    scene = catalog.scene("sphere_markers")(c, SEED, torch.device("cpu"))
    return scene, drive.program_config(c)


def _take_poses(scene, frames: int, take: int = 0) -> list:
    mix = {"amplitude": 0.05, "harmonics": 4, "wavenumber": 3.0}
    return list(inputs.shot_poses(scene.rest, mix, frames, 24.0, SEED, take).numpy())


class _Take:
    """One node cooking the poses of a take as gpubench/loops/take.py does:
    the same mesh and rest-rig Meshes every cook, a new posed rig."""

    def __init__(self, scene, cfg, params, mesh=None, rest=None):
        self.scene, self.cfg, self.params = scene, cfg, params
        self.mesh = mesh or Mesh(points=scene.points, faces=scene.faces)
        if rest is None:
            rest = Mesh(points=scene.rest)
            rest.set_attr("class", scene.classes)
        self.rest = rest
        self.shapes = [Mesh(points=s) for s in scene.shapes]
        self.node = FaceDeformNode(device="cpu")

    def cook(self, pose, **kw):
        """(CookResult, the PU counters' deltas over the cook)."""
        names = ("pu.patch_sets", "pu.plans", "pu.plan_hits", "pu.fit_hits")
        before = [profiling.counter(n) for n in names]
        res = self.node.cook([self.mesh, self.rest, Mesh(points=pose)] + self.shapes,
                             self.cfg, self.params, **kw)
        return res, {n: profiling.counter(n) - b for n, b in zip(names, before)}

    def fresh(self, pose, **kw):
        """The same cook on a node that has cooked nothing."""
        return _Take(self.scene, self.cfg, self.params, self.mesh, self.rest).cook(pose, **kw)[0]


def _equal(a, b) -> None:
    """P and fd_falloff bit for bit."""
    assert torch.equal(torch.as_tensor(a.mesh.points), torch.as_tensor(b.mesh.points))
    assert torch.equal(torch.as_tensor(a.mesh.attr("fd_falloff")),
                       torch.as_tensor(b.mesh.attr("fd_falloff")))


def test_a_take_keeps_the_eval_plan_across_pose_refits():
    """Four poses of a take through one node: only the first builds the
    patch set, the patch factorizations and the eval plan; the others
    solve against the kept factors (pu.fit_hits) and find the plan, and
    each cook equals a fresh node's cook of its pose bit for bit."""
    scene, (cfg, params) = _scene400()
    take = _Take(scene, cfg, params)
    for i, pose in enumerate(_take_poses(scene, 4)):
        res, n = take.cook(pose)
        first = int(i == 0)
        assert n == {"pu.patch_sets": first, "pu.plans": first,
                     "pu.plan_hits": 1 - first, "pu.fit_hits": 1 - first}
        _equal(res, take.fresh(pose))


def test_an_edited_rest_rig_or_a_new_mesh_rebuilds_the_plan():
    """Misses: a rest rig with one marker moved changes the patch balls, so
    it builds a new patch set, new factors and a plan; a new mesh Mesh
    changes its data id, so it builds a plan and keeps the patches and
    factors; each cook equals a fresh node's cook; the "plain" and "cuda"
    routes keep a plan each."""
    scene, (cfg, params) = _scene400()
    take = _Take(scene, cfg, params)
    pose0, pose1, pose2 = _take_poses(scene, 3)
    take.cook(pose0)

    moved = scene.rest.copy()
    moved[7] += 0.01
    take.rest = Mesh(points=moved)
    take.rest.set_attr("class", scene.classes)
    plan = take.node._plan
    res, n = take.cook(pose1)
    assert n == {"pu.patch_sets": 1, "pu.plans": 1, "pu.plan_hits": 0, "pu.fit_hits": 0}
    assert take.node._plan is not plan and take.node._plan.factors.systems is not None
    _equal(res, take.fresh(pose1))

    take.mesh = Mesh(points=scene.points.copy(), faces=scene.faces)
    res, n = take.cook(pose2)
    assert n == {"pu.patch_sets": 0, "pu.plans": 1, "pu.plan_hits": 0, "pu.fit_hits": 1}
    _equal(res, take.fresh(pose2))

    d = take.node._deformer
    pts = torch.as_tensor(scene.points)
    built = profiling.counter("pu.plans")
    out = {b: d.apply(pts, backend=b, points_key=("routes", len(pts)))[0]
           for b in ("plain", "cuda")}
    assert profiling.counter("pu.plans") - built == 2
    hits = profiling.counter("pu.plan_hits")
    for b in ("plain", "cuda"):
        assert torch.equal(d.apply(pts, backend=b, points_key=("routes", len(pts)))[0], out[b])
    assert profiling.counter("pu.plan_hits") - hits == 2
    kinds = {type(p) for k, p in d.pud.plans.items() if k[1] == ("routes", len(pts))}
    assert kinds == {pu.PUEvalPlan, cuda_pu.PUTilePlan}


def test_the_plan_cache_stays_bounded_across_a_take_with_secondaries():
    """Twelve poses, each with two new secondary meshes: the cache holds at
    most 8 plans, the main mesh's plan stays and is found every pose."""
    scene, (cfg, params) = _scene400()
    take = _Take(scene, cfg, params)
    for i, pose in enumerate(_take_poses(scene, 12)):
        secondary = [Mesh(points=scene.points[j::5] * (1.0 + 0.01 * i)) for j in (0, 1)]
        res, n = take.cook(pose, secondary=secondary)
        assert len(res.secondary) == 2
        assert n["pu.plans"] == (3 if i == 0 else 2) and n["pu.plan_hits"] == (i > 0)
        plans = take.node._deformer.pud.plans
        assert len(plans) <= 8
        assert any(k[1] == (take.mesh.pos_id, take.mesh.num_points) for k in plans)
    assert len(plans) == 8


# ----------------------------------------- the patch factors across pose refits
def _fits_equal(a, b) -> None:
    """Two fits' weights, tails and every SolveReport field bit for bit."""
    for f in ("w_hi", "w_lo", "poly_hi", "poly_lo"):
        assert torch.equal(getattr(a[0], f), getattr(b[0], f)), f
    for f, x, y in zip(pu.SolveReport._fields, a[1], b[1]):
        assert (x is None and y is None) or torch.equal(x, y), f


@pytest.mark.parametrize("markers,case", [(400, "plain"), (2000, "plain"),
                                          (400, "confidence"), (2000, "chunks"),
                                          (2000, "past_budget")])
def test_a_kept_factor_refit_equals_a_cold_fit(markers, case, monkeypatch):
    """A PUFitPlan's refits of three poses each equal a cold
    PUNodeDeformer.fit of the pose, and the one-off fit_pu of it, bit for
    bit in the weights, the tails and the report.  "confidence" takes the
    weighted ridge (lam > 0); "chunks" forces chunks of 8 patches, so
    several chunks' factors are kept and reused; "past_budget" keeps no
    factors, so every refit refactors its patches and counts no hit."""
    c = _config(markers, 24)
    scene = catalog.scene("sphere_markers")(c, SEED, torch.device("cpu"))
    cfg, params = drive.program_config(c)
    confidence = None
    if case == "confidence":
        confidence = np.random.default_rng(1).uniform(0.2, 1.0, markers).astype(np.float32)
    if case == "chunks":
        monkeypatch.setattr(pu, "_FIT_BYTES_PER_ENTRY", 10 ** 9)
    if case == "past_budget":
        monkeypatch.setattr(pu, "pu_fit_budget", 1.0)
    plan = pu.PUFitPlan(scene.rest, cfg, params, confidence=confidence, device="cpu")
    for i, pose in enumerate(_take_poses(scene, 3)):
        hits = profiling.counter("pu.fit_hits")
        got = plan.refit(pose).pud
        kept = plan.factors.systems is not None
        assert profiling.counter("pu.fit_hits") - hits == int(i > 0 and kept)
        cold = pu.PUNodeDeformer.fit(scene.rest, pose, cfg, params, confidence=confidence,
                                     device="cpu").pud
        once = pu.fit_pu(scene.rest, pose, eps="auto", confidence=confidence, device="cpu",
                         **pu.node_fit_kwargs(cfg, params))
        for want in ((cold.model, cold.report), once):
            _fits_equal((got.model, got.report), want)
    chunks = len(plan.factors.chunks())
    assert kept == (case != "past_budget")
    assert chunks == (2 if case in ("chunks", "past_budget") else 1)


# ------------------------------------------------------- the harness, traced
# The harness runs below use 2000 markers on a 24 x 24 sphere: at 400 a patch
# spans a quarter of the sphere and the program's p_err on this seed reads
# close to the cell's 5e-5 limit; at 2000 it reads 5.3e-6, and 3.3e-6 to
# 3.6e-5 on other seeds, with weights_err under 3.4e-6.  A cook takes about
# a second here, so a traced window of 5 s profiles its three requests.
TINY_MARKERS = 2000


def _tiny(tmp_path):
    """A checkout of the benchmark alone with the PU configuration at test
    sizes; the program is imported from the repository."""
    root = catalog.HERE.parent
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(catalog.HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("out", "__pycache__", "tests"))
    path = tmp_path / "gpubench" / "configs" / f"{CONFIG}.json"
    path.write_text(json.dumps(_config(TINY_MARKERS, 24)))
    mix = tmp_path / "gpubench" / "traffic" / "take.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()), frames=3)))
    return tmp_path


def _run(tmp_path, trace=True, seconds=5.0):
    tiny = _tiny(tmp_path)
    return harness.run(tiny, CELL, SEED, seconds, trace, time.perf_counter(), device="cpu",
                       base=tiny / "gpubench")


def test_traced_take_reads_the_pu_spans_and_counters(tmp_path):
    """A traced run of the cell: `correct`, and the patches, their
    factorizations and the plan of the set-up's cold cook kept
    (pu.rebuilds 0), so no patch build and no plan span in the window
    (pu.patches_ms and pu.plan_ms absent)."""
    out = _run(tmp_path)
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["pu.rebuilds"] == 0.0
    assert "pu.patches_ms" not in m and "pu.plan_ms" not in m
    assert m["cook.solve_ms"] > 0.0 and m["cook.eval_ms"] > 0.0
    assert "pu_eval_roofline" not in m      # no device time on the CPU


def test_a_cook_records_the_pu_spans_and_counters():
    """Under a profiler a PU cook's spans nest under FaceDeformNode.cook
    and its counters move: one patch set and one plan; the patch systems'
    factorization is fit.factor inside pu.fit; #7's call (the CPU twin
    here) is a pu.tiles span.  A second pose on the same node builds no
    patches and no systems: its pu.fit solves against the kept factors."""
    c = _config(400, 24)
    scene = catalog.scene("sphere_markers")(c, SEED, torch.device("cpu"))
    cfg, params = drive.program_config(c)
    take = _Take(scene, cfg, params)
    node = take.node
    pose = scene.rest + 0.01 * np.random.default_rng(0).standard_normal(scene.rest.shape)
    first = profiling._REC.next_id
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        take.cook(pose.astype(np.float32))
    recorded = [s for s in profiling.spans() if s.id >= first]
    (root,) = [s for s in recorded if s.parent is None]
    assert root.name == "FaceDeformNode.cook"
    names = {s.name for s in recorded}
    assert {"pu.patches", "pu.fit", "pu.assemble", "fit.factor", "pu.plan"} <= names
    by_id = {s.id: s for s in recorded}
    (fit,) = [s for s in recorded if s.name == "pu.fit"]
    for name in ("pu.assemble", "fit.factor"):
        assert all(by_id[s.parent] is fit for s in recorded if s.name == name)
    assert root.counters["pu.patch_sets"] == 1 and root.counters["pu.plans"] == 1
    # one chunk's factorization solved once and in each of 3 refinement sweeps,
    # what cook.refit_lu_solves would read on this route
    assert root.counters["fit.lu_solves"] == 4
    assert root.counters.get("pu.fit_hits", 0) == 0

    first = profiling._REC.next_id
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        take.cook((pose + 0.01).astype(np.float32))
    recorded = [s for s in profiling.spans() if s.id >= first]
    (root,) = [s for s in recorded if s.parent is None]
    names = {s.name for s in recorded}
    assert "pu.fit" in names
    assert not {"pu.patches", "pu.assemble", "fit.factor", "pu.plan"} & names
    assert root.counters["fit.lu_solves"] == 4 and root.counters["pu.fit_hits"] == 1
    assert root.counters.get("pu.patch_sets", 0) == 0 and root.counters.get("pu.plans", 0) == 0
    d = node._deformer.pud
    pts = torch.as_tensor(scene.points)
    plan = d.make_plan(scene.points, backend="cuda")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        cuda_pu.evaluate_pu_tiles(d.model, pts, plan, d.kernel)
    assert profiling.spans()[-1].name == "pu.tiles"


def test_new_metrics_read_none_without_the_pu_spans(tmp_path, monkeypatch):
    """A program without the PU spans and counters (the port before them)
    gives the four PU metrics nothing to read: the traced run leaves them
    out and keeps the shared ones."""
    names = ("pu.patches_ms", "pu.plan_ms", "pu.rebuilds", "pu_eval_roofline")
    run = harness.Run(unit="cooks", frames=1, latencies=[0.1], units=1, elapsed=0.1,
                      setup_s=1.0, work=["pu_fit", "pu_eval", "morph"])
    assert all(catalog.metric(n)(run) is None for n in names)
    spans, counters = profiling.spans, profiling.counters
    monkeypatch.setattr(profiling, "spans",
                        lambda: [s for s in spans() if not s.name.startswith("pu.")])
    monkeypatch.setattr(profiling, "counters",
                        lambda: {k: v for k, v in counters().items() if not k.startswith("pu.")})
    out = _run(tmp_path)
    assert out["correct"] and not set(names) & set(out["metrics"])
    assert out["metrics"]["cook.solve_ms"]["value"] > 0.0


def test_a_fault_in_the_pu_eval_fails_correct(tmp_path, monkeypatch):
    """One vertex of the PU route's output moved by 1e-3 is seen by the
    comparison that decides `correct`."""
    real = pu.PUNodeDeformer.apply

    def apply(self, *a, **k):
        p, w = real(self, *a, **k)
        p = p.clone()
        p[len(p) // 2] += 1e-3
        return p, w

    monkeypatch.setattr(pu.PUNodeDeformer, "apply", apply)
    out = _run(tmp_path, trace=False, seconds=0.6)
    assert not out["correct"], out["checks"]
