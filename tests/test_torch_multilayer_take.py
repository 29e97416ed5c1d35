"""The FLAME-topology multilayer, tangent-space configuration of the
benchmark (gpubench/configs/face1m_ml4_flame5k.json, cell
flame5k.tangent_take) at test sizes on the CPU: the port's node cook
(MULTILAYER, 4 layers, tangent, capture falloff, DBSE morph) against the
benchmark's plain multilayer reference (gpubench/reference/
multilayer_dbse.py), a mutated reference failing the same tolerances, the
kept-plan refit of a take against cold fits, the layer chain's spans and
counters, the roofline counts and the reference's imports."""

import json
import math
import shutil
import subprocess
import sys
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from facedeform_tpu_torch import Deformer
from facedeform_tpu_torch.utils import profiling
from gpubench import catalog, compare, drive, harness, inputs, peaks
from gpubench import reference as ref
from gpubench.reference import multilayer_dbse

CONFIG, CELL = "face1m_ml4_flame5k", "flame5k.tangent_take"
SEED = 2**31 + 2121
#: a ~2,000-vertex sphere and a 200-marker rig; the base radius keeps the
#: configuration's 8 mean spacings (0.4 at 5,023 markers)
N_SIDE, MARKERS = 44, 200
# The port's P against the float64 reference, over the largest displacement:
# layer 0's gaussians span the whole sphere here, so its f32 field is a
# difference of sum |w phi| ~ 29 for displacements of ~0.07, and the f32
# rounding of that sum leaves 1.1e-5 to 1.6e-5 (a plain float32 run of the
# reference itself reads 1.3e-5 to 1.5e-5); a 3-layer field misses it by
# ~10^2.5, an unprojected one by ~10^4.5.
P_TOL = 5e-5
# fd_falloff: the f32 falloff of f32 capture distances against float64, a
# few ulps of 1 (3e-8 here).
FALLOFF_TOL = 1e-6
# DBSE weights over their largest: B^T d follows P's error (2e-6 to 7e-6
# here).
WEIGHTS_TOL = 5e-5
POSE = {"amplitude": 0.05, "harmonics": 4, "wavenumber": 3.0}


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """The fits' LAPACK calls on one intra-op thread (see test_torch_eval.py:
    this torch's LAPACK faults once the count is raised after being lowered,
    so it is never raised again)."""
    torch.set_num_threads(1)


def _config(layers: int = 4, tangent: bool = True, n_side: int = N_SIDE,
            markers: int = MARKERS) -> dict:
    c = catalog.config(CONFIG)
    c["mesh"] = {"n_u": n_side, "n_v": n_side}
    c["rig"] = dict(c["rig"], markers=markers)
    c["shapes"] = dict(c["shapes"], count=4)
    c["deform_config"] = dict(c["deform_config"], layers=layers, tangent=tangent)
    c["deform_params"] = dict(c["deform_params"],
                              radius=c["deform_params"]["radius"] * math.sqrt(5023 / markers))
    return c


def _take(c: dict, device="cpu"):
    """(scene, the cell's loop on `device`): the node, the mesh with its
    tangent frame, the rest rig and the shapes the benchmark cooks."""
    scene = catalog.scene(c["scene"])(c, SEED, torch.device(device))
    mix = catalog.traffic("tangent_take")
    return scene, catalog.loop(mix["loop"]).Loop(scene, c, mix, SEED, device)


def _poses(scene, frames: int = 3, take: int = 0) -> list:
    return list(inputs.shot_poses(scene.rest, POSE, frames, 60.0, SEED, take).numpy())


def _errors(judge, rec) -> dict:
    want_p, want_f, want_w = judge.cook(rec["pose"], rec["params"])
    return {"p": compare.p_err(compare.as64(rec["P"], "cpu"), want_p, judge.points),
            "falloff": compare.max_abs(compare.as64(rec["falloff"], "cpu"), want_f),
            "weights": compare.rel_max(compare.as64(rec["weights"], "cpu"), want_w)}


def _cooked(c: dict) -> tuple:
    """(scene, the records of three frames of a take cooked by the node)."""
    scene, loop = _take(c)
    recs = []
    for pose in _poses(scene):
        res, _ = loop._cook(loop.Mesh(points=pose), loop.params)
        recs.append({"pose": pose, "params": loop.params._asdict(), "P": res.mesh.points,
                     "falloff": res.mesh.attr("fd_falloff"), "weights": res.weights})
    return scene, recs


def test_node_cook_matches_the_multilayer_reference():
    """Three frames of a take cooked by the port's node (MULTILAYER, 4
    layers, tangent, dofalloff, morphspace), each held to the plain float64
    reference on P, fd_falloff and the DBSE weights."""
    c = _config()
    cfg, _ = drive.program_config(c)
    assert cfg.n_layers == 4 and cfg.tangent and cfg.dofalloff and cfg.morphspace
    scene, recs = _cooked(c)
    judge = multilayer_dbse.Reference(scene, c, torch.device("cpu"), ref.JUDGE)
    for rec in recs:
        err = _errors(judge, rec)
        assert err["p"] < P_TOL and err["falloff"] < FALLOFF_TOL and \
            err["weights"] < WEIGHTS_TOL, err


@pytest.mark.parametrize("mutation", [{"layers": 3}, {"tangent": False}],
                         ids=["three_layers", "no_tangent"])
def test_a_mutated_reference_misses_the_tolerances(mutation):
    """The same cooks against the reference with one layer fewer, or
    without the tangent projection: P and the weights miss their
    tolerances by far, so the tolerances tell the layer chain and the
    projection apart."""
    c = _config()
    scene, recs = _cooked(c)
    mutated = dict(c, deform_config=dict(c["deform_config"], **mutation))
    wrong = multilayer_dbse.Reference(scene, mutated, torch.device("cpu"), ref.JUDGE)
    for rec in recs:
        err = _errors(wrong, rec)
        assert err["p"] > 10 * P_TOL and err["weights"] > 10 * WEIGHTS_TOL, err


def test_a_kept_plan_refit_equals_a_cold_fit():
    """Over three frames of a take, the plan of the first pose's fit
    re-solves each pose at L = 4 to the model of a cold Deformer.fit of
    it, bit for bit in every buffer, and counts four layers a fit."""
    c = _config()
    scene, _ = _take(c)
    cfg, params = drive.program_config(c)
    poses = _poses(scene)
    _, plan = Deformer.fit_with_plan(scene.rest, poses[0], cfg, params, device="cpu")
    for pose in poses:
        before = profiling.counter("fit.layers")
        got = plan.refit(pose).model
        assert profiling.counter("fit.layers") - before == 4
        cold = Deformer.fit(scene.rest, pose, cfg, params, device="cpu").model
        assert got.w_rbf.shape == (4, MARKERS, 3) and got.w_rbf_lo is not None
        for name, want in cold.named_buffers():
            have = getattr(got, name)
            assert (have is None and want is None) or torch.equal(have, want), name


def _profiled_cook(loop, pose):
    """The spans one cook recorded under a profiler."""
    first = profiling._REC.next_id
    with profile(activities=[ProfilerActivity.CPU]):
        loop._cook(loop.Mesh(points=pose), loop.params)
    return [s for s in profiling.spans() if s.id >= first]


@pytest.mark.parametrize("layers,tangent", [(4, True), (1, False)], ids=["l4_frame", "l1"])
def test_a_traced_cook_records_each_layer(layers, tangent):
    """A cold cook's layers are fit.layer spans, each holding its
    fit.assemble and fit.factor; a pose refit's are fit.layer spans under
    fit.refit, one a layer, and fit.layers counts them.  On the CPU the
    node evaluates the plain twin, which launches no kernel, so
    eval.frame_launches stays put (tests on the card count it)."""
    c = _config(layers, tangent)
    scene, loop = _take(c)
    poses = _poses(scene)
    cold = _profiled_cook(loop, poses[0])
    by_id = {s.id: s for s in cold}
    for name in ("fit.assemble", "fit.factor"):
        found = [s for s in cold if s.name == name]
        assert len(found) == layers and all(by_id[s.parent].name == "fit.layer" for s in found)
    recorded = _profiled_cook(loop, poses[1])
    (root,) = [s for s in recorded if s.parent is None]
    by_id = {s.id: s for s in recorded}
    found = [s for s in recorded if s.name == "fit.layer"]
    assert len(found) == layers and all(by_id[s.parent].name == "fit.refit" for s in found)
    assert root.counters["fit.layers"] == layers
    assert root.counters["fit.lu_solves"] == layers * (1 + drive.program_config(c)[0].n_refine)
    assert root.counters.get("eval.frame_launches", 0) == 0
    assert {"fit.layers", "eval.frame_launches"} <= set(profiling.counters())


@pytest.fixture
def card():
    """Skip unless torch sees a CUDA card (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda:0")


@pytest.mark.card
@pytest.mark.parametrize("layers,tangent", [(4, True), (1, False)], ids=["l4_frame", "l1"])
def test_frame_launches_count_the_framed_kernels_on_the_card(card, layers, tangent):
    """On a 4,098-vertex sphere (the autotune times #1 and #2) a framed
    L = 4 cook counts every launch of #1/#2 in eval.frame_launches, the
    autotune's among them; an unframed L = 1 cook counts none.  The first
    pose's cook times both kernels; the next pose keeps the choice and
    launches the chosen kernel alone."""
    c = _config(layers, tangent, n_side=64)
    scene, loop = _take(c, card)
    poses = _poses(scene)
    names = ("eval.frame_launches", "launches.evaluate_cuda", "launches.evaluate_cuda_culled",
             "fit.layers")
    # the autotune's 2 x 3 and the cook's own, then the cook's own
    for pose, want in zip(poses[:2], (7, 1)):
        before = {n: profiling.counter(n) for n in names}
        loop._cook(loop.Mesh(points=pose), loop.params)
        moved = {n: profiling.counter(n) - before[n] for n in names}
        launches = moved["launches.evaluate_cuda"] + moved["launches.evaluate_cuda_culled"]
        assert launches == want
        assert moved["eval.frame_launches"] == (launches if tangent else 0)
    assert moved["fit.layers"] == layers


def test_multilayer_roofline_counts():
    """The layer-aware counts: ml_eval's distance once a layer-0 pair, s and
    exp and the contraction a (pair, layer), the projection a vertex; and
    ml_refit's L solves and L - 1 residual products."""
    ctx = {"V": 1_000_000, "N": 5023, "S": 52, "F": 1, "L": 4,
           "layer_pairs": [5 * 10 ** 9, 10 ** 9, 3 * 10 ** 8, 10 ** 8],
           "projected": 10 ** 6, "precision": "float32", "real_bytes": 4}
    triples = 5 * 10 ** 9 + 10 ** 9 + 3 * 10 ** 8 + 10 ** 8
    ev = catalog.roofline("ml_eval")(ctx)
    assert ev.ops == ((8 * 5 * 10 ** 9 + 3 * triples + 129 * 10 ** 6, peaks.PEAK_F32),
                      (6 * triples, peaks.PEAK_TF32 / 3))
    assert ev.bytes == 68e6 + 4 * 5023 * 19
    assert ev.seconds() == pytest.approx((8 * 5e9 + 3 * triples + 129e6) / 67e12)
    rf = catalog.roofline("ml_refit")(ctx)
    rows = 5027 ** 2 + 3 * 5023 ** 2
    assert rf.ops == ((12 * rows + 6 * 3 * 5023 ** 2, peaks.PEAK_TF32 / 3),)
    assert rf.bytes == 4 * rows


def test_layer_pairs_shrink_with_the_radius():
    """The reference's needed pairs a layer, against a plain count of the
    pairs within each layer's cutoff at the active vertices: layer 0's hold
    every other layer's."""
    c = _config()
    scene = catalog.scene(c["scene"])(c, SEED, torch.device("cpu"))
    judge = multilayer_dbse.Reference(scene, c, torch.device("cpu"), ref.JUDGE)
    params = c["deform_params"]
    got = judge.layer_pairs(params)
    pts = judge.points[judge.falloff(params) > 0]
    d2 = ((pts[:, None, :] - torch.as_tensor(scene.rest).double()[None]) ** 2).sum(-1)
    want = [int((d2 <= 27.7 * (params["radius"] * 0.5 ** k) ** 2).sum()) for k in range(4)]
    assert got == want and got == sorted(got, reverse=True) and got[3] < got[0]
    w = judge.work(params, 1)
    assert w["L"] == 4 and w["projected"] == len(pts) and w["N"] == MARKERS


def test_the_multilayer_reference_imports_nothing_of_the_program():
    """The multilayer reference family, its scene and its roofline counts
    load neither the port, nor the JAX package, nor JAX."""
    code = ("import sys\n"
            "from gpubench import catalog\n"
            "catalog.reference('multilayer_dbse'); catalog.scene('sphere_slide_markers')\n"
            "catalog.roofline('ml_eval'); catalog.roofline('ml_refit')\n"
            "import gpubench.reference.multilayer_dbse\n"
            "names = {m.split('.')[0] for m in sys.modules}\n"
            "bad = names & {'facedeform_tpu_torch', 'facedeform_tpu', 'jax', 'jaxlib', 'flax'}\n"
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=catalog.HERE.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_traced_take_reads_the_layer_counts(tmp_path):
    """A traced run of the cell at test sizes: `correct`, twelve LU solves a
    refit (4 layers of 1 + 2 refinement sweeps), and no ml_eval_roofline
    (no device time, and no frame launch, on the CPU)."""
    root = catalog.HERE.parent
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(catalog.HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("out", "__pycache__", "tests"))
    (tmp_path / "gpubench" / "configs" / f"{CONFIG}.json").write_text(json.dumps(_config()))
    mix = tmp_path / "gpubench" / "traffic" / "tangent_take.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()), frames=3)))
    out = harness.run(tmp_path, CELL, SEED, 0.0, True, time.perf_counter(), device="cpu",
                      base=tmp_path / "gpubench",
                      min_requests=harness.PROFILE_FROM + harness.PROFILE_MIN)
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["cook.refit_lu_solves"] == 12.0
    assert m["cook.solve_ms"] > 0.0 and m["cook.eval_ms"] > 0.0
    assert "ml_eval_roofline" not in m
