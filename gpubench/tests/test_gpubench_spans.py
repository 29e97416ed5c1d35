"""The per-layer metrics that read the program's spans and counters
(gpubench/spans.py): a traced CPU run of each cell reads a number for each
of them that lists the cell and None for the other unit; a run without a
trace reads none of them.  On a card, one request of each cell at its own
size under torch.cuda.set_sync_debug_mode("error") raises nothing: every
host sync of the program goes through its counted helper
(facedeform_tpu_torch/utils/profiling.py)."""

import json
import time

import pytest
import torch

from gpubench import catalog, drive, harness, spans
from gpubench.device import Profile

from .conftest import HERE, ROOT

SEED = 2**31 + 4242
BENCH = catalog.benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
SPAN_METRICS = ("cook.host_syncs", "cook.sync_wait_ms", "cook.transfer_mb", "cook.autotune_ms",
                "cook.refit_lu_solves", "shot.host_syncs", "shot.fit_launch_ms_per_frame")
UNIT = {"cooks_per_s": "cooks", "shot_frames_per_s": "frames"}


def _metric(name):
    return next(m for m in BENCH["per_layer"] if m["name"] == name)


def _run(tiny, cell, trace):
    """A traced window profiles from its third request on, at least three:
    it waits for those requests however long a CPU cook takes.  An untraced
    one runs 0.4 s and at least one request."""
    seconds, wait = (0.0, harness.PROFILE_FROM + harness.PROFILE_MIN) if trace else (0.4, 1)
    return harness.run(tiny, cell, SEED, seconds, trace, time.perf_counter(), device="cpu",
                       base=tiny / "gpubench", min_requests=wait)


@pytest.fixture
def tinier(tiny):
    """The test sizes with a 100-marker TPS rig, whose CPU refit is fast
    enough for a traced window to profile some requests."""
    path = tiny / "gpubench" / "configs" / "face1m_tps_rig4k.json"
    c = json.loads(path.read_text())
    c["rig"]["markers"] = 100
    path.write_text(json.dumps(c))
    return tiny


def _fake_run(unit, requests=2, ranges=()):
    profile = Profile(t0=0.0, wall_us=1.0, ops=[], ranges=list(ranges), requests=requests)
    return harness.Run(unit=unit, frames=3, latencies=[], units=0, elapsed=1.0, setup_s=0.0,
                       work=[], profile=profile)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_each_span_metric_of_the_cell(tinier, cell):
    out = _run(tinier, cell, trace=True)
    assert out["correct"], out["checks"]
    for name in SPAN_METRICS:
        m = _metric(name)
        if cell in m["workloads"]:
            value = out["metrics"][name]["value"]
            assert value >= 0.0 and out["metrics"][name]["unit"] == m["unit"]
        else:
            assert name not in out["metrics"]
    if cell == "gauss1k.drag":
        # the refit of each drag: each layer (QNN has one) re-solves in
        # 1 + n_refine LU solves
        config = catalog.config(catalog.cell(BENCH, cell)["config"], tinier / "gpubench")
        cfg, _ = drive.program_config(config)
        assert out["metrics"]["cook.refit_lu_solves"]["value"] == cfg.n_layers * (1 + cfg.n_refine)
    if cell == "gauss1k.shot":
        assert out["metrics"]["shot.fit_launch_ms_per_frame"]["value"] > 0.0


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metric_is_none_for_the_other_unit_and_without_a_trace(name):
    read = catalog.metric(name)
    mine = UNIT[_metric(name)["moves"]]
    other = "frames" if mine == "cooks" else "cooks"
    assert read(_fake_run(other)) is None
    untraced = _fake_run(mine)
    untraced.profile = None
    assert read(untraced) is None


def test_untraced_run_reads_no_span_metric(tiny):
    out = _run(tiny, "gauss1k.drag", trace=False)
    assert not set(SPAN_METRICS) & set(out["metrics"])


def test_reader_refuses_a_trace_whose_requests_it_cannot_match():
    """Two profiled cooks but one FaceDeformNode.cook range in the trace:
    the root spans cannot be those requests'."""
    run = _fake_run("cooks", requests=2, ranges=[(spans.COOK, 0.0, 1.0)])
    with pytest.raises(RuntimeError, match="profiled requests"):
        spans.roots(run, spans.COOK)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_every_sync_of_a_request_goes_through_the_helper(card, cell):
    """One request of the cell at its full size, after its set-up, under
    the sync debug mode "error": a sync that does not go through the
    program's helper raises.  A cook's helper counts at least one sync
    (its host copy of P)."""
    from facedeform_tpu_torch.utils import profiling

    c = catalog.cell(BENCH, cell)
    config = catalog.config(c["config"], HERE)
    mix = catalog.traffic(c["traffic"], HERE)
    kind = catalog.loop(mix["loop"], HERE)
    loop = kind.Loop(catalog.scene(config["scene"], HERE)(config, SEED, card), config, mix,
                     SEED, card)
    loop.setup()
    poses = loop.poses(0) if loop.unit == "frames" else None
    torch.cuda.synchronize()
    before = profiling.counter("sync.count")
    torch.cuda.set_sync_debug_mode("error")
    try:
        if loop.unit == "cooks":
            posed, _, params = next(loop.stream)
            loop.node.cook([loop.mesh, loop.rest, posed] + loop.shapes, loop.cfg, params,
                           **mix["cook"])
        else:
            b = loop.batched
            model, _ = b.fit_frames(loop.rest_dev, poses, loop.cfg, loop.params, device=card)
            pos, w = b.apply_frames(model, loop.points, loop.dist2, loop.gate, loop.cfg,
                                    loop.params)
            (nrm,) = b.transport_frames(model, loop.points, (loop.normals,), w, loop.cfg,
                                        ("normal",))
            loop.spare[0].copy_(pos, non_blocking=True)
            loop.spare[1].copy_(nrm, non_blocking=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert loop.unit == "frames" or profiling.counter("sync.count") > before
    loop.close()
