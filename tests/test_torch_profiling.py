"""PyTorch port: utils/profiling.py (StageTimes, stage, sync, trace)
against facedeform_tpu.utils.profiling's bookkeeping."""

import json
import os

import pytest
import torch

from facedeform_tpu.utils import profiling as jprof
from facedeform_tpu_torch.utils import profiling as tprof


def test_stage_times_bookkeeping_equals_jax():
    got, want = tprof.StageTimes(), jprof.StageTimes()
    for name, ms in (("eval", 1.5), ("solve", 4.25), ("eval", 0.5), ("morph", 2.0)):
        got.add(name, ms)
        want.add(name, ms)
    assert got.ms == want.ms and got.counts == want.counts
    assert got.summary() == want.summary() == "solve: 4.25ms, eval: 2.00ms x2, morph: 2.00ms"
    assert repr(got) == repr(want)


def test_stage_records_and_tolerates_no_times():
    times = tprof.StageTimes()
    x = torch.ones(8)
    with tprof.stage("work", times, x):
        x = x * 2
    with tprof.stage("work", times):
        pass
    with tprof.stage("untimed"):
        pass
    assert times.counts == {"work": 2} and times.ms["work"] >= 0.0
    # an exception propagates and records nothing
    with pytest.raises(RuntimeError):
        with tprof.stage("boom", times):
            raise RuntimeError("x")
    assert "boom" not in times.ms


def test_timed_stage_fences_cuda_without_a_tensor(monkeypatch):
    """A timed stage fences the card whenever CUDA is in use, also when
    its caller passes no tensor (a solve whose result does not exist
    yet); an untimed stage and a run without CUDA never fence."""
    fences = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: fences.append(a))
    times = tprof.StageTimes()
    with tprof.stage("host", times):
        pass
    assert fences == []                       # CUDA never initialized
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with tprof.stage("solve", times):
        pass
    with tprof.stage("cpu tensor", times, torch.zeros(3)):
        pass
    with tprof.stage("untimed"):
        pass
    assert fences == [(), ()]
    assert times.counts == {"host": 1, "solve": 1, "cpu tensor": 1}


def test_sync_ignores_host_values():
    tprof.sync()
    tprof.sync(torch.zeros(3), 1.0, None)


def test_trace_writes_chrome_trace_with_stage_ranges(tmp_path):
    """The stage's range, and the counters that moved inside its span as
    Chrome counter events, in trace.json; the span in spans.json."""
    logdir = str(tmp_path / "trace")
    with tprof.trace(logdir) as prof:
        with tprof.stage("the_stage"):
            torch.ones(64).sum()
            tprof.count("test.trace_counter", 3)
    path = os.path.join(logdir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "the_stage" for e in events)
    assert any(k.key == "the_stage" for k in prof.key_averages())
    counted = [e for e in events if e.get("ph") == "C" and e["name"] == "test.trace_counter"]
    assert [e["args"]["value"] for e in counted] == [0, 3]
    with open(os.path.join(logdir, "spans.json")) as f:
        exported = json.load(f)
    assert [s["name"] for s in exported["spans"]] == ["the_stage"]
    assert exported["counters"] == {"test.trace_counter": 3}
