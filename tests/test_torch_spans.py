"""The port's spans and counters (utils/spans.py) on the CPU, with the
delay-and-sum search and the narrow SepNet on 0.5 s of the bench scene
(at most two coarse survivors):
one record per completed forward with the stage, search, wait and set-up
spans and the stage-1 overlap's counts; the same spans in a profiler's
trace; one record per mixture on each of two lanes; nothing published by a
forward that raises; and outputs equal to the bit to the benchmark's frozen
copy of the main path from before the spans."""
import glob
import json
import os
import threading

import numpy as np
import pytest

from acousticswarms_speech_tpu_torch.models import SepNet, SpotNet
from acousticswarms_speech_tpu_torch.pipeline.joint import STAGES, JointPipeline
from acousticswarms_speech_tpu_torch.pipeline.mic_array import MicArray
from acousticswarms_speech_tpu_torch.pipeline.throughput import PipelinedRunner
from acousticswarms_speech_tpu_torch.search.spotform import (
    DelayAndSumExecutor, SeparationInference, SweepResult)
from acousticswarms_speech_tpu_torch.utils import spans
from test_torch_pipeline import (MIC_POS, REPO, ROI, SEP_SMALL, SPOT_SMALL,
                                 _fixture, _seeded_weights,
                                 one_torch_thread)  # noqa: F401 (autouse)

SEARCH = ("search.subdivide", "device.wait")
ARRAY = ("array.geometry", "array.steering_table")
CACHE = os.path.join(REPO, ".bench_cache")


@pytest.fixture(autouse=True)
def two_survivors(monkeypatch):
    """At most two coarse survivors, in the port and in the frozen copy,
    which keeps a forward near a second on a CPU."""
    from acousticswarms_speech_tpu_torch.search import subdivide
    from benchmark.reference import subdivide as frozen

    monkeypatch.setattr(subdivide, "MAX_BIG_PATCH", 2)
    monkeypatch.setattr(frozen, "MAX_BIG_PATCH", 2)


@pytest.fixture(scope="module")
def sep():
    model = SepNet(**SEP_SMALL)
    _seeded_weights(model, 1)
    return model


def _pipe(sep_model):
    pipe = JointPipeline(DelayAndSumExecutor(device="cpu"), sep_model,
                         device="cpu", sweep_crop_seconds=0.25)
    _setup(pipe)
    return pipe


def _setup(pipe):
    pipe.setup(MIC_POS, ROI, cache_dir=CACHE, grid_size=0.05)


def _names(record):
    return [n for n, *_ in record.spans]


def _seconds(record, name):
    return sum(e - s for n, _, s, e in record.spans if n == name) * 1e-9


def _overlap(monkeypatch, not_ready):
    """The coarse sweep reads as busy for its first `not_ready` polls, so
    that many candidates are subdivided beside it (on the CPU a sweep is
    done when it returns); returns what stage 2 then saw, counted from its
    arguments: its survivors and those the overlap subdivided."""
    polls, seen = [0], {}
    real_small = MicArray.spotform_small_patch_parallel

    def is_ready(self):
        polls[0] += 1
        return polls[0] > not_ready

    def small(self, mix, candidates, *args, subdivided=None, **kwargs):
        seen.update(survivors=len(candidates),
                    reused=sum(id(p) in subdivided for p in candidates),
                    overlap=len(subdivided))
        return real_small(self, mix, candidates, *args,
                          subdivided=subdivided, **kwargs)

    monkeypatch.setattr(SweepResult, "is_ready", is_ready)
    monkeypatch.setattr(MicArray, "spotform_small_patch_parallel", small)
    return seen


def test_forward_publishes_one_record(sep, monkeypatch):
    """(a) One forward, one record: each stage span once and `times[i]`
    its duration to the bit, the subdivisions and waits inside the stages,
    the set-up's spans, the overlap's counts as stage 2 saw them, and the
    lane's candidates."""
    seen = _overlap(monkeypatch, not_ready=3)
    pipe = _pipe(sep)
    calls = pipe.spot_model.calls
    patches, *_ = pipe.forward(_fixture(48000, 24000))
    record = pipe.last_record
    assert len(patches) >= 1 and seen["survivors"] >= 1
    assert spans.records()[-1] is record
    assert record.candidates == pipe.spot_model.calls - calls > 0
    names = _names(record)
    for name in STAGES + ARRAY:
        assert names.count(name) == 1, name
    stage = {n: (s, e) for n, _, s, e in record.spans if n in STAGES}
    for i, name in enumerate(STAGES):
        s, e = stage[name]
        assert pipe.times[i] == (e - s) * 1e-9
    assert seen["overlap"] == 3
    assert record.counters == {"search.candidates": record.candidates,
                               "search.subdivided_overlap": 3,
                               "search.survivors": seen["survivors"],
                               "search.survivors_reused": seen["reused"]}
    assert names.count("search.subdivide") == \
        3 + seen["survivors"] - seen["reused"]
    assert names.count("device.wait") >= 4  # the map, 2 sweeps, separation
    parents = {}
    for n, parent, s, e in record.spans:
        parents.setdefault(n, set()).add(parent)
        if n in SEARCH:  # inside its stage, and in no other new span
            assert stage[parent][0] <= s <= e <= stage[parent][1]
    assert parents["search.subdivide"] == {STAGES[1], STAGES[2]}
    assert parents["device.wait"] <= set(STAGES)
    assert {p for n in STAGES + ARRAY for p in parents[n]} == {None}
    assert sum(_seconds(record, n) for n in SEARCH) <= sum(pipe.times)


def test_spans_in_the_profiler_trace(sep, tmp_path):
    """(b) Under `forward(profile_dir=...)` every search and wait span is a
    user annotation of the trace, inside its stage's, and the record's
    sums per name agree with the trace's: one clock, two views."""
    pipe = _pipe(sep)
    pipe.forward(_fixture(48000, 24000), profile_dir=str(tmp_path))
    record = pipe.last_record
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"]
    stages = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
              if e["name"] in STAGES}
    assert set(stages) == set(STAGES)
    for name in SEARCH:
        marks = [e for e in events if e["name"] == name]
        assert len(marks) == _names(record).count(name) > 0
        for e in marks:
            assert any(s0 - 1 <= e["ts"] and e["ts"] + e["dur"] <= s1 + 1
                       for s0, s1 in stages.values()), e
        traced = sum(e["dur"] for e in marks) * 1e-6
        assert abs(traced - _seconds(record, name)) <= \
            0.02 * _seconds(record, name) + 1e-3


def test_setup_spans_go_with_the_next_forward_only(sep):
    """(c) The set-up's spans ride on the forward after it, once; a
    forward on the same array (its `setup` a no-op) carries none."""
    pipe = _pipe(sep)
    mix = _fixture(48000, 24000)
    pipe.forward(mix)
    first = pipe.last_record
    _setup(pipe)
    pipe.forward(mix)
    second = pipe.last_record
    assert first is not second
    assert [n for n in _names(first) if n in ARRAY] == list(ARRAY)
    assert not set(ARRAY) & set(_names(second))
    assert second.candidates == first.candidates > 0


def test_lanes_keep_records_of_their_own(sep):
    """(d) Two lanes of `PipelinedRunner` over four mixtures: one record
    per mixture, each with its own lane's candidates and stages, and each
    lane's set-up on its own first forward."""
    pipe = JointPipeline(DelayAndSumExecutor(device="cpu"), sep, device="cpu",
                         sweep_crop_seconds=0.25)
    runner = PipelinedRunner(pipe, n_lanes=2, setup_fn=_setup)

    def work(lane, mix, i):
        calls = lane.spot_model.calls
        lane.forward(mix)
        return (id(lane), threading.get_ident(), lane.last_record,
                lane.spot_model.calls - calls)

    mixtures = [_fixture(start, 24000) for start in (0, 24000, 48000, 72000)]
    results, _ = runner.run(mixtures, work_fn=work)
    records = [r[2] for r in results]
    assert len({id(r) for r in records}) == 4
    logged = spans.records()
    assert all(any(r is x for x in logged) for r in records)
    for _, _, record, calls in results:
        assert record.candidates == calls
        for name in STAGES:
            assert _names(record).count(name) == 1
    for lane in {r[0] for r in results}:
        own = [r[2] for r in results if r[0] == lane]
        assert sum(_names(r).count("array.geometry") for r in own) == 1


def test_failed_forward_publishes_nothing(sep):
    """(e) A forward that raises (here: no separation network for its
    heads) publishes nothing, and its spans and the set-up's before it go
    with it; the log keeps the latest LOG_SIZE records."""
    pipe = JointPipeline(DelayAndSumExecutor(device="cpu"), None, device="cpu",
                         sweep_crop_seconds=0.25)
    _setup(pipe)
    mix = _fixture(48000, 24000)
    before = spans.records()
    with pytest.raises(ValueError, match="no separation network"):
        pipe.forward(mix)
    after = spans.records()
    assert len(after) == len(before) and all(
        a is b for a, b in zip(after, before))
    assert pipe.last_record is None
    pipe.sep_model = SeparationInference(sep, device="cpu")
    pipe.forward(mix)
    names = _names(pipe.last_record)
    assert [n for n in names if n in STAGES] == list(STAGES)
    assert not set(ARRAY) & set(names)

    fresh = [spans.Record() for _ in range(spans.LOG_SIZE + 3)]
    for r in fresh:
        spans.publish(r)
    log = spans.records()
    assert len(log) == spans.LOG_SIZE
    assert all(a is b for a, b in zip(log, fresh[3:]))


def test_span_outside_a_record_is_a_mark_only():
    """Outside a record a span still times its block and a count is lost;
    a record takes only its own thread's spans."""
    with spans.span("x") as s:
        spans.count("n")
    assert s.seconds >= 0.0
    record = spans.Record()
    with spans.recording(record):
        def other():
            with spans.span("other"):
                spans.count("n")

        t = threading.Thread(target=other)
        t.start()
        t.join(10)
        assert not t.is_alive()
        with spans.span("outer"):
            with spans.span("inner"):
                spans.count("n", 2)
    assert [(n, p) for n, p, *_ in record.spans] == [("inner", "outer"),
                                                     ("outer", None)]
    assert record.counters == {"n": 2}


def test_outputs_equal_the_frozen_main_path():
    """(f) The narrow SpotNet and SepNet on 0.5 s of the bench scene: the
    port with its spans gives what the benchmark's frozen copy of the main
    path from before them gives (benchmark/reference/, plain torch and
    NumPy), to the bit."""
    from benchmark.reference.pipeline import ReferencePipeline

    spot, sep_model = SpotNet(**SPOT_SMALL), SepNet(**SEP_SMALL)
    _seeded_weights(spot, 0)
    _seeded_weights(sep_model, 1)
    mix = _fixture(48000, 24000)
    port = JointPipeline(spot, sep_model, device="cpu",
                         sweep_crop_seconds=0.25)
    port.setup(MIC_POS, ROI, grid_size=0.1)
    patches, audio_loc, audio, *_ = port.forward(mix)
    ref = ReferencePipeline(spot, sep_model, device="cpu",
                            sweep_crop_seconds=0.25)
    ref.setup(MIC_POS, ROI, grid_size=0.1)
    want = ref.forward(mix)
    assert len(patches) == len(want["heads"]) >= 1
    np.testing.assert_array_equal(port.mic_processor.srp.srp_map,
                                  want["srp_map"])
    for got, exp in zip(patches, want["heads"]):
        np.testing.assert_array_equal(got[4]["localization_offset"],
                                      exp[4]["localization_offset"])
    np.testing.assert_array_equal(audio_loc, want["audio_loc"])
    np.testing.assert_array_equal(audio, want["audio"])
    assert port.last_record.candidates == want["spot_calls"]
