"""The port's throughput runner (pipeline/throughput.py): result order, lanes
sharing the networks, stop-on-error, and evaluate_dataset with lanes=2
equal to the serial run and to the JAX package's, with the classical
delay-and-sum spotformer and a pass-through separation (cheap on the CPU,
and its heads match the ground truth, so the SI-SDR fields are exercised)."""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from acousticswarms_speech_tpu.pipeline import evaluate as jax_evaluate
from acousticswarms_speech_tpu_torch.models import SepNet, SpotNet
from acousticswarms_speech_tpu_torch.pipeline import evaluate
from acousticswarms_speech_tpu_torch.pipeline.joint import JointPipeline
from acousticswarms_speech_tpu_torch.pipeline.throughput import (
    PipelinedRunner,
    make_lane,
)
from acousticswarms_speech_tpu_torch.search.spotform import (
    DelayAndSumExecutor,
    SweepLane,
)
from test_torch_eval import DEV, SI_SDR_KEYS, _assert_same_results, _results
from test_torch_pipeline import (SEP_SMALL, SPOT_SMALL,
                                 one_torch_thread)  # noqa: F401 (autouse)

SCENES = ["00000", "00001"]
GRID = 0.1


class _Stub:
    def __init__(self):
        self.calls = []

    def forward(self, x):
        time.sleep(0.01)
        self.calls.append(threading.get_ident())
        return x * 2

    def make_lane(self):
        return _Stub()


def test_runner_preserves_order_and_uses_lanes():
    runner = PipelinedRunner(_Stub(), n_lanes=3)
    items = list(range(12))
    results, stats = runner.run(items)
    assert results == [2 * i for i in items]
    assert stats["n"] == 12 and len(stats["lane_utilization"]) == 3
    assert sum(len(lane.calls) for lane in runner.lanes) == 12
    assert sum(1 for lane in runner.lanes if lane.calls) >= 2


def test_lanes_share_networks_and_device():
    """make_lane shares both networks, their executors and the device, and
    gives the lane its own stage state and spot-call count."""
    pipe = JointPipeline(SpotNet(**SPOT_SMALL), SepNet(**SEP_SMALL),
                         device="cpu")
    lane = make_lane(pipe)
    assert lane.spot_model is not pipe.spot_model
    assert lane.spot_model.executor is pipe.spot_model.executor
    assert lane.spot_model.model is pipe.spot_model.model
    assert lane.sep_model is pipe.sep_model
    assert lane.sep_model.model is pipe.sep_model.model
    assert lane.device == pipe.device
    assert lane.sweep_crop_seconds == pipe.sweep_crop_seconds
    assert lane.mic_processor is None and lane.times is not pipe.times
    pipe.spot_model.calls = 7
    assert lane.spot_model.calls == 0


# A lane's own per-mixture state; every other attribute is the pipeline's.
LANE_STATE = {"spot_model", "times", "previous_config", "mic_processor"}


def test_lane_has_every_attribute_of_a_fresh_pipeline():
    """make_lane copies the pipeline's attributes (not a hand-kept list), so
    every attribute a freshly built JointPipeline has is on the lane: the
    per-mixture state fresh, everything else shared."""
    pipe = JointPipeline(SpotNet(**SPOT_SMALL), SepNet(**SEP_SMALL),
                         device="cpu")
    pipe.times[0] = 3.0
    pipe.previous_config = "a mic configuration"
    pipe.mic_processor = object()
    lane = make_lane(pipe)
    fresh = JointPipeline(SpotNet(**SPOT_SMALL), SepNet(**SEP_SMALL),
                          device="cpu")
    assert set(vars(fresh)) <= set(vars(lane))
    assert LANE_STATE <= set(vars(fresh))
    for name in set(vars(fresh)) - LANE_STATE:
        assert getattr(lane, name) is getattr(pipe, name), name
    assert lane.times == [0.0] * 5 and lane.times is not pipe.times
    assert lane.previous_config is None and lane.mic_processor is None
    assert isinstance(lane, JointPipeline)


def test_attribute_set_after_construction_reaches_lane():
    """An attribute set on the pipeline after construction (as a later
    __init__ or a caller might add one) reaches every lane of a runner."""
    pipe = JointPipeline(SpotNet(**SPOT_SMALL), SepNet(**SEP_SMALL),
                         device="cpu")
    marker = object()
    pipe.added_later = marker
    pipe.sweep_crop_seconds = 0.75
    runner = PipelinedRunner(pipe, n_lanes=3)
    assert runner.lanes[0] is pipe
    for lane in runner.lanes[1:]:
        assert lane.added_later is marker
        assert lane.sweep_crop_seconds == 0.75
        assert lane.spot_model.executor is pipe.spot_model.executor


def test_sweep_lanes_count_their_own_calls():
    """Twelve lanes (more than the cores) sweep one shared executor from
    their own threads with a short switch interval: each lane counts exactly
    its own candidates."""
    executor = DelayAndSumExecutor(device="cpu")
    lanes = [SweepLane(executor) for _ in range(12)]
    mix = torch.randn(7, 2048, generator=torch.Generator().manual_seed(0))

    def run(k):
        for _ in range(10):
            lanes[k].sweep(mix, [np.zeros(6)] * (k + 1))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(k,))
                   for k in range(len(lanes))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert [lane.calls for lane in lanes] == [10 * (k + 1) for k in range(12)]


def test_error_stops_new_claims_and_is_raised():
    """Once an item fails, no lane claims another, and run raises that
    error after the lanes stop."""
    started = []
    lock = threading.Lock()

    def work(lane, item, i):
        with lock:
            started.append(i)
        if i == 1:
            raise ValueError("item 1 failed")
        time.sleep(0.2)
        return i

    runner = PipelinedRunner(_Stub(), n_lanes=2)
    with pytest.raises(ValueError, match="item 1 failed"):
        runner.run(list(range(10)), work_fn=work)
    assert sorted(started) == [0, 1]


class _PortDelayAndSum:
    """The port's JointPipeline with the delay-and-sum spotformer and a
    pass-through separation (the localization audio)."""

    def __init__(self, inner=None):
        if inner is None:
            inner = JointPipeline.__new__(JointPipeline)
            inner.device = torch.device("cpu")
            inner.spot_model = SweepLane(DelayAndSumExecutor(device="cpu"))
            inner.sep_model = None
            inner.sweep_crop_seconds = 0.0
            inner.times = [0.0] * 5
            inner.previous_config = None
            inner.mic_processor = None
        self._inner = inner

    def setup(self, **kwargs):
        self._inner.setup(kwargs["mic_positions"], kwargs["speaker_range"],
                          grid_size=kwargs.get("grid_size", 0.05))

    @property
    def times(self):
        return self._inner.times

    def forward(self, mix):
        patches, audio_loc, srp_drop, stage1_drop, spot_times = \
            self._inner.localize_by_separation(torch.as_tensor(mix))
        return patches, audio_loc, np.asarray(audio_loc), srp_drop, \
            stage1_drop, spot_times

    def make_lane(self):
        return _PortDelayAndSum(make_lane(self._inner))


class _JaxDelayAndSum(_PortDelayAndSum):
    def __init__(self):
        from acousticswarms_speech_tpu.pipeline.joint import JointPipeline as J
        from acousticswarms_speech_tpu.search.spotform import \
            DelayAndSumExecutor as JaxDelayAndSum

        inner = J.__new__(J)
        inner.spot_model = JaxDelayAndSum(batch_size=64)
        inner.sep_model = None
        inner.sweep_crop_seconds = 0.0
        inner.times = [0.0] * 5
        inner.previous_config = None
        inner.mic_processor = None
        super().__init__(inner)

    def forward(self, mix):
        patches, audio_loc, srp_drop, stage1_drop, spot_times = \
            self._inner.localize_by_separation(mix)
        return patches, audio_loc, np.asarray(audio_loc), srp_drop, \
            stage1_drop, spot_times


def test_lanes_match_serial_and_jax(tmp_path):
    """evaluate_dataset over two dev scenes on a 0.1 m grid: lanes=2
    writes the same
    result JSONs as the serial run apart from stage_times (spot_times, the
    per-scene spot-call counts, included), and both match the JAX package's serial run (perm and
    counts equal, heads within one grid cell, SI-SDR fields within
    0.01 dB)."""
    keep = set(SCENES).__contains__
    serial = _PortDelayAndSum()
    out_serial = evaluate.evaluate_dataset(serial, DEV, str(tmp_path / "serial"),
                                           grid_size=GRID, sample_filter=keep)
    lanes_pipe = _PortDelayAndSum()
    out_lanes = evaluate.evaluate_dataset(lanes_pipe, DEV, str(tmp_path / "lanes"),
                                          grid_size=GRID, sample_filter=keep,
                                          lanes=2)
    assert out_lanes == out_serial and out_serial["tp"] > 0
    a, b = _results(tmp_path / "serial"), _results(tmp_path / "lanes")
    assert sorted(a) == sorted(b)
    for name in a:
        a[name].pop("stage_times", None)
        b[name].pop("stage_times", None)
        assert a[name] == b[name], name
    spot_total = sum(r["spot_times"] for n, r in a.items() if n != "config.json")
    assert spot_total > 0

    jax_out = jax_evaluate.evaluate_dataset(_JaxDelayAndSum(), DEV,
                                            str(tmp_path / "jax"),
                                            grid_size=GRID, sample_filter=keep)
    assert jax_out == out_serial
    got, want = _results(tmp_path / "serial"), _results(tmp_path / "jax")
    want["config.json"]["dataset"] = got["config.json"]["dataset"]
    _assert_same_results(got, want, GRID)
    assert any(p[k] for r in got.values() for p in r.get("pred", [])
               for k in SI_SDR_KEYS)
