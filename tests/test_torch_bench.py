"""The port's bench (acousticswarms_speech_tpu_torch/scripts/bench.py) on
the CPU: its card probe and error line, as tests/test_bench_probe.py holds
the JAX bench's; its scene against the JAX bench's render and the committed
fixture; the bench line's keys, with latency (not the larger of latency and
throughput) in `value`; one measurement of narrow networks; and the CLI
without a card."""
import json
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import bench as jax_bench
from acousticswarms_speech_tpu_torch import constants
from acousticswarms_speech_tpu_torch.models import SepNet, SpotNet
from acousticswarms_speech_tpu_torch.pipeline.joint import JointPipeline
from acousticswarms_speech_tpu_torch.scripts import bench
from acousticswarms_speech_tpu_torch.search import subdivide
from test_torch_pipeline import (SEP_SMALL, SPOT_SMALL, _seeded_weights,
                                 one_torch_thread)  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC = "e2e_7mic_mixtures_per_sec_per_chip"  # the JAX bench's
# every key of the JAX bench's line but its A100 estimate
JAX_LINE_KEYS = {"metric", "value", "unit", "vs_baseline",
                 "latency_mixtures_per_sec", "throughput_mixtures_per_sec",
                 "throughput_lanes", "lane_utilization", "stage_median_s",
                 "stage_iqr_s", "per_mixture_iqr_s", "setup_warmup_s",
                 "compile_cache"}


def test_probe_true_on_healthy_card(monkeypatch):
    def fake_run(*a, **k):
        return subprocess.CompletedProcess(a, 0, stdout="1\n", stderr="")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert bench._probe_card_alive() is True


def test_probe_false_on_hang(monkeypatch):
    monkeypatch.setenv("BENCH_PROBE_RETRIES", "2")
    monkeypatch.setenv("BENCH_PROBE_BACKOFF_S", "0")
    calls = []

    def fake_run(*a, **k):
        calls.append(1)
        raise subprocess.TimeoutExpired(cmd="probe", timeout=1)

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert bench._probe_card_alive() is False
    assert len(calls) == 2  # retried


def test_probe_false_on_backend_error(monkeypatch):
    monkeypatch.setenv("BENCH_PROBE_RETRIES", "1")

    def fake_run(*a, **k):
        return subprocess.CompletedProcess(
            a, 1, stdout="", stderr="torch.cuda.is_available() is False")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert bench._probe_card_alive() is False


def test_error_json_is_parseable(capsys):
    """The port's error line has the JAX bench's keys and values."""
    jax_bench._emit_error_json("no card")
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    bench._emit_error_json("no card")
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert d == want
    assert d["metric"] == METRIC and d["value"] == 0.0
    assert d["vs_baseline"] == 0.0 and d["error"] == "no card"


def test_main_exits_with_json_when_probe_fails(monkeypatch, capsys):
    monkeypatch.setattr(bench, "_probe_card_alive", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench.main([])
    assert e.value.code == 1
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert d["value"] == 0.0 and "CUDA device unavailable" in d["error"]


def test_bench_fixture_matches_jax(tmp_path, monkeypatch):
    """Both packages render the bench scene into tmp_path (FIXTURE pointed
    there in both modules): the port's render, on the CPU, equals the JAX
    bench's and the committed .bench_fixture_v2.npz within 1e-6 of the
    peak, and the written file reads back as rendered."""
    monkeypatch.setattr(jax_bench, "FIXTURE", str(tmp_path / "jax.npz"))
    monkeypatch.setattr(bench, "FIXTURE", str(tmp_path / "port.npz"))
    want = jax_bench.build_fixture()
    got = bench.build_fixture()
    committed = np.load(os.path.join(REPO, ".bench_fixture_v2.npz"))["mix"]
    assert got.dtype == np.float32 and got.shape == committed.shape == (7, 144000)
    peak = np.abs(committed).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * peak)
    np.testing.assert_allclose(got, committed, rtol=0, atol=1e-6 * peak)
    np.testing.assert_array_equal(bench.build_fixture(), got)


class _StubPipe:
    """A pipeline whose forward sleeps `delay` (three times that on its
    first call, the warm-up), with fixed stage times; lanes are stubs of
    their own, so two lanes in threads run twice the serial rate."""

    def __init__(self, delay=0.05, warmup=3.0):
        self.device = torch.device("cpu")
        self.delay, self.warmup = delay, warmup
        self.calls = 0
        self.times = [0.0] * 5
        self.mic_processor = None

    def setup(self, mic_pos, roi, cache_dir=None):
        self.mic_processor = SimpleNamespace(geom=SimpleNamespace(
            num_clusters=1))

    def forward(self, mix, profile_dir=None):
        time.sleep(self.delay * (self.warmup if self.calls == 0 else 1.0))
        self.calls += 1
        self.times = [0.001, 0.002, 0.003, 0.004, 0.005]
        return [("head",)] * 3, None, None, 0, 0, 11

    def make_lane(self):
        return _StubPipe(self.delay, warmup=1.0)


def test_measure_reports_latency_not_max():
    """The serial forward (0.05 s) is slower than two lanes together, so
    the throughput exceeds the latency rate: `value` is still
    round(1 / median forward time, 4), the throughput stands under its own
    keys, and the line has every key of the JAX bench's line (but its A100
    estimate) and the card, the precision and the timed forwards' counts."""
    pipe = _StubPipe()
    mix = np.zeros((7, 100), np.float32)
    res = bench.measure(pipe, mix, bench.MIC_POS, bench.ROI, repeats=3,
                        lanes=2, items=4, cache_dir=None)
    line = bench.bench_line(res, compile_cache=bench.cache_report(
        bench.cache_entries()), device=bench.card_info(pipe.device),
        use_bf16=True)
    assert JAX_LINE_KEYS <= set(line) and "vs_a100_est" not in line
    assert len(line["forward_s"]) == 3
    latency = round(1.0 / statistics.median(line["forward_s"]), 4)
    assert line["value"] == line["latency_mixtures_per_sec"] == latency
    assert line["throughput_mixtures_per_sec"] > 1.5 * line["value"]
    assert line["value"] != max(latency, line["throughput_mixtures_per_sec"])
    assert line["throughput_lanes"] == 2
    assert len(line["lane_utilization"]) == 2
    assert line["stage_median_s"] == [0.001, 0.002, 0.003, 0.004, 0.005]
    assert line["stage_iqr_s"] == [0.0] * 5
    assert line["vs_baseline"] == 1.0 and line["unit"] == "mixtures/s"
    assert line["metric"] == METRIC
    assert line["setup_warmup_s"] >= 0.1  # the warm-up forward's 0.15 s
    assert line["compile_cache"]["entries_added"] == 0
    assert line["device"] == {"type": "cpu", "name": None,
                              "power_limit_w": None}
    assert (line["use_bf16"], line["tf32"]) == (True, False)
    assert (line["clusters"], line["spot_calls"]) == (3, 11)
    assert line["roll_launches_per_forward"] == [0, 0, 0]
    # 1 warm-up + 1 second forward + 3 timed + 1 lane warm-up of 2, of
    # which the first lane takes at least one; then 4 items over the lanes
    assert pipe.calls >= 6
    json.dumps(line)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_measure_warmup_check(monkeypatch, device):
    """A second forward no faster than everything before it means one-time
    work would leak into the timed forwards: on the card measure raises.
    The CPU builds and tunes nothing at first use, so there it times on.
    (The stub claims the device; synchronizing is stubbed out.)"""
    monkeypatch.setattr(bench, "_sync", lambda device: None)
    pipe = _StubPipe(delay=0.05, warmup=0.0)
    pipe.device = torch.device(device)
    run = lambda: bench.measure(  # noqa: E731
        pipe, np.zeros((7, 100), np.float32), bench.MIC_POS, bench.ROI,
        repeats=1, lanes=1, items=1, cache_dir=None)
    if device == "cuda":
        with pytest.raises(RuntimeError, match="warm-up miss"):
            run()
        assert pipe.calls == 2
    else:
        assert run()["forward_s"][0] >= 0.05
        assert pipe.calls == 3


def test_measure_narrow_networks(monkeypatch):
    """measure() of the port's JointPipeline with the narrow networks of
    tests/test_torch_eval.py (weights from seeds) on 0.5 s of the bench
    scene with a 0.25 s selection crop, the scene's array and ROI and the
    committed geometry cache: repeats 2, lanes 2, items 2.  The 2 strongest
    coarse survivors are kept (MAX_BIG_PATCH), which bounds the fine sweep
    to ~2 s a forward here.  Finite rates, stage lists of 5, heads and spot
    calls, and no roll kernel launch (the CPU runs the plain version)."""
    for mod in (subdivide, constants):
        monkeypatch.setattr(mod, "MAX_BIG_PATCH", 2)
    spot = SpotNet(**dict(SPOT_SMALL, stride_list=(4, 4)))
    sep = SepNet(**dict(SEP_SMALL, stride_list=(4, 4)))
    _seeded_weights(spot, 0)
    _seeded_weights(sep, 1)
    pipe = JointPipeline(spot, sep, device="cpu", sweep_crop_seconds=0.25)
    mix = np.ascontiguousarray(bench.build_fixture()[:, 48000:72000])
    res = bench.measure(pipe, mix, bench.MIC_POS, bench.ROI, repeats=2,
                        lanes=2, items=2, cache_dir=bench.CACHE_DIR)
    assert res["value"] == res["latency_mixtures_per_sec"] > 0
    assert res["value"] == round(1.0 / statistics.median(res["forward_s"]), 4)
    assert np.isfinite(res["throughput_mixtures_per_sec"])
    assert res["throughput_lanes"] == 2 and len(res["lane_utilization"]) == 2
    for key in ("stage_median_s", "stage_iqr_s"):
        assert len(res[key]) == 5 and np.isfinite(res[key]).all()
    assert res["clusters"] >= 1 and res["spot_calls"] > 0
    assert res["roll_launches_per_forward"] == [0, 0]


def test_bench_cli_without_a_card_exits_with_the_error_line():
    """`python -m acousticswarms_speech_tpu_torch.scripts.bench` with no
    card (one probe, no back-off): exit 1, and the last stdout line is the
    error line with value 0.0.  The process imports nothing of JAX, flax,
    msgpack or the JAX package (-X importtime lists every import)."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
               BENCH_PROBE_RETRIES="1", BENCH_PROBE_BACKOFF_S="0")
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "acousticswarms_speech_tpu_torch.scripts.bench"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr[-2000:]
    d = json.loads(proc.stdout.strip().splitlines()[-1])
    assert d["value"] == 0.0 and "CUDA device unavailable" in d["error"]
    imported = [ln.rsplit("|", 1)[1].strip() for ln in proc.stderr.splitlines()
                if ln.startswith("import time:") and "|" in ln]
    assert "acousticswarms_speech_tpu_torch.ops.roll_kernel" in imported
    bad = [m for m in imported if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "msgpack", "acousticswarms_speech_tpu")]
    assert bad == []
