"""The port's device code without a hand-written kernel (the room render and
convolution, the MUSIC and TOPS maps) on the card against the same code on
the CPU, at small sizes; the candidate-sharded sweep on the card (two
gloo ranks sharing it, and nccl at world size 1) against the unsharded one;
the bfloat16 executors on the card against the CPU; a profiled forward
whose trace holds the card's kernels; and a traced evaluation against the
untraced one.

Every test here carries the `gpu` marker and skips without a CUDA device
(decided inside a fixture).  This file imports neither JAX nor the JAX
package, so it runs on a machine that has neither:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_device_gpu.py
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from acousticswarms_speech_tpu_torch.constants import (  # noqa: E402
    FREQ_BINS,
    N_FFT,
)
from acousticswarms_speech_tpu_torch.data import roomsim  # noqa: E402
from acousticswarms_speech_tpu_torch.dsp import music, tops  # noqa: E402
from acousticswarms_speech_tpu_torch.dsp.geometry import \
    build_geometry  # noqa: E402
from acousticswarms_speech_tpu_torch.parallel import ranks  # noqa: E402
from acousticswarms_speech_tpu_torch.parallel.mesh import launch  # noqa: E402
from acousticswarms_speech_tpu_torch.models import SepNet, SpotNet  # noqa: E402
from acousticswarms_speech_tpu_torch.models.factory import \
    init_model  # noqa: E402
from acousticswarms_speech_tpu_torch.ops.roll_kernel import \
    roll_channels_batch_cuda  # noqa: E402
from acousticswarms_speech_tpu_torch.pipeline.joint import (  # noqa: E402
    STAGES,
    JointPipeline,
)
from acousticswarms_speech_tpu_torch.search.spotform import (  # noqa: E402
    DelayAndSumExecutor,
    SeparationInference,
    SpotformExecutor,
)
from acousticswarms_speech_tpu_torch.utils.metrics import si_sdr  # noqa: E402

pytestmark = pytest.mark.gpu

MICS = np.array([
    [2.0, 1.0, 0.02], [2.5, 1.3, 0.02], [2.5, 0.7, 0.02], [2.7, 1.0, 0.02],
    [2.3, 1.5, 0.02], [2.3, 0.5, 0.02], [2.6, 1.15, 0.02],
])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("exact", [False, True])
def test_compute_rir_card_matches_cpu(cuda, exact):
    room = np.array([6.0, 5.0, 2.4])
    src = np.array([4.1, 3.3, 0.5])
    want = roomsim.compute_rir(src, MICS[2], room, 0.3, 12, 48000,
                               exact=exact, device="cpu")
    got = roomsim.compute_rir(src, MICS[2], room, 0.3, 12, 48000,
                              exact=exact, device=cuda)
    assert got.device.type == "cuda" and got.shape == want.shape
    err = (got.cpu() - want).abs().max().item()
    assert err <= 1e-6 * want.abs().max().item(), err


def test_shoebox_card_matches_cpu(cuda):
    rng = np.random.default_rng(0)
    sigs = [rng.normal(size=24000) * 0.3 for _ in range(2)]
    out = []
    for dev in (cuda, "cpu"):
        room = roomsim.ShoeBox([6.0, 5.0, 2.4], 48000, max_order=8,
                               absorption=0.35, device=dev)
        room.add_microphone_array(MICS)
        for pos, sig in zip([[4.1, 3.3, 0.5], [1.2, 3.9, 0.3]], sigs):
            room.add_source(pos, sig)
        out.append(room.simulate())
    assert out[0].shape == out[1].shape
    assert np.abs(out[0] - out[1]).max() <= 1e-6 * np.abs(out[1]).max()


def test_music_and_tops_card_match_cpu(cuda):
    """A delayed-noise source plus sensor noise, a 0.2 m grid."""
    geom = build_geometry(MICS, [0.5, 4.5, 0.2, 4.0, 0.1, 0.62],
                          grid_size=0.2)
    rng = np.random.default_rng(1)
    src = np.array([3.6, 3.0, 0.4])
    sig = rng.normal(size=30000)
    mix = np.stack([np.roll(sig, int(round(np.linalg.norm(src - m) / 343.0
                                           * 48000))) for m in MICS])
    mix = mix + 0.05 * rng.normal(size=mix.shape)
    for fn in (music.music_map_window, tops.tops_map_window):
        want = fn(mix, geom, FREQ_BINS, N_FFT, device="cpu")
        got = fn(mix, geom, FREQ_BINS, N_FFT, device=cuda)
        assert got.shape == want.shape == (geom.num_clusters,)
        assert np.abs(got - want).max() <= 1e-8 * np.abs(want).max()


@pytest.mark.parametrize("backend,world", [("gloo", 2), ("nccl", 1)])
def test_sharded_sweep_on_the_card_matches_unsharded(cuda, backend, world):
    """37 candidates at T = 72000 through the roll kernel, delay-and-sum (no
    cuDNN, so the rows are computed alike in any batch): every rank's
    sharded sweep equals the unsharded one on the card."""
    rng = np.random.default_rng(0)
    mix = rng.normal(size=(7, 72000)).astype(np.float32)
    cands = [rng.integers(-300, 300, size=6) for _ in range(37)]
    want = DelayAndSumExecutor(device=cuda).sweep(mix, cands, strict=1,
                                                  with_similarity=True)
    rows = want.gather(range(37), quantize=False)
    got = launch(ranks.sweep, world, backend, "cuda",
                 args=(None, mix, cands, 1, True), deadline_s=300)
    assert len(got) == world
    for res in got:
        np.testing.assert_allclose(res["powers"], want.powers, rtol=1e-6)
        np.testing.assert_allclose(res["powers_win"], want.powers_win,
                                   rtol=1e-6)
        np.testing.assert_allclose(res["sisdr_mat"], want.sisdr_mat,
                                   rtol=1e-5, atol=1e-5)
        for k in range(37):
            np.testing.assert_allclose(res["waveforms"][k], rows[k],
                                       rtol=1e-6, atol=1e-7)


# Narrow networks (the CPU tests' widths), weights from init_model's seed.
SPOT_SMALL = dict(channels=8, encoder_channels=32, residual_layers=1,
                  num_head=2, ffw_dim=16, num_transformer_layers=1)
SEP_SMALL = dict(max_speakers=5, channels=8, encoder_channels=32,
                 residual_layers=1, num_head=2, ffw_dim=16,
                 bottleneck_layers=1, bottleneck_ksize=7)


def test_traced_evaluation_on_the_card_matches_untraced(cuda, tmp_path,
                                                        monkeypatch):
    """evaluate_dataset of dev scene 00000 on the card with the narrow
    networks (two U-Net levels, a 0.25 s selection crop, a 0.1 m grid, the
    4 strongest coarse survivors) and cuDNN held to deterministic
    algorithms, untraced and then with power tracing on: the same result
    JSON but for stage times (so the same heads), and a trace whose
    nms_summary holds the pair SI-SDR matrix."""
    from acousticswarms_speech_tpu_torch import constants
    from acousticswarms_speech_tpu_torch.pipeline.evaluate import \
        evaluate_dataset
    from acousticswarms_speech_tpu_torch.search import power_trace, subdivide

    for mod in (constants, subdivide):
        monkeypatch.setattr(mod, "MAX_BIG_PATCH", 4)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dev = os.path.join(repo, ".devdata_v2", "test")
    pipe = JointPipeline(
        init_model(SpotNet(**SPOT_SMALL, stride_list=(4, 4)), seed=0),
        init_model(SepNet(**SEP_SMALL, stride_list=(4, 4)), seed=1),
        device=cuda, sweep_crop_seconds=0.25)
    results = {}
    for name, traced in (("untraced", False), ("traced", True)):
        monkeypatch.setattr(power_trace, "ENABLED", traced)
        power_trace.drain()
        folder = tmp_path / name
        evaluate_dataset(pipe, dev, str(folder), grid_size=0.1,
                         sample_filter={"00000"}.__contains__)
        with open(folder / "result_00000.json") as f:
            results[name] = json.load(f)
        results[name].pop("stage_times")
    assert results["traced"] == results["untraced"]
    assert not (tmp_path / "untraced" / "trace_00000.json").exists()
    with open(tmp_path / "traced" / "trace_00000.json") as f:
        records = json.load(f)["records"]
    summary = [r for r in records if r["stage"] == "nms_summary"]
    assert len(summary) == 1 and summary[0]["pair_sisdr"] is not None
    heads = results["traced"]["pred"] + results["traced"]["false_positive"]
    assert heads and len(summary[0]["pair_sisdr"]) == summary[0]["n_in"]


def test_bf16_executors_card_match_cpu(cuda):
    """SpotformExecutor and SeparationInference with use_bf16 on the card
    against the same code on the CPU, the narrow networks on 8192 samples:
    bfloat16 rounds after each op in other places on each device (cuDNN's
    fused epilogues), so powers within 2e-2 relative and every waveform at
    >= 20 dB SI-SDR against the CPU's."""
    rng = np.random.default_rng(0)
    mix = rng.normal(size=(7, 8192)).astype(np.float32)
    cands = [rng.integers(-40, 40, size=6) for _ in range(12)]
    spot = init_model(SpotNet(**SPOT_SMALL), seed=0)
    res = [SpotformExecutor(spot, use_bf16=True, device=dev).sweep(
        mix, cands, strict=1) for dev in (cuda, "cpu")]
    np.testing.assert_allclose(res[0].powers, res[1].powers, rtol=2e-2)
    np.testing.assert_allclose(res[0].powers_win, res[1].powers_win,
                               rtol=2e-2)
    rows = [r.gather(range(12), quantize=False) for r in res]
    for k in range(12):
        assert si_sdr(rows[0][k], rows[1][k]) >= 20.0, k
    sep = init_model(SepNet(**SEP_SMALL), seed=1)
    out = [SeparationInference(sep, use_bf16=True, device=dev).infer_sample(
        mix, cands[:3]) for dev in (cuda, "cpu")]
    assert out[0].shape == out[1].shape == (3, 8192)
    for k in range(3):
        assert si_sdr(out[0][k], out[1][k]) >= 20.0, k


def test_profiled_forward_trace_holds_device_kernels(cuda, tmp_path):
    """forward(profile_dir=...) on the card, delay-and-sum search and the
    narrow SepNet on 1 s of the bench scene: the trace holds the five stage
    spans and the card's kernels, among them as many roll kernels as the
    kernel's counter gave."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mix = np.load(os.path.join(repo, ".bench_fixture_v2.npz"))["mix"]
    mix = mix[:, 48000:96000].astype(np.float32)
    pipe = JointPipeline(DelayAndSumExecutor(device=cuda),
                         init_model(SepNet(**SEP_SMALL), seed=1), device=cuda)
    pipe.setup([[3.0, 1.0, 0.02], [3.5, 1.3, 0.02], [3.5, 0.7, 0.02],
                [3.7, 1.0, 0.02], [3.3, 1.5, 0.02], [3.3, 0.5, 0.02],
                [3.6, 1.15, 0.02]], [1.0, 6.2, 0.2, 5.4, 0.1, 0.62],
               cache_dir=os.path.join(repo, ".bench_cache"))
    pipe.forward(mix)
    roll_channels_batch_cuda.launches = 0
    pipe.forward(mix, profile_dir=str(tmp_path))
    launches = roll_channels_batch_cuda.launches
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    # host spans; the card's copies of them are "gpu_user_annotation"
    assert sorted(e["name"] for e in events if e.get("name") in STAGES
                  and e.get("cat") == "user_annotation") == sorted(STAGES)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels, "the trace holds no device kernel"
    rolls = sum("roll_channels_kernel" in e["name"] for e in kernels)
    assert rolls == launches > 0


def test_lane_sweeps_carry_their_own_events(cuda):
    """Pipeline lanes (pipeline/throughput.py) share the executor; each
    sweep records its own completion event, which is_ready() polls until
    the card is done, and each lane counts its own spot calls."""
    from acousticswarms_speech_tpu_torch.pipeline.throughput import make_lane

    pipe = JointPipeline(DelayAndSumExecutor(device=cuda), None, device=cuda)
    lane = make_lane(pipe)
    assert lane.spot_model.executor is pipe.spot_model.executor
    assert lane.sep_model is None and lane.device == pipe.device
    rng = np.random.default_rng(0)
    mix = rng.normal(size=(7, 72000)).astype(np.float32)
    cands = [rng.integers(-300, 300, size=6) for _ in range(64)]
    a = pipe.spot_model.sweep(mix, cands, strict=0)
    b = lane.spot_model.sweep(mix, cands[:5], strict=1)
    assert None is not a._done is not b._done is not None
    torch.cuda.synchronize()
    assert a.is_ready() and b.is_ready()
    assert (pipe.spot_model.calls, lane.spot_model.calls) == (64, 5)
