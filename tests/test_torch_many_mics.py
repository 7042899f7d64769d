"""The many-microphone configuration (M = 10) of the port against the JAX
package, on the CPU: the SRP map, the SpotNet sweep, separation,
JointPipeline.forward and evaluate_dataset.

The array and search range are those of tests/test_many_mics.py.  Every
network is narrow (the pipeline tests' widths with n_mics = 10) and both
packages get the same weights from a numpy seed (`_seeded_weights`)."""
import argparse
import json
import os

import numpy as np

from acousticswarms_speech_tpu.constants import FS, SPEED_OF_SOUND
from acousticswarms_speech_tpu.dsp.geometry import build_geometry as jax_build_geometry
from acousticswarms_speech_tpu.models import SepNet as JaxSepNet
from acousticswarms_speech_tpu.models import SpotNet as JaxSpotNet
from acousticswarms_speech_tpu.ops.srp import SrpMapComputer as JaxSrpMapComputer
from acousticswarms_speech_tpu.pipeline import evaluate as jax_evaluate
from acousticswarms_speech_tpu.pipeline.joint import JointPipeline as JaxPipeline
from acousticswarms_speech_tpu.search import spotform as jax_spotform
from acousticswarms_speech_tpu.utils.metrics import si_sdr
from acousticswarms_speech_tpu_torch.data import generate_dataset, voicegen
from acousticswarms_speech_tpu_torch.dsp.geometry import build_geometry
from acousticswarms_speech_tpu_torch.models import SepNet, SpotNet
from acousticswarms_speech_tpu_torch.ops.srp import SrpMapComputer
from acousticswarms_speech_tpu_torch.pipeline import evaluate
from acousticswarms_speech_tpu_torch.pipeline.joint import JointPipeline
from acousticswarms_speech_tpu_torch.search import spotform
from test_torch_eval import (_assert_same_results, _results,
                             small_search)  # noqa: F401 (fixture)
from test_torch_pipeline import (SEP_SMALL, SPOT_SMALL, _seeded_weights,
                                 one_torch_thread)  # noqa: F401 (autouse)

M = 10
# tests/test_many_mics.py's array: mic 0 at the origin, nine on a half
# circle of radius 0.35 m around (0.35, 0); its search range.
MIC = np.concatenate([
    np.stack([0.35 + 0.35 * np.cos(np.linspace(0, np.pi, M - 1)),
              0.35 * np.sin(np.linspace(0, np.pi, M - 1))], axis=1),
    np.zeros((M - 1, 1)) + 0.02,
], axis=1)
MIC = np.concatenate([np.array([[0.0, 0.0, 0.02]]), MIC])[:M]
ROI = [-1.5, 2.5, -1.5, 1.5, 0.1, 0.5]
GRID = 0.1
CROP_S = 0.25

SPOT_10 = dict(SPOT_SMALL, n_mics=M)
SEP_10 = dict(SEP_SMALL, n_mics=M)
# two U-Net levels, so that the JAX package compiles the sweeps quickly
SHALLOW = dict(stride_list=(4, 4))


def _delayed_scene(sources, T, seed):
    """(M, T) float32: each source an amplitude-modulated noise burst,
    reaching each mic after its direct-path delay (whole samples) with a
    1 / (1 + d) gain."""
    rng = np.random.default_rng(seed)
    mix = np.zeros((M, T))
    for src in sources:
        sig = rng.normal(size=T) * 0.3
        sig *= np.clip(np.sin(2 * np.pi * rng.uniform(1, 3) * np.arange(T) / FS
                              + rng.uniform(0, 6)), 0, None)
        for m in range(M):
            d = np.linalg.norm(np.asarray(src) - MIC[m])
            mix[m] += np.roll(sig, int(round(d / SPEED_OF_SOUND * FS))) / (1 + d)
    return mix.astype(np.float32)


def _same_nets(kind, params, seed):
    """A port network and the JAX one with the same seeded weights."""
    port_cls, jax_cls = {"spot": (SpotNet, JaxSpotNet),
                         "sep": (SepNet, JaxSepNet)}[kind]
    net = port_cls(**params)
    return net, jax_cls(**params), _seeded_weights(net, seed)


def test_10mic_srp_localizes_and_matches_jax():
    """The port's counterpart of tests/test_many_mics.py::
    test_10mic_srp_localizes (one source, 0.5 s, a 0.1 m grid): the peak
    within 0.3 m of the source, the geometry equal to the JAX package's,
    and the SRP map within 1e-4 of the JAX map's peak."""
    geom = build_geometry(MIC, ROI, grid_size=GRID)
    want_geom = jax_build_geometry(MIC, ROI, grid_size=GRID)
    assert geom.cluster_offsets.shape[1] == M - 1
    np.testing.assert_array_equal(geom.grids, want_geom.grids)
    np.testing.assert_array_equal(geom.cluster_offsets,
                                  want_geom.cluster_offsets)
    src = np.array([1.8, 0.9, 0.3])
    T = 24000
    sig = np.random.default_rng(0).normal(size=T) * 0.3
    mix = np.zeros((M, T))
    for m in range(M):
        d = np.linalg.norm(src - MIC[m])
        mix[m] = np.roll(sig, int(round(d / SPEED_OF_SOUND * FS))) / (1 + d)
    mix = mix.astype(np.float32)
    bins = np.arange(2, 60)
    got = SrpMapComputer(geom.grids, MIC, bins, FS, 1024, device="cpu")(
        mix, 24000).numpy()
    want = np.asarray(JaxSrpMapComputer(want_geom.grids, MIC, bins, FS, 1024)(
        mix, 24000))
    assert got.shape == want.shape == (len(geom.grids),)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    best = geom.grids[np.argmax(got)]
    assert np.linalg.norm(best[:2] - src[:2]) < 0.3, best


def test_10mic_spotform_sweep_matches_jax():
    """SpotformExecutor.sweep at M = 10 (narrow SpotNet, five candidates of
    9 TDoA offsets on 2048 samples, the fine sweep's window): powers and
    windowed powers to 1e-4 relative, the SI-SDR matrix to 0.01 dB."""
    net, jax_net, params = _same_nets("spot", dict(SPOT_10, **SHALLOW), 0)
    rng = np.random.default_rng(1)
    mix = rng.normal(size=(M, 2048)).astype(np.float32)
    offsets = [rng.integers(-20, 20, M - 1).astype(float) for _ in range(5)]
    want = jax_spotform.SpotformExecutor(jax_net, params).sweep(
        mix, offsets, strict=1, with_similarity=True)
    got = spotform.SpotformExecutor(net, device="cpu").sweep(
        mix, offsets, strict=1, with_similarity=True)
    assert got.powers.shape == (5,) and got.sisdr_mat.shape == (5, 5)
    np.testing.assert_allclose(got.powers, want.powers, rtol=1e-4)
    np.testing.assert_allclose(got.powers_win, want.powers_win, rtol=1e-4)
    np.testing.assert_allclose(got.sisdr_mat, want.sisdr_mat, atol=1e-2)


def test_10mic_separation_matches_jax():
    """SeparationInference.infer_sample at M = 10 (narrow SepNet, 20 input
    channels, two speakers at seeded TDoA offsets): each output within 1e-4
    of the JAX output's peak."""
    net, jax_net, params = _same_nets("sep", dict(SEP_10, **SHALLOW), 1)
    rng = np.random.default_rng(2)
    mix = rng.normal(size=(M, 2048)).astype(np.float32)
    offsets = [rng.integers(-20, 20, M - 1).astype(float) for _ in range(2)]
    want = jax_spotform.SeparationInference(jax_net, params).infer_sample(
        mix, offsets)
    got = spotform.SeparationInference(net, device="cpu").infer_sample(
        mix, offsets)
    assert got.shape == want.shape == (2, 2048) and np.isfinite(got).all()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_10mic_joint_pipeline_matches_jax(tmp_path):
    """JointPipeline.forward of both packages on a two-talker scene at
    M = 10 (0.5 s, a 0.25 s selection crop, a 0.1 m grid), narrow networks
    with the same seeded weights: the same heads within one grid cell,
    audio at >= 30 dB SI-SDR and the same spot calls."""
    spot, jax_spot, spot_params = _same_nets("spot", SPOT_10, 0)
    sep, jax_sep, sep_params = _same_nets("sep", SEP_10, 1)
    mix = _delayed_scene([[1.8, 0.9, 0.3], [-0.8, -0.9, 0.35]], 24000, seed=3)
    out = {}
    for name, pipe in (
            ("jax", JaxPipeline(jax_spot, spot_params, jax_sep, sep_params,
                                sweep_crop_seconds=CROP_S)),
            ("port", JointPipeline(spot, sep, device="cpu",
                                   sweep_crop_seconds=CROP_S))):
        pipe.setup(MIC, ROI, cache_dir=str(tmp_path / name), grid_size=GRID)
        patches, audio_loc, audio, *_ = pipe.forward(mix)
        out[name] = (patches, np.asarray(audio_loc), np.asarray(audio),
                     pipe.stage_metrics()["spotform_calls"])
    (pj, lj, aj, nj), (pt, lt, at, nt) = out["jax"], out["port"]
    assert len(pt) == len(pj) >= 1
    for hj, ht in zip(pj, pt):
        dj, dt = np.asarray(hj[0].center_pos()), np.asarray(ht[0].center_pos())
        assert np.abs(dj[:2] - dt[:2]).max() <= GRID, (dj, dt)
    assert at.shape == aj.shape == (len(pj), mix.shape[1])
    for k in range(len(pj)):
        assert si_sdr(at[k], aj[k]) >= 30.0, k
        assert si_sdr(lt[k], lj[k]) >= 30.0, k
    assert nt == nj


def test_10mic_evaluate_dataset_matches_jax(tmp_path, small_search):
    """evaluate_dataset of both packages on one 10-mic scene that the
    port's generator renders on the CPU (two talkers, 1 s, max_order 4):
    the same config.json, result keys, perm, counts and spot calls, heads
    within one grid cell and SI-SDR fields within 0.01 dB."""
    bank = str(tmp_path / "voices")
    voicegen.generate_voice_bank(bank, n_speakers=3, clips_per_speaker=1,
                                 duration=1.0, seed=0)
    voices = [os.path.join(bank, d) for d in sorted(os.listdir(bank))]
    data = tmp_path / "data"
    args = argparse.Namespace(
        output_path=str(data), n_mics=M, n_voices_min=2, n_voices_max=2,
        sr=48000, duration=1.0, dimensions=3, max_order=4, max_order_cap=150,
        sample_rt60=False, generate_colocated=False, device="cpu")
    generate_dataset.generate_sample(voices, args, "test", 0,
                                     np.random.RandomState(4))
    scene = data / "test" / "00000"
    assert len(list(scene.glob("mic*_mixed.wav"))) == M
    with open(scene / "metadata.json") as f:
        assert sum(k.startswith("mic") for k in json.load(f)) == M

    spot, jax_spot, spot_params = _same_nets("spot", dict(SPOT_10, **SHALLOW), 0)
    sep, jax_sep, sep_params = _same_nets("sep", dict(SEP_10, **SHALLOW), 1)
    jax_pipe = JaxPipeline(jax_spot, spot_params, jax_sep, sep_params,
                           sweep_crop_seconds=CROP_S)
    port_pipe = JointPipeline(spot, sep, device="cpu", sweep_crop_seconds=CROP_S)
    dataset = str(data / "test")
    want_counts = jax_evaluate.evaluate_dataset(
        jax_pipe, dataset, str(tmp_path / "jax"), grid_size=GRID)
    got_counts = evaluate.evaluate_dataset(
        port_pipe, dataset, str(tmp_path / "port"), grid_size=GRID)
    assert got_counts == want_counts
    assert sum(want_counts.values()) > 0
    _assert_same_results(_results(tmp_path / "port"), _results(tmp_path / "jax"),
                         GRID)
