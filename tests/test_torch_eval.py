"""The port's evaluation slice against the JAX package's, on the CPU:
permutation matching, scene reading, BSS-Eval, the degradation proxy,
metrics, the analyzer, and evaluate_dataset end to end on two dev scenes
with narrow networks whose weights come from a seed."""
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

import acousticswarms_speech_tpu.constants as jax_constants
from acousticswarms_speech_tpu.models import SepNet as JaxSepNet
from acousticswarms_speech_tpu.models import SpotNet as JaxSpotNet
from acousticswarms_speech_tpu.pipeline import evaluate as jax_evaluate
from acousticswarms_speech_tpu.pipeline.joint import JointPipeline as JaxPipeline
from acousticswarms_speech_tpu.search import subdivide as jax_subdivide
from acousticswarms_speech_tpu.utils import bss_eval as jax_bss_eval
from acousticswarms_speech_tpu.utils.codec import OpusCodec as JaxOpusCodec
import acousticswarms_speech_tpu_torch.constants as constants
from acousticswarms_speech_tpu_torch.models import SepNet, SpotNet
from acousticswarms_speech_tpu_torch.pipeline import analyze, evaluate
from acousticswarms_speech_tpu_torch.pipeline.joint import JointPipeline
from acousticswarms_speech_tpu_torch.search import subdivide
from acousticswarms_speech_tpu_torch.utils import bss_eval
from acousticswarms_speech_tpu_torch.utils.codec import OpusCodec
from test_torch_pipeline import (SEP_SMALL, SPOT_SMALL, _seeded_weights,
                                 one_torch_thread)  # noqa: F401 (autouse)

# the JAX package's pipeline/__init__ binds `analyze` to the function
jax_analyze = importlib.import_module("acousticswarms_speech_tpu.pipeline.analyze")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = os.path.join(REPO, ".devdata_v2", "test")
SCENES = ["00000", "00001"]
SI_SDR_KEYS = ["si_snr_in_mir", "si_snri_mir", "si_snr_in", "si_snri",
               "si_snr_in_old", "si_snri_old"]


def _wavs(rng, n, T, base=None, noise=0.3):
    """n signals; noisy copies of `base` rows where given."""
    out = rng.normal(size=(n, T))
    if base is not None:
        out[: len(base)] = base[:n] + noise * out[: len(base)]
    return out


@pytest.mark.parametrize("n_pred", [4, 9])
def test_find_best_permutation_matches_jax(n_pred):
    """Exhaustive search (n <= 7) and the Hungarian branch (n > 7) give the
    same pairs in both packages (exact)."""
    rng = np.random.default_rng(n_pred)
    T = 4800
    gt = _wavs(rng, 3, T)
    pred = _wavs(rng, n_pred, T, base=gt)
    pos_gt = rng.uniform(0, 5, size=(3, 3))
    pos_pred = rng.uniform(0, 5, size=(n_pred, 3))
    pos_pred[:3] = pos_gt + rng.normal(scale=0.3, size=(3, 3))
    want = jax_evaluate.find_best_permutation(gt, pred, pos_gt, pos_pred)
    got = evaluate.find_best_permutation(gt, pred, pos_gt, pos_pred)
    assert got == want and len(got) >= 1


@pytest.mark.parametrize("scene", SCENES)
def test_preprocess_metadata_and_get_items_match_jax(scene):
    """Both read a dev scene to the same metadata, mixture, GT, mic
    positions, GT offsets and search range (exact)."""
    curr = os.path.join(DEV, scene)
    want = jax_evaluate.get_items(curr, denoise_gt=True, generate_denoised=True)
    got = evaluate.get_items(curr, denoise_gt=True, generate_denoised=True)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    for g, w in zip(evaluate.preprocess_metadata(got[0]),
                    jax_evaluate.preprocess_metadata(want[0])):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def test_get_items_generates_denoised_gt_like_jax(tmp_path):
    """On a scene marked as a real recording (the first 0.6 s of a dev
    scene), both generate the denoised GT on the fly and read it back:
    equal to 1e-9.

    Both packages find the noise floor with np.convolve, whose inner
    products go to a multi-threaded BLAS; beside other busy pytest-xdist
    workers those threads wait on each other for minutes, so BLAS runs on
    one thread here."""
    from acousticswarms_speech_tpu_torch.utils import read_wav, write_wav

    src = os.path.join(DEV, SCENES[0])
    gts = []
    for name, mod in (("jax", jax_evaluate), ("port", evaluate)):
        d = tmp_path / name
        d.mkdir()
        for wav in sorted(os.listdir(src)):
            if wav.endswith(".wav"):
                x, sr = read_wav(os.path.join(src, wav))
                write_wav(str(d / wav), x[:, :28800], sr)
        with open(os.path.join(src, "metadata.json")) as f:
            md = json.load(f)
        md["real"] = True
        with open(d / "metadata.json", "w") as f:
            json.dump(md, f)
        with threadpool_limits(1, user_api="blas"):
            _, _, gt = mod.get_items(str(d), denoise_gt=True,
                                     generate_denoised=True)
        assert sorted(p.name for p in d.glob("*_denoised.wav"))
        gts.append(gt)
    np.testing.assert_allclose(gts[1], gts[0], rtol=0, atol=1e-9)


@pytest.mark.parametrize("permute", [False, True])
def test_bss_eval_sources_matches_jax(permute):
    rng = np.random.default_rng(3)
    ref = rng.normal(size=(2, 6000))
    est = ref[::-1] + 0.5 * rng.normal(size=(2, 6000))
    want = jax_bss_eval.bss_eval_sources(ref, est, compute_permutation=permute)
    got = bss_eval.bss_eval_sources(ref, est, compute_permutation=permute)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)


@pytest.mark.parametrize("with_codec", [False, True])
def test_degrade_mixture_matches_jax(with_codec):
    """The robot-condition proxy with the same seed, with and without the
    Opus round trip: array_equal."""
    _, mix, _ = evaluate.get_items(os.path.join(DEV, SCENES[0]))
    codecs = ((JaxOpusCodec(1, 48000, 0.02), OpusCodec(1, 48000, 0.02))
              if with_codec else (None, None))
    want = jax_evaluate.degrade_mixture(mix, seed=123, codec=codecs[0])
    got = evaluate.degrade_mixture(mix, seed=123, codec=codecs[1])
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, mix)


def test_compute_metrics_matches_jax():
    """SDR (BSS-Eval) and SI-SDR of input and estimate, to 1e-6 dB."""
    _, mix, gt = evaluate.get_items(os.path.join(DEV, SCENES[1]))
    sl = slice(24000, 36000)
    gt = gt[:, sl].astype(np.float64)
    rng = np.random.default_rng(0)
    est = gt + 0.05 * rng.normal(size=gt.shape)
    inp = np.repeat(mix[0:1, sl], gt.shape[0], axis=0)
    want = jax_evaluate.compute_metrics(inp, est, gt)
    got = evaluate.compute_metrics(inp, est, gt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_analyze_and_bootstrap_match_jax():
    """The analyzer and the scene bootstrap on the committed round-5 result
    folder: equal dicts."""
    folder = os.path.join(REPO, ".results_r5_final")
    assert analyze.analyze(folder, verbose=False) == \
        jax_analyze.analyze(folder, verbose=False)
    assert analyze.bootstrap_ci(folder, n_boot=200) == \
        jax_analyze.bootstrap_ci(folder, n_boot=200)


# Two U-Net levels: the narrow networks of the pipeline tests, shallower so
# that both packages sweep a scene quickly on the CPU.
EVAL_SPOT = dict(SPOT_SMALL, stride_list=(4, 4))
EVAL_SEP = dict(SEP_SMALL, stride_list=(4, 4))
GRID = 0.1
CROP_S = 0.25


@pytest.fixture
def small_search(monkeypatch):
    """Both packages keep the 4 strongest coarse survivors per scene
    (MAX_BIG_PATCH, an env knob of both, default 30): with untrained
    networks every candidate passes the power gate, and 30 survivors make
    the fine sweep take minutes on the CPU."""
    for mod in (jax_subdivide, subdivide, jax_constants, constants):
        monkeypatch.setattr(mod, "MAX_BIG_PATCH", 4)


def _results(folder):
    out = {}
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name)) as f:
            out[name] = json.load(f)
    return out


def _assert_same_results(got, want, grid):
    """Port results against JAX results: the same files, keys, perm, TP/FP/
    FN, spot calls, positions within one grid cell, SI-SDR fields within
    0.01 dB."""
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert set(g) == set(w), name
        if name == "config.json":
            assert g == w
            continue
        assert g["perm"] == w["perm"], name
        assert g["spot_times"] == w["spot_times"], name
        for key in ("gt", "pred", "false_positive"):
            assert len(g[key]) == len(w[key]), (name, key)
        for gp, wp in zip(g["pred"], w["pred"]):
            assert set(gp) == set(wp)
            assert gp["voice_id"] == wp["voice_id"]
            assert np.abs(np.subtract(gp["pos"][:2], wp["pos"][:2])).max() <= grid
            for k in SI_SDR_KEYS:
                assert abs(gp[k] - wp[k]) <= 0.01, (name, k, gp[k], wp[k])
        for gp, wp in zip(g["false_positive"], w["false_positive"]):
            assert np.abs(np.subtract(gp["pos"][:2], wp["pos"][:2])).max() <= grid
        np.testing.assert_array_equal(g["speaker_pos"], w["speaker_pos"])


def test_evaluate_dataset_small_nets_match_jax(tmp_path, small_search):
    """evaluate_dataset of both packages on two dev scenes with narrow
    networks (weights from seeds), a 0.25 s selection crop and a 0.1 m grid:
    the same config.json, result keys, perm, counts and spot calls, heads
    within one grid cell, SI-SDR fields within 0.01 dB; the analyzer reads
    both folders alike."""
    spot, sep = SpotNet(**EVAL_SPOT), SepNet(**EVAL_SEP)
    spot_params = _seeded_weights(spot, 0)
    sep_params = _seeded_weights(sep, 1)
    keep = set(SCENES).__contains__
    jax_pipe = JaxPipeline(JaxSpotNet(**EVAL_SPOT), spot_params,
                           JaxSepNet(**EVAL_SEP), sep_params,
                           sweep_crop_seconds=CROP_S)
    port_pipe = JointPipeline(spot, sep, device="cpu", sweep_crop_seconds=CROP_S)
    # config.json records the dataset path; give both the same one
    want_counts = jax_evaluate.evaluate_dataset(
        jax_pipe, DEV, str(tmp_path / "jax"), grid_size=GRID, sample_filter=keep)
    got_counts = evaluate.evaluate_dataset(
        port_pipe, DEV, str(tmp_path / "port"), grid_size=GRID,
        sample_filter=keep)
    assert got_counts == want_counts
    assert sum(want_counts.values()) > 0
    _assert_same_results(_results(tmp_path / "port"), _results(tmp_path / "jax"),
                         GRID)
    a = analyze.analyze(str(tmp_path / "port"), verbose=False)
    b = jax_analyze.analyze(str(tmp_path / "jax"), verbose=False)
    assert (a["tp"], a["fp"], a["fn"]) == (b["tp"], b["fp"], b["fn"])


def test_evaluate_cli_needs_a_card_without_jax(tmp_path):
    """`python -m acousticswarms_speech_tpu_torch.pipeline.evaluate`
    defaults to cuda: without a card it raises before reading the dataset,
    and the process never imports jax, flax, optax, msgpack or the JAX
    package."""
    out = str(tmp_path / "results")
    code = (
        "import sys, runpy\n"
        f"sys.argv = ['evaluate', {DEV!r}, '--spot_experiment_dir',"
        f" {os.path.join(REPO, 'experiments', 'speech_localization')!r},"
        f" '--sep_experiment_dir',"
        f" {os.path.join(REPO, 'experiments', 'speech_separation')!r},"
        f" '--results_folder', {out!r}]\n"
        "try:\n"
        "    runpy.run_module('acousticswarms_speech_tpu_torch.pipeline.evaluate',"
        " run_name='__main__')\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'flax', 'optax', 'msgpack', 'acousticswarms_speech_tpu')]\n"
        "print('bad:', bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "raised: no CUDA device" in proc.stdout, proc.stdout
    assert "bad: []" in proc.stdout, proc.stdout
    assert not os.path.exists(out)
