"""The port's search stages against the JAX package's, on the CPU: the
spotforming sweep with the release SpotNet, SRP-PHAT pruning, and MicArray
stages 0-3 with the delay-and-sum spotformer on the two-speaker scene of
tests/test_pipeline_e2e.py."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from acousticswarms_speech_tpu.models.factory import create_model
from acousticswarms_speech_tpu.pipeline.mic_array import MicArray as JaxMicArray
from acousticswarms_speech_tpu.search import spotform as jax_spotform
from acousticswarms_speech_tpu_torch.models import load_release
from acousticswarms_speech_tpu_torch.pipeline.mic_array import MicArray
from acousticswarms_speech_tpu_torch.search import spotform

from test_pipeline_e2e import MIC_POS, _make_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROI = [1.0, 6.0, 0.2, 5.0, 0.1, 0.62]


@pytest.fixture(scope="module")
def scene_stages(tmp_path_factory):
    """Stages 0-3 of both packages on the same scene and geometry cache
    (the port reads the cache file the JAX package wrote: same key)."""
    srcs = [np.array([4.8, 2.4, 0.4]), np.array([2.2, 3.4, 0.3])]
    mix, _ = _make_scene(srcs, seed=1)
    mix = mix.astype(np.float32)
    cache = str(tmp_path_factory.mktemp("geometry"))
    out = {}
    for name, arr_cls, spot in [
            ("jax", JaxMicArray, jax_spotform.DelayAndSumExecutor()),
            ("torch", lambda *a, **k: MicArray(*a, device="cpu", **k),
             spotform.DelayAndSumExecutor(device="cpu"))]:
        arr = arr_cls(MIC_POS, spk_range=ROI, grid_size=0.05, cache_dir=cache)
        patches, _ = arr.apply_srp_phat(mix)
        srp_map = np.array(arr.srp.srp_map)
        big = arr.spotform_big_patch(mix, patches, spot)
        big_offsets = [p.sample_offset.copy() for p in big]
        pairs = arr.spotform_small_patch_parallel(mix, big, spot)
        audio, heads, n_spot, _ = arr.clustering_new(pairs)
        out[name] = dict(srp_map=srp_map, patches=patches, big=big_offsets,
                         pairs=pairs, audio=audio, heads=heads, n_spot=n_spot)
    assert len(os.listdir(cache)) == 1  # one geometry file, shared
    out["mix"], out["cache"] = mix, cache
    return out


def test_srp_map_and_pruned_patches_match_jax(scene_stages):
    """Maps within 1e-4 of their peak (torch.fft vs the matmul DFT), and an
    identical pruned patch list."""
    j, t = scene_stages["jax"], scene_stages["torch"]
    np.testing.assert_allclose(t["srp_map"], j["srp_map"],
                               atol=1e-4 * np.abs(j["srp_map"]).max())
    assert len(t["patches"]) == len(j["patches"]) > 0
    for pt, pj in zip(t["patches"], j["patches"]):
        np.testing.assert_array_equal(pt.sample_offset, pj.sample_offset)
        np.testing.assert_array_equal(pt.width_list, pj.width_list)
        np.testing.assert_array_equal(pt.peak_pos, pj.peak_pos)
        np.testing.assert_array_equal(pt.area_points, pj.area_points)


def test_mic_array_stages_match_jax(scene_stages):
    """Delay-and-sum stages 1-3: identical coarse survivors, fine cluster
    heads and NMS output; head audio within int16 gather quantization."""
    j, t = scene_stages["jax"], scene_stages["torch"]
    assert len(t["big"]) == len(j["big"]) > 0
    for a, b in zip(t["big"], j["big"]):
        np.testing.assert_array_equal(a, b)
    assert [p[3] for p in t["pairs"]] == [p[3] for p in j["pairs"]]
    assert len(t["heads"]) == len(j["heads"]) >= 1
    assert t["n_spot"] == j["n_spot"]
    for ht, hj, at, aj in zip(t["heads"], j["heads"], t["audio"], j["audio"]):
        # power-weighted means of the same members: the powers agree to
        # ~1e-7 relative, so the means to far below one sample or 1 mm
        np.testing.assert_allclose(ht[0].center_pos(), hj[0].center_pos(),
                                   atol=1e-5)
        np.testing.assert_allclose(ht[4]["localization_offset"],
                                   hj[4]["localization_offset"], atol=1e-4)
        np.testing.assert_array_equal(ht[4]["audio_offset"],
                                      hj[4]["audio_offset"])
        assert ht[3] == hj[3]
        # both quantize to int16 per row: one step of 2^-15 of the peak
        np.testing.assert_allclose(at, aj, atol=2 * np.abs(aj).max() / 32767)


def test_mic_array_queued_sweep_and_subdivided_match_jax(scene_stages):
    """Stages 1-3 with the coarse sweep queued before the call
    (`spotform_big_patch(..., sweep=)`) and every other candidate
    subdivided ahead (`spotform_small_patch_parallel(..., subdivided=)`),
    as JointPipeline does beside the coarse sweep: the JAX package's
    survivors, cluster heads and NMS output."""
    j, mix = scene_stages["jax"], scene_stages["mix"]
    arr = MicArray(MIC_POS, spk_range=ROI, grid_size=0.05,
                   cache_dir=scene_stages["cache"], device="cpu")
    spot = spotform.SweepLane(spotform.DelayAndSumExecutor(device="cpu"))
    patches, _ = arr.apply_srp_phat(mix)
    coarse = spot.sweep(mix, patches, strict=0)
    subdivided = {id(p): arr.subdivide_patch(p) for p in patches[::2]}
    big = arr.spotform_big_patch(mix, patches, spot, sweep=coarse)
    assert spot.calls == len(patches)  # the coarse sweep ran once
    pairs = arr.spotform_small_patch_parallel(mix, big, spot,
                                              subdivided=subdivided)
    audio, heads, n_spot, _ = arr.clustering_new(pairs)
    assert [p.sample_offset.tolist() for p in big] == \
        [b.tolist() for b in j["big"]]
    assert [p[3] for p in pairs] == [p[3] for p in j["pairs"]]
    assert n_spot == j["n_spot"] and len(heads) == len(j["heads"]) >= 1
    for ht, hj, at, aj in zip(heads, j["heads"], audio, j["audio"]):
        np.testing.assert_allclose(ht[0].center_pos(), hj[0].center_pos(),
                                   atol=1e-5)
        np.testing.assert_allclose(at, aj, atol=2 * np.abs(aj).max() / 32767)


@pytest.fixture(scope="module")
def release_sweeps():
    """The release SpotNet's executors in both packages (the port's in
    chunks of 2), a 4096-sample slice of the bench scene and five
    candidates."""
    exp_dir = os.path.join(REPO, "experiments", "speech_localization")
    with open(os.path.join(exp_dir, "description.json")) as f:
        desc = json.load(f)
    with open(os.path.join(exp_dir, "release", "params_f16.msgpack"), "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    variables = jax.tree_util.tree_map(
        lambda v: jnp.asarray(v, dtype=jnp.float32), tree)
    jax_exec = jax_spotform.SpotformExecutor(
        create_model(desc["model_name"], desc["model_params"]), variables)
    port_exec = spotform.SpotformExecutor(load_release(exp_dir, device="cpu"),
                                          device="cpu", chunk=2)

    mix = np.load(os.path.join(REPO, ".bench_fixture_v2.npz"))["mix"]
    seg = mix[:, 50000:54096].astype(np.float32)
    rng = np.random.default_rng(0)
    cands = [rng.integers(-20, 20, 6).astype(np.float64) for _ in range(5)]
    return jax_exec, port_exec, seg, cands


def test_spotnet_sweep_matches_jax(release_sweeps):
    """SpotformExecutor.sweep with the release SpotNet on five candidates of
    a 4096-sample slice of the bench scene: powers, windowed powers, the
    pairwise SI-SDR matrix, and the gathered rows (with and without the
    int16 quantization).  The JAX sweep pads to its 32-candidate bucket."""
    jax_exec, port_exec, seg, cands = release_sweeps
    # strict=1, the fine sweep's window (SpotNet itself is checked on both
    # window one-hots in test_torch_models.py)
    want = jax_exec.sweep(seg, cands, strict=1, with_similarity=True)
    lane = spotform.SweepLane(port_exec)
    got = lane.sweep(seg, cands, strict=1, with_similarity=True)
    # float32 network outputs agree to ~1e-6 relative; powers to 1e-4
    np.testing.assert_allclose(got.powers, want.powers, rtol=1e-4)
    np.testing.assert_allclose(got.powers_win, want.powers_win, rtol=1e-4)
    np.testing.assert_allclose(got.sisdr_mat, want.sisdr_mat, atol=1e-2)
    rows_w = want.gather([4, 0, 2], quantize=False)
    rows_g = got.gather([4, 0, 2], quantize=False)
    q_w = want.gather([4, 0, 2])
    q_g = got.gather([4, 0, 2])
    for i in (4, 0, 2):
        peak = np.abs(rows_w[i]).max()
        np.testing.assert_allclose(rows_g[i], rows_w[i], atol=1e-4 * peak)
        np.testing.assert_allclose(q_g[i], q_w[i], atol=1e-4 * peak)
    assert lane.calls == 5


@pytest.mark.parametrize("strict", [0, 1])
def test_shift_and_sep_and_all_waveforms_match_jax(release_sweeps, strict):
    """The full-output API: shift_and_sep (every candidate's centered
    waveform through SweepResult.all_waveforms) with the release SpotNet on
    the inputs of test_spotnet_sweep_matches_jax gives exactly one row per
    candidate (the JAX sweep pads to 32), each within 1e-4 of the JAX row's
    peak; and all_waveforms of the delay-and-sum sweep of
    tests/test_sweep_result.py (9 candidates of 4000 samples) gives its
    9 rows, within 1e-4 of the peak of JAX's."""
    jax_exec, port_exec, seg, cands = release_sweeps
    want = jax_exec.shift_and_sep(seg, cands, strict=strict)
    got = port_exec.shift_and_sep(seg, cands, strict=strict)
    assert got.shape == want.shape == (len(cands), seg.shape[1])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max())

    rng = np.random.default_rng(0)
    mix = rng.normal(size=(4, 4000)).astype(np.float32) * 0.1
    offs = [rng.integers(-30, 30, 3).astype(float) for _ in range(9)]
    want = jax_spotform.DelayAndSumExecutor().sweep(
        mix, offs, strict=strict, with_similarity=True).all_waveforms()
    res = spotform.DelayAndSumExecutor(device="cpu").sweep(
        mix, offs, strict=strict, with_similarity=True)
    got = res.all_waveforms()
    assert got.shape == want.shape == (9, 4000) and res.n == 9
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
