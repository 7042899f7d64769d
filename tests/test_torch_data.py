"""Dataset generation and hard-negative mining of the port (data/) against
the JAX package's, on the same seeded inputs, on the CPU: the room render,
the voice bank, scene generation, the speaker split and the miner."""
import argparse
import json
import os
import shutil
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from acousticswarms_speech_tpu.data import generate_dataset as jax_gen
from acousticswarms_speech_tpu.data import generate_srp_sample as jax_mine
from acousticswarms_speech_tpu.data import roomsim as jax_room
from acousticswarms_speech_tpu.data import vctk_split as jax_split
from acousticswarms_speech_tpu.data import voicegen as jax_voice
from acousticswarms_speech_tpu_torch.data import generate_dataset as gen
from acousticswarms_speech_tpu_torch.data import generate_srp_sample as mine
from acousticswarms_speech_tpu_torch.data import roomsim
from acousticswarms_speech_tpu_torch.data import vctk_split
from acousticswarms_speech_tpu_torch.data import voicegen
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = os.path.join(REPO, ".devdata_v2", "test")
FS = 48000
ROOM = np.array([5.0, 4.0, 2.5])
MICS = np.array([
    [2.0, 1.0, 0.02], [2.5, 1.3, 0.02], [2.5, 0.7, 0.02], [2.7, 1.0, 0.02],
    [2.3, 1.5, 0.02], [2.3, 0.5, 0.02], [2.6, 1.15, 0.02],
])
SOURCES = np.array([[3.8, 2.9, 0.4], [1.1, 3.1, 0.6]])
# float32 sinc taps (sin in another library) summed in float64 over the
# images: agreement to 1e-6 of the output's peak
RIR_RTOL = 1e-6


@pytest.fixture(autouse=True)
def one_blas_thread():
    """Long np.convolve/FFT calls on a multi-threaded BLAS beside busy
    xdist workers stall; one thread keeps these tests steady."""
    with threadpool_limits(1, "blas"):
        yield


def _close(got, want, rtol=RIR_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def test_image_sources_and_pruning_equal():
    for src in SOURCES:
        want = jax_room._image_sources(src, ROOM, 4)
        got = roomsim._image_sources(src, ROOM, 4)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        center = MICS.mean(axis=0)
        for g, w in zip(roomsim.prune_images(got, center, 0.35, 3e-5, 0.5),
                        jax_room.prune_images(want, center, 0.35, 3e-5, 0.5)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("exact", [False, True])
def test_compute_rir_matches_jax(exact):
    """Room 5x4x2.5 m, max_order 4, every mic of both sources: the hybrid
    render (81-tap early, 11-tap tail) and the exact one."""
    for src in SOURCES:
        images = jax_room._image_sources(src, ROOM, 4)
        for mic in MICS:
            want = jax_room.compute_rir(src, mic, ROOM, 0.35, 4, FS,
                                        images=images, exact=exact)
            got = roomsim.compute_rir(src, mic, ROOM, 0.35, 4, FS,
                                      images=images, exact=exact,
                                      device="cpu")
            assert got.dtype == torch.float64
            _close(got.numpy(), want)
    # with its own pruning and image lattice
    want = jax_room.compute_rir(SOURCES[0], MICS[3], ROOM, 0.35, 4, FS,
                                rel_cutoff=1e-3, exact=exact)
    got = roomsim.compute_rir(SOURCES[0], MICS[3], ROOM, 0.35, 4, FS,
                              rel_cutoff=1e-3, exact=exact, device="cpu")
    _close(got.numpy(), want)


def test_shoebox_simulate_matches_jax():
    """7 mics, 2 sources of 0.25 s: the premix, each (source, mic) image
    within 1e-6 of the premix's peak."""
    rng = np.random.default_rng(0)
    sigs = [rng.normal(size=FS // 4) * 0.3 for _ in SOURCES]
    rooms = [jax_room.ShoeBox(ROOM, FS, max_order=4, absorption=0.35),
             roomsim.ShoeBox(ROOM, FS, max_order=4, absorption=0.35,
                             device="cpu")]
    for room in rooms:
        room.add_microphone_array(MICS.T)
        for pos, sig in zip(SOURCES, sigs):
            room.add_source(pos, sig)
    want = rooms[0].simulate()
    got = rooms[1].simulate()
    assert got.shape == want.shape and got.shape[:2] == (2, 7)
    _close(got, want)


def test_inverse_sabine_matches_jax():
    for rt60, dims in ((0.3, [6.5, 7.2, 2.3]), (0.65, [7.9, 6.1, 2.0])):
        assert roomsim.inverse_sabine(rt60, dims) == \
            jax_room.inverse_sabine(rt60, dims)
    with pytest.raises(ValueError):
        roomsim.inverse_sabine(0.01, [8.0, 8.0, 2.5])


def test_voicegen_bit_equal(tmp_path):
    prof_j = jax_voice.SpeakerProfile(np.random.default_rng(5))
    prof_p = voicegen.SpeakerProfile(np.random.default_rng(5))
    assert vars(prof_j) == vars(prof_p)
    want = jax_voice.synthesize_utterance(prof_j, 0.7,
                                          np.random.default_rng(6))
    got = voicegen.synthesize_utterance(prof_p, 0.7, np.random.default_rng(6))
    np.testing.assert_array_equal(got, want)

    jax_voice.generate_voice_bank(str(tmp_path / "jax"), n_speakers=2,
                                  clips_per_speaker=2, duration=0.5, seed=3)
    voicegen.generate_voice_bank(str(tmp_path / "port"), n_speakers=2,
                                 clips_per_speaker=2, duration=0.5, seed=3)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 4
    for rel in files:
        with open(tmp_path / "jax" / rel, "rb") as a, \
                open(tmp_path / "port" / rel, "rb") as b:
            assert a.read() == b.read(), rel


def _pcm(path):
    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)


def _assert_same_scene(jax_dir, port_dir):
    """metadata.json equal, every WAV within 1 LSB."""
    with open(os.path.join(jax_dir, "metadata.json")) as f:
        want = json.load(f)
    with open(os.path.join(port_dir, "metadata.json")) as f:
        got = json.load(f)
    assert got == want
    wavs = sorted(f for f in os.listdir(jax_dir) if f.endswith(".wav"))
    assert wavs == sorted(f for f in os.listdir(port_dir)
                          if f.endswith(".wav"))
    assert len(wavs) >= 9
    for name in wavs:
        a = _pcm(os.path.join(jax_dir, name)).astype(np.int32)
        b = _pcm(os.path.join(port_dir, name)).astype(np.int32)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, name
        assert np.abs(a).max() > 100, name  # not silent


@pytest.fixture(scope="module")
def voice_bank(tmp_path_factory):
    """3 synthetic speakers of 2 one-second clips."""
    root = tmp_path_factory.mktemp("bank")
    voicegen.generate_voice_bank(str(root), n_speakers=3, clips_per_speaker=2,
                                 duration=1.0, seed=0)
    return [str(root / d) for d in sorted(os.listdir(root))]


def _args(out, device="cpu", **kw):
    base = dict(output_path=str(out), n_mics=7, n_voices_min=2,
                n_voices_max=2, sr=FS, duration=0.5, dimensions=3,
                max_order=4, max_order_cap=150, sample_rt60=False,
                generate_colocated=False, device=device)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("three_desks", [False, True])
def test_generate_sample_matches_jax(tmp_path, voice_bank, three_desks):
    """One scene (2 voices, 0.5 s, max_order 4) drawn under
    np.random.seed(s) in the JAX package and RandomState(s) in the port."""
    jax_fn = (jax_gen.generate_sample_three_desks if three_desks
              else jax_gen.generate_sample)
    port_fn = (gen.generate_sample_three_desks if three_desks
               else gen.generate_sample)
    state = np.random.get_state()
    try:
        np.random.seed(11)
        jax_fn(voice_bank, _args(tmp_path / "jax"), "train", 0)
    finally:
        np.random.set_state(state)
    rng = np.random.RandomState(11)
    port_fn(voice_bank, _args(tmp_path / "port"), "train", 0, rng)
    sizes = ["large", "middle", "small"] if three_desks else [""]
    for size in sizes:
        _assert_same_scene(tmp_path / "jax" / size / "train" / "00000",
                           tmp_path / "port" / size / "train" / "00000")


def test_generate_sample_rt60_matches_jax(tmp_path, voice_bank):
    """--sample_rt60 takes the absorption and order from inverse Sabine;
    the order is capped at 4 to keep the render small."""
    state = np.random.get_state()
    try:
        np.random.seed(3)
        jax_gen.generate_sample(voice_bank, _args(
            tmp_path / "jax", sample_rt60=True, max_order_cap=4), "val", 2)
    finally:
        np.random.set_state(state)
    gen.generate_sample(voice_bank, _args(
        tmp_path / "port", sample_rt60=True, max_order_cap=4), "val", 2,
        np.random.RandomState(3))
    _assert_same_scene(tmp_path / "jax" / "val" / "00002",
                       tmp_path / "port" / "val" / "00002")


def test_vctk_split_equal(tmp_path):
    for k in range(23):
        os.makedirs(tmp_path / "corpus" / f"p{k:03d}")
    (tmp_path / "corpus" / "readme.txt").write_text("not a speaker")
    for seed in (0, 4):
        want = jax_split.split_speakers(str(tmp_path / "corpus"), seed=seed)
        got = vctk_split.split_speakers(str(tmp_path / "corpus"), seed=seed)
        assert got == want
        assert sum(len(v) for v in got.values()) == 23


def test_mine_sample_matches_jax(tmp_path):
    """Dev scene 00000 mined by both packages at grid_size 0.1, each in its
    own copy of the scene directory."""
    for name in ("jax", "port"):
        shutil.copytree(os.path.join(DEV, "00000"), tmp_path / name)
    want = jax_mine.mine_sample(str(tmp_path / "jax"), grid_size=0.1)
    got = mine.mine_sample(str(tmp_path / "port"), grid_size=0.1,
                           device="cpu")
    assert got == want
    assert len(got[0]) + len(got[1]) > 0
    with open(tmp_path / "port" / "challeng_sample.json") as f:
        written = json.load(f)
    assert written == {"negative_sample": got[0], "positive_sample": got[1]}
    assert not os.path.exists(tmp_path / "port" / "challeng_sample.json.tmp")


def test_mine_range_exits_1_on_failure(tmp_path):
    """mine_range skips mined scenes and scenes without metadata, mines the
    rest, and exits 1 when any scene failed: here every scene to mine fails,
    because the default device is cuda and the process has none."""
    for idx in (0, 1):
        shutil.copytree(os.path.join(DEV, f"{idx:05d}"),
                        tmp_path / f"{idx:05d}")
    (tmp_path / "00001" / "challeng_sample.json").write_text("{}")
    os.makedirs(tmp_path / "00002")  # no metadata.json
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "acousticswarms_speech_tpu_torch.data.mine_range",
         str(tmp_path), "0", "3"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "[0] FAILED: no CUDA device" in proc.stdout, proc.stdout
    assert "MINER DONE 1 (1 failed)" in proc.stdout, proc.stdout
    assert not os.path.exists(tmp_path / "00000" / "challeng_sample.json")
