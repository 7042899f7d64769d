"""The port's native WAV loader (runtime/native.py, csrc/wavloader.cpp): its
reads equal utils.audio's and the JAX package's runtime/native.py's bit for
bit on dev scenes, the training datasets read mixtures through it, and a
failed build raises instead of falling back."""
import os

import numpy as np
import pytest

from acousticswarms_speech_tpu.runtime import native as jax_native
from acousticswarms_speech_tpu_torch.runtime import native
from acousticswarms_speech_tpu_torch.training import datasets
from acousticswarms_speech_tpu_torch.utils.audio import read_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = os.path.join(REPO, ".devdata_v2", "test")
SCENES = ["00000", "00007", "00015"]


def _paths(scene):
    d = os.path.join(DEV, scene)
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".wav"))


@pytest.mark.parametrize("scene", SCENES)
def test_reads_equal_python_and_jax(scene):
    paths = _paths(scene)
    assert len(paths) == 9  # 7 mixtures and 2 GT images
    want = [read_wav(p)[0][0] for p in paths]
    for p, w in zip(paths, want):
        got = native.load_wav(p)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(got, jax_native.load_wav(p))
    T = max(len(w) for w in want)
    batch = native.load_wavs(paths, T + 5, n_threads=3)
    assert batch.shape == (len(paths), T + 5)
    for row, w in zip(batch, want):
        np.testing.assert_array_equal(row[:len(w)], w)
        assert not row[len(w):].any()
    np.testing.assert_array_equal(batch, jax_native.load_wavs(paths, T + 5))


def test_dataset_mixture_reads_through_native(monkeypatch):
    calls = []
    real = native.load_wavs

    def counting(paths, max_frames, n_threads=4):
        calls.append(len(paths))
        return real(paths, max_frames, n_threads)

    monkeypatch.setattr(native, "load_wavs", counting)
    monkeypatch.setattr(datasets, "_WAV_CACHE", type(datasets._WAV_CACHE)())
    mics = [f"mic{m:02d}" for m in range(7)]
    mix = datasets._load_mixture(os.path.join(DEV, "00003"), mics)
    assert calls == [7]
    want = np.concatenate([read_wav(os.path.join(DEV, "00003",
                                                 f"{m}_mixed.wav"))[0]
                           for m in mics])
    np.testing.assert_array_equal(mix, want)


def test_missing_file_raises(tmp_path):
    with pytest.raises(IOError):
        native.load_wavs([_paths("00000")[0], str(tmp_path / "nope.wav")], 10)


@pytest.mark.parametrize("cxx", ["false", "no-such-compiler-xyz"])
def test_failed_build_raises(monkeypatch, cxx):
    """A compiler that fails, or none at all: build raises (the library's
    directory is keyed by the compiler, so the build is attempted)."""
    monkeypatch.setenv("CXX", cxx)
    assert not os.path.exists(native.library_path())
    with pytest.raises(RuntimeError):
        native.build()
    assert not os.path.exists(native.library_path())
