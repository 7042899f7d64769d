"""The classical baselines of the port (dsp/music.py, dsp/tops.py, MicArray's
MUSIC and TOPS prune methods, utils/oracle_masks.py) against the JAX
package's, on the CPU.

Inputs: a 0.75 s slice of dev scene 00000 with seeded white noise added.
Without noise, the two clean sources leave eigenvalues 3-7 of each 7x7
covariance equal to rounding, and the 3-dim "signal subspace" would be an
arbitrary pick among them in either package.  The JAX package's np.fft
computes a float32 input in complex64 (numpy 2), the port in complex128,
so the map tests pass float64 samples and hold the maps to 1e-8 of their
peak; the MicArray tests pass the float32 mixture the pipeline reads, and
hold the pruned patch lists equal."""
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from acousticswarms_speech_tpu.dsp import music as jax_music
from acousticswarms_speech_tpu.dsp import tops as jax_tops
from acousticswarms_speech_tpu.dsp.geometry import build_geometry
from acousticswarms_speech_tpu.pipeline.mic_array import MicArray as JaxMicArray
from acousticswarms_speech_tpu.utils import oracle_masks as jax_masks
from acousticswarms_speech_tpu_torch.constants import FREQ_BINS, N_FFT
from acousticswarms_speech_tpu_torch.dsp import music, tops
from acousticswarms_speech_tpu_torch.pipeline.evaluate import (
    get_items,
    preprocess_metadata,
)
from acousticswarms_speech_tpu_torch.pipeline.mic_array import MicArray
from acousticswarms_speech_tpu_torch.utils import oracle_masks
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, ".devdata_v2", "test", "00000")
MAP_RTOL = 1e-8  # of the map's peak: complex128 sums in other orders


@pytest.fixture(autouse=True)
def one_blas_thread():
    with threadpool_limits(1, "blas"):
        yield


@pytest.fixture(scope="module")
def scene():
    """(mix (7, 36000) float64 with noise at about -40 dB, gts, mic
    positions, speaker range)."""
    metadata, mix, gts = get_items(SCENE)
    _, mic_pos, _, _, _, range_spk = preprocess_metadata(metadata)
    x = mix[:, :36000].astype(np.float64)
    x = x + 1e-3 * np.random.default_rng(0).normal(size=x.shape)
    return x, gts, mic_pos, range_spk


@pytest.fixture(scope="module")
def geom(scene):
    _, _, mic_pos, range_spk = scene
    return build_geometry(mic_pos, range_spk, grid_size=0.2)


def _close_map(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=MAP_RTOL * np.abs(want).max())


def test_grid_mode_vectors_match_jax(geom):
    want = jax_music.grid_mode_vectors(geom.grids, geom.mic_pos, FREQ_BINS,
                                       48000, N_FFT)
    got = music.grid_mode_vectors(geom.grids, geom.mic_pos, FREQ_BINS, 48000,
                                  N_FFT, device="cpu")
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("window", [None, 12000])
def test_music_map_matches_jax(scene, geom, window):
    """The default window policy (24000 below 72000 samples: one window)
    and three non-overlapping 12000-sample windows."""
    x = scene[0]
    want = jax_music.music_map_window(x, geom, FREQ_BINS, N_FFT, window=window)
    got = music.music_map_window(x, geom, FREQ_BINS, N_FFT, window=window,
                                 device="cpu")
    _close_map(got, want)


@pytest.mark.parametrize("window", [72000, 18000])
def test_tops_map_matches_jax(scene, geom, window):
    """The short-signal branch (0.75 s is shorter than the 72000-sample
    window: one run over all of it) and two 18000-sample windows."""
    x = scene[0]
    want = jax_tops.tops_map_window(x, geom, FREQ_BINS, N_FFT, window=window)
    got = tops.tops_map_window(x, geom, FREQ_BINS, N_FFT, window=window,
                               device="cpu")
    _close_map(got, want)


@pytest.mark.parametrize("method", ["MUSIC", "TOPS"])
def test_mic_array_prune_methods_match_jax(scene, method):
    """apply_srp_phat with the baseline's map in place of the SRP map, on
    the float32 mixture: equal pruned patch lists."""
    x, _, mic_pos, range_spk = scene
    x32 = x.astype(np.float32)
    jax_arr = JaxMicArray(mic_pos, spk_range=range_spk, grid_size=0.2,
                          prune_method=method)
    port_arr = MicArray(mic_pos, spk_range=range_spk, grid_size=0.2,
                        prune_method=method, device="cpu")
    want, _ = jax_arr.apply_srp_phat(x32)
    got, _ = port_arr.apply_srp_phat(x32)
    assert port_arr.srp.srp_map.dtype == np.float32
    np.testing.assert_allclose(port_arr.srp.srp_map, jax_arr.srp.srp_map,
                               rtol=1e-5)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.sample_offset, w.sample_offset)
        np.testing.assert_array_equal(g.width_list, w.width_list)
    assert port_arr.srp.max_power == float(port_arr.srp.srp_map.max())


def test_mic_array_unknown_method_raises(scene):
    _, _, mic_pos, range_spk = scene
    arr = MicArray(mic_pos, spk_range=range_spk, grid_size=0.2,
                   prune_method="ESPRIT", device="cpu")
    with pytest.raises(ValueError, match="unknown prune method"):
        arr.apply_srp_phat(scene[0])


@pytest.mark.parametrize("fn", ["do_irm", "do_ibm"])
def test_oracle_masks_bit_equal(scene, fn):
    """On the reference mic's mixture and the two GT images of the scene."""
    metadata, mix, gts = get_items(SCENE)
    want = getattr(jax_masks, fn)(mix[0], gts)
    got = getattr(oracle_masks, fn)(mix[0], gts)
    assert got.shape == want.shape == gts.shape
    np.testing.assert_array_equal(got, want)
