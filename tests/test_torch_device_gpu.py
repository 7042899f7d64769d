"""The port's device code without a hand-written kernel (the room render and
convolution, the MUSIC and TOPS maps) on the card against the same code on
the CPU, at small sizes; and the candidate-sharded sweep on the card (two
gloo ranks sharing it, and nccl at world size 1) against the unsharded one.

Every test here carries the `gpu` marker and skips without a CUDA device
(decided inside a fixture).  This file imports neither JAX nor the JAX
package, so it runs on a machine that has neither:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_device_gpu.py
"""
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
from acousticswarms_speech_tpu_torch.search.spotform import \
    DelayAndSumExecutor  # noqa: E402

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
