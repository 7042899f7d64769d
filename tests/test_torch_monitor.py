"""The port's monitor (pipeline/monitor.py) against the JAX package's:
patch labels on a dev scene's SRP patches, and each plot written as a PNG."""
import os

import numpy as np
import pytest

from acousticswarms_speech_tpu.pipeline import monitor as jax_monitor
from acousticswarms_speech_tpu.pipeline.mic_array import MicArray as JaxMicArray
from acousticswarms_speech_tpu_torch.pipeline import monitor
from acousticswarms_speech_tpu_torch.pipeline.evaluate import (
    get_items,
    preprocess_metadata,
)
from acousticswarms_speech_tpu_torch.pipeline.mic_array import MicArray
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, ".devdata_v2", "test", "00000")


@pytest.fixture(scope="module")
def stage0():
    metadata, mix, _ = get_items(SCENE)
    (_, mic_pos, _, voice_pos, offsets_gt,
     range_spk) = preprocess_metadata(metadata)
    arr = MicArray(mic_pos, spk_range=range_spk, grid_size=0.1, device="cpu")
    patches, _ = arr.apply_srp_phat(mix)
    jax_arr = JaxMicArray(mic_pos, spk_range=range_spk, grid_size=0.1)
    jax_patches, _ = jax_arr.apply_srp_phat(mix)
    return dict(arr=arr, patches=patches, jax_patches=jax_patches,
                mic_pos=mic_pos, voice_pos=voice_pos, offsets_gt=offsets_gt,
                range_spk=range_spk)


def test_label_patches_match_jax(stage0, tmp_path):
    s = stage0
    port = monitor.MicArrayMonitor(s["mic_pos"], s["voice_pos"],
                                   s["offsets_gt"], str(tmp_path / "port"))
    ref = jax_monitor.MicArrayMonitor(s["mic_pos"], s["voice_pos"],
                                      s["offsets_gt"], str(tmp_path / "jax"))
    got = port.label_patches(s["patches"])
    assert got == ref.label_patches(s["jax_patches"])
    assert len(got) > 0 and any(got)
    assert os.path.isdir(tmp_path / "port" / "debug")


def _png(path):
    assert os.path.getsize(path) > 1000
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_plots_write_pngs(stage0, tmp_path):
    s = stage0
    monitor.visualize_srp_layers(s["arr"].srp, s["voice_pos"],
                                 out_dir=str(tmp_path))
    written = [f for f in os.listdir(tmp_path) if f.startswith("SRP_h")]
    assert len(written) == 1
    _png(tmp_path / written[0])

    monitor.visualize_patches(s["patches"], s["mic_pos"], s["voice_pos"],
                              s["range_spk"], out_path=str(tmp_path / "p.png"))
    _png(tmp_path / "p.png")

    centers = [p.center_pos() for p in s["patches"]]
    centers = [c for c in centers if c is not None]
    powers = np.linspace(0.1, 1.0, len(centers))
    monitor.visualize_spot_powers(s["mic_pos"], s["voice_pos"],
                                  s["range_spk"], centers, powers,
                                  out_path=str(tmp_path / "s.png"))
    _png(tmp_path / "s.png")

    final = [(p,) for p in s["patches"][:2]]
    monitor.visualize_result(s["mic_pos"], s["voice_pos"], final,
                             s["range_spk"], out_path=str(tmp_path / "r.png"))
    _png(tmp_path / "r.png")
