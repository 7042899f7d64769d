"""SpotNet and SepNet of the port against the JAX package's flax networks,
on the committed release weights, in float32 on the CPU."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from acousticswarms_speech_tpu.models.factory import create_model
from acousticswarms_speech_tpu.search.spotform import SeparationInference as JaxSep
from acousticswarms_speech_tpu_torch.models import load_release
from acousticswarms_speech_tpu_torch.search.spotform import SeparationInference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The tolerance of tests/test_modules_torch_parity.py: float32 sums in other
# orders through a few dozen layers.
RTOL, ATOL = 2e-4, 2e-5


def _jax_release(exp):
    """(flax module, float32 variables) as the JAX loader builds them."""
    exp_dir = os.path.join(REPO, "experiments", exp)
    with open(os.path.join(exp_dir, "description.json")) as f:
        desc = json.load(f)
    with open(os.path.join(exp_dir, "release", "params_f16.msgpack"), "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    variables = jax.tree_util.tree_map(
        lambda v: jnp.asarray(v, dtype=jnp.float32), tree)
    return create_model(desc["model_name"], desc["model_params"]), variables


@pytest.fixture(scope="module")
def sep_pair():
    model, variables = _jax_release("speech_separation")
    port = load_release(os.path.join(REPO, "experiments", "speech_separation"),
                        device="cpu")
    return (JaxSep(model, variables),
            SeparationInference(port, device="cpu"))


def test_spotnet_release_matches_jax():
    """Full-width SpotNet, B=2, T=4096 (not a multiple of the stride product
    after the left pad is removed), both window one-hots."""
    model, variables = _jax_release("speech_localization")
    port = load_release(os.path.join(REPO, "experiments", "speech_localization"),
                        device="cpu")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 4096)).astype(np.float32)
    w = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x), jnp.asarray(w)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert got.shape == want.shape == (2, 1, 4096)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_speakers", [1, 2, 3, 4, 5, 6, 7, 8])
def test_separation_release_matches_jax(sep_pair, n_speakers):
    """SeparationInference (zero-fill roll, normalization over the valid
    speakers, SepNet with max_speakers 5) on a 4096-sample slice of the
    bench scene, for up to NMS_MAX_OUT = 8 heads.  The JAX package pads the
    speaker axis to a multiple of max_speakers (5 or 10) and masks it; the
    port runs the given speakers only.  Tolerance: 1e-4 of the output's
    peak, float32 sums in other orders through the Conformer bottleneck."""
    jax_sep, port_sep = sep_pair
    mix = np.load(os.path.join(REPO, ".bench_fixture_v2.npz"))["mix"]
    seg = mix[:, 60000:64096].astype(np.float32)
    rng = np.random.default_rng(n_speakers)
    offs = [rng.integers(-30, 30, 6).astype(np.float64)
            for _ in range(n_speakers)]
    want = jax_sep.infer_sample(seg, offs)
    got = port_sep.infer_sample(seg, offs)
    assert got.shape == want.shape == (n_speakers, 4096)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.slow
def test_oracle_positions_dev_scene_matches_jax(sep_pair):
    """Separation at the true TDoAs (the `shifts` of metadata.json) of dev
    scene 00000, full width, T = 72000, S = 2: both packages' outputs agree
    within 1e-4 of the peak, and the test prints each package's SI-SDRi
    against mic00_voice0{0,1}.wav.  The SI-SDRi says whether the pipeline's
    low SI-SDRi on the dev scenes comes from the scenes or from the search."""
    from acousticswarms_speech_tpu_torch.pipeline.evaluate import get_items
    from acousticswarms_speech_tpu_torch.utils.metrics import si_sdr

    jax_sep, port_sep = sep_pair
    metadata, mix, gts = get_items(
        os.path.join(REPO, ".devdata_v2", "test", "00000"))
    voices = sorted(k for k in metadata if k.startswith("voice"))
    offs = [np.asarray(metadata[v]["shifts"], np.float64) for v in voices]
    want = jax_sep.infer_sample(mix, offs)
    got = port_sep.infer_sample(mix, offs)
    assert got.shape == want.shape == (2, 72000) == gts.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    for name, est in (("jax", want), ("port", got)):
        sisdri = [si_sdr(est[i], gts[i]) - si_sdr(mix[0], gts[i])
                  for i in range(2)]
        print(f"oracle-position SI-SDRi ({name}): "
              f"{[round(float(x), 3) for x in sisdri]} dB, mean "
              f"{float(np.mean(sisdri)):.3f} dB")
