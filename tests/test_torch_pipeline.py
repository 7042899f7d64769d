"""The whole slice: the port's JointPipeline.forward against the JAX
package's on the bench scene (.bench_fixture_v2.npz, bench.py's MIC_POS and
ROI, its committed geometry cache), on the CPU.

The tier-1 case runs narrow SpotNet/SepNet networks with weights made from a
seed, on a 0.5 s slice with a 0.25 s selection crop (so the crop path and
the full-length head sweep both run).  The full-width case with the release
weights takes many minutes on a CPU and is marked slow."""
import json
import os

import jax
import jax.numpy as jnp
from flax import serialization
import numpy as np
import pytest
import torch

from acousticswarms_speech_tpu.models import SepNet as JaxSepNet
from acousticswarms_speech_tpu.models import SpotNet as JaxSpotNet
from acousticswarms_speech_tpu.models.factory import create_model
from acousticswarms_speech_tpu.pipeline.joint import JointPipeline as JaxPipeline
from acousticswarms_speech_tpu.utils.metrics import si_sdr
from acousticswarms_speech_tpu_torch.models import SepNet, SpotNet, load_release
from acousticswarms_speech_tpu_torch.pipeline.joint import JointPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIC_POS = np.array([
    [3.0, 1.0, 0.02], [3.5, 1.3, 0.02], [3.5, 0.7, 0.02], [3.7, 1.0, 0.02],
    [3.3, 1.5, 0.02], [3.3, 0.5, 0.02], [3.6, 1.15, 0.02],
])
ROI = [1.0, 6.2, 0.2, 5.4, 0.1, 0.62]
GRID = 0.05

SPOT_SMALL = dict(channels=8, encoder_channels=32, residual_layers=1,
                  num_head=2, ffw_dim=16, num_transformer_layers=1)
SEP_SMALL = dict(max_speakers=5, channels=8, encoder_channels=32,
                 residual_layers=1, num_head=2, ffw_dim=16,
                 bottleneck_layers=1, bottleneck_ksize=7)


@pytest.fixture(autouse=True)
def one_torch_thread(request):
    """Narrow networks run torch on one thread (full-width, slow cases keep
    all threads).  Under pytest-xdist the cores are shared by the workers,
    and torch's idle OpenMP threads spin on them, slowing every other
    worker; the narrow networks gain little from more threads."""
    if request.node.get_closest_marker("slow"):
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _seeded_weights(model, seed):
    """Weights for both packages from a numpy seed: a flax variables tree
    and the same values loaded into the port's `model`."""
    rng = np.random.default_rng(seed)
    state, tree = {}, {}
    for name, p in model.state_dict().items():
        shape = tuple(p.shape)
        if name.endswith("weight") and len(shape) >= 2:
            fan_in = int(np.prod(shape[1:]))
            val = rng.normal(size=shape) / np.sqrt(fan_in)
        elif name.endswith("weight") and "norm" in name:
            val = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            val = 0.1 * rng.normal(size=shape)
        val = val.astype(np.float32)
        state[name] = val
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(val)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return {"params": tree}


def _fixture(start, length):
    mix = np.load(os.path.join(REPO, ".bench_fixture_v2.npz"))["mix"]
    return np.ascontiguousarray(mix[:, start : start + length], np.float32)


def _run_both(jax_spot, jax_spot_params, jax_sep, jax_sep_params,
              torch_spot, torch_sep, mix, crop_s):
    return {"jax": _run_jax(jax_spot, jax_spot_params, jax_sep,
                            jax_sep_params, mix, crop_s),
            "torch": _run_port(torch_spot, torch_sep, mix, crop_s)}


def _run_jax(jax_spot, jax_spot_params, jax_sep, jax_sep_params, mix, crop_s,
             **kwargs):
    jp = JaxPipeline(jax_spot, jax_spot_params, jax_sep, jax_sep_params,
                     sweep_crop_seconds=crop_s, **kwargs)
    return _forward(jp, mix)


def _run_port(torch_spot, torch_sep, mix, crop_s, **kwargs):
    tp = JointPipeline(torch_spot, torch_sep, device="cpu",
                       sweep_crop_seconds=crop_s, **kwargs)
    return _forward(tp, mix)


def _forward(pipe, mix, **kwargs):
    """(patches, audio_loc, audio, pipe) of one forward on the bench
    scene's array, ROI and committed geometry cache."""
    pipe.setup(MIC_POS, ROI, cache_dir=os.path.join(REPO, ".bench_cache"),
               grid_size=GRID)
    patches, audio_loc, audio, *_ = pipe.forward(mix, **kwargs)
    return patches, audio_loc, audio, pipe


def _assert_same_heads(out):
    (pj, lj, aj, jp), (pt, lt, at, tp) = out["jax"], out["torch"]
    assert len(pt) == len(pj)
    for hj, ht in zip(pj, pt):
        dj, dt = np.asarray(hj[0].center_pos()), np.asarray(ht[0].center_pos())
        assert np.abs(dj[:2] - dt[:2]).max() <= GRID, (dj, dt)
    if len(pj):
        assert at.shape == aj.shape and np.isfinite(at).all()
        for k in range(len(pj)):
            assert si_sdr(at[k], aj[k]) >= 30.0, k
            assert si_sdr(lt[k], lj[k]) >= 30.0, k
    assert tp.stage_metrics()["spotform_calls"] == \
        jp.stage_metrics()["spotform_calls"]


@pytest.fixture(scope="module")
def small_nets():
    """Narrow networks with weights from seeds, 0.5 s of the bench scene,
    and the JAX pipeline's forward of it with a 0.25 s selection crop."""
    spot_t, sep_t = SpotNet(**SPOT_SMALL), SepNet(**SEP_SMALL)
    spot_p = _seeded_weights(spot_t, 0)
    sep_p = _seeded_weights(sep_t, 1)
    mix = _fixture(48000, 24000)
    jax_out = _run_jax(JaxSpotNet(**SPOT_SMALL), spot_p, JaxSepNet(**SEP_SMALL),
                       sep_p, mix, 0.25)
    return spot_t, sep_t, mix, jax_out


def test_joint_pipeline_small_nets_match_jax(small_nets):
    """Narrow networks, weights from seeds, 0.5 s of the bench scene.  On
    the CPU a sweep is done when it returns, so no candidate is subdivided
    beside the coarse sweep."""
    spot_t, sep_t, mix, jax_out = small_nets
    out = {"jax": jax_out, "torch": _run_port(spot_t, sep_t, mix, 0.25)}
    assert len(out["torch"][0]) >= 1
    _assert_same_heads(out)


@pytest.mark.parametrize("ready_after", [None, 3])
def test_coarse_overlap_matches_jax(small_nets, monkeypatch, ready_after):
    """The stage-1 overlap with the coarse sweep never ready (every
    candidate subdivided beside it) or ready at the fourth poll (three
    subdivided beside it, the rest in stage 2): the same heads, audio and
    spot calls as the JAX package's forward, as with none subdivided
    beside it (the test above)."""
    from acousticswarms_speech_tpu_torch.pipeline.mic_array import MicArray
    from acousticswarms_speech_tpu_torch.search.spotform import SweepResult

    polls, counts = [0], {"subdivided": 0}

    def is_ready(self):
        polls[0] += 1
        return ready_after is not None and polls[0] > ready_after

    real_subdivide = MicArray.subdivide_patch
    real_big = MicArray.spotform_big_patch

    def subdivide(self, patch):
        counts["subdivided"] += 1
        return real_subdivide(self, patch)

    def big(self, mix, patch_list, *args, **kwargs):
        counts["beside_coarse"] = counts["subdivided"]
        counts["candidates"] = len(patch_list)
        return real_big(self, mix, patch_list, *args, **kwargs)

    monkeypatch.setattr(SweepResult, "is_ready", is_ready)
    monkeypatch.setattr(MicArray, "subdivide_patch", subdivide)
    monkeypatch.setattr(MicArray, "spotform_big_patch", big)
    spot_t, sep_t, mix, jax_out = small_nets
    out = {"jax": jax_out, "torch": _run_port(spot_t, sep_t, mix, 0.25)}
    want = counts["candidates"] if ready_after is None else ready_after
    assert counts["beside_coarse"] == want > 0
    assert len(out["torch"][0]) >= 1
    _assert_same_heads(out)


def _jax_release(exp):
    exp_dir = os.path.join(REPO, "experiments", exp)
    with open(os.path.join(exp_dir, "description.json")) as f:
        desc = json.load(f)
    with open(os.path.join(exp_dir, "release", "params_f16.msgpack"), "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    params = jax.tree_util.tree_map(
        lambda v: jnp.asarray(v, dtype=jnp.float32), tree)
    return (create_model(desc["model_name"], desc["model_params"]), params,
            load_release(exp_dir, device="cpu"))


@pytest.mark.slow
def test_joint_pipeline_release_matches_jax():
    """Full-width release networks on 1 s of the bench scene with a 0.5 s
    selection crop.  Hundreds of full-width SpotNet forwards per package:
    many minutes on a CPU."""
    spot_j, spot_p, spot_t = _jax_release("speech_localization")
    sep_j, sep_p, sep_t = _jax_release("speech_separation")
    out = _run_both(spot_j, spot_p, sep_j, sep_p, spot_t, sep_t,
                    _fixture(36000, 48000), crop_s=0.5)
    _assert_same_heads(out)


def test_forward_streaming_matches_jax(tmp_path):
    """forward_streaming over two overlapping chunks of a 1 s two-speaker
    scene of tests/test_pipeline_e2e.py, with the delay-and-sum spotformer
    in both packages and the narrow SepNet: the same tracks, positions
    within one grid cell, and assembled audio at >= 30 dB SI-SDR."""
    from acousticswarms_speech_tpu.search.spotform import (
        DelayAndSumExecutor as JaxDelayAndSum,
    )
    from acousticswarms_speech_tpu_torch.search.spotform import (
        DelayAndSumExecutor,
    )

    from test_pipeline_e2e import MIC_POS as E2E_MICS
    from test_pipeline_e2e import _make_scene

    mix, _ = _make_scene([np.array([4.8, 2.4, 0.4]),
                          np.array([2.2, 3.4, 0.3])], seed=1, duration=1.0)
    mix = mix.astype(np.float32)
    roi = [1.0, 6.0, 0.2, 5.0, 0.1, 0.62]
    sep_t = SepNet(**SEP_SMALL)
    sep_p = _seeded_weights(sep_t, 1)
    spot_t = SpotNet(**SPOT_SMALL)
    spot_p = _seeded_weights(spot_t, 0)
    jp = JaxPipeline(JaxSpotNet(**SPOT_SMALL), spot_p, JaxSepNet(**SEP_SMALL),
                     sep_p)
    jp.spot_model = JaxDelayAndSum()
    tp = JointPipeline(spot_t, sep_t, device="cpu")
    tp.spot_model = DelayAndSumExecutor(device="cpu")
    out = {}
    for name, pipe in (("jax", jp), ("torch", tp)):
        pipe.setup(E2E_MICS, roi, cache_dir=str(tmp_path))
        out[name] = pipe.forward_streaming(mix, chunk_samples=28000,
                                           overlap=8000)[0]
    tj, tt = out["jax"], out["torch"]
    assert len(tt) == len(tj) >= 1
    for a, b in zip(tt, tj):
        assert sorted(a["chunks"]) == sorted(b["chunks"])
        assert np.abs(a["position"][:2] - b["position"][:2]).max() <= GRID
        assert a["audio"].shape == (mix.shape[1],)
        assert si_sdr(a["audio"], b["audio"]) >= 30.0
