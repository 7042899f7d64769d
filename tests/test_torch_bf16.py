"""The bfloat16 configuration (`use_bf16`, the evaluate CLI's --use_fp16)
against the JAX package's, on the CPU, on the same weights cast to bfloat16.

Modules: the JAX modules run eagerly, op by op, each rounding to bfloat16,
with attention scores, softmax and norm statistics in float32.  The port
computes the attention blocks and the norms in the same order and dtypes, so
they agree to one bfloat16 rounding step (2^-8) of the output's peak.  The
Conformer layer's convolution module is further apart: the CPU backend of
JAX expands a bfloat16 sigmoid (in the GLU) into exp, add and divide with a
rounding after each, where torch rounds once.

Executors and the pipeline: the JAX package jit-compiles its sweeps, and the
compiler keeps some bfloat16 intermediates in float32, so the port's outputs
differ from JAX's by bfloat16 rounding through the whole network.  Each
tolerance is twice the JAX package's own bfloat16 error against its float32
result on the same inputs: the port is held as close to JAX's bfloat16 as
that is to float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acousticswarms_speech_tpu.models import SepNet as JaxSepNet
from acousticswarms_speech_tpu.models import SpotNet as JaxSpotNet
from acousticswarms_speech_tpu.models import conformer as jax_conformer
from acousticswarms_speech_tpu.models import modules as jax_modules
from acousticswarms_speech_tpu.search import spotform as jax_spotform
from acousticswarms_speech_tpu.utils.metrics import si_sdr
from acousticswarms_speech_tpu_torch.models import SepNet, SpotNet
from acousticswarms_speech_tpu_torch.models import conformer, modules
from acousticswarms_speech_tpu_torch.search import spotform
from test_torch_pipeline import (GRID, SEP_SMALL, SPOT_SMALL, _fixture,
                                 _run_jax, _run_port, _seeded_weights,
                                 one_torch_thread)  # noqa: F401 (autouse)

ULP = 2.0 ** -8  # one bfloat16 rounding step, relative


def _bf16(tree):
    return jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), tree)


def _module_pair(case):
    """(JAX module, port module, input, extra JAX args, extra port args)."""
    rng = np.random.default_rng(7)
    seq = (3 * rng.normal(size=(2, 40, 16))).astype(np.float32)
    if case == "rel_pos_attention":
        return (jax_conformer.RelPosMHAXL(16, 2), conformer.RelPosMHAXL(16, 2),
                seq, (), ())
    if case == "conformer_layer":
        return (jax_conformer.ConformerLayer(16, 32, 2, 7),
                conformer.ConformerLayer(16, 32, 2, 7), seq, (), ())
    if case == "transformer_encoder":
        return (jax_modules.TransformerEncoder(16, 2, 32, 2),
                modules.TransformerEncoder(16, 2, 32, 2), seq, (), ())
    if case == "masked_inter_speaker_attention":
        # SepNet's inter-speaker layer: 40 time steps x 5 speaker slots,
        # of which the last two are padding
        x = (3 * rng.normal(size=(40, 5, 16))).astype(np.float32)
        mask = np.arange(5)[None, :].repeat(40, 0) < 3
        return (jax_modules.TransformerEncoderLayer(16, 2, 32),
                modules.TransformerEncoderLayer(16, 2, 32), x,
                (jnp.asarray(mask),), (torch.from_numpy(mask),))
    # norms, on inputs far from zero mean
    chan = (30 + 2 * rng.normal(size=(2, 8, 300))).astype(np.float32)
    if case == "group_norm":
        return jax_modules.GroupNorm(2, 8), modules.GroupNorm(2, 8), chan, (), ()
    if case == "channel_layer_norm":
        return (jax_modules.ChannelLayerNorm(8), modules.ChannelLayerNorm(8),
                chan, (), ())
    return (jax_modules.LayerNorm(16), modules.LayerNorm(16), seq + 30, (), ())


@pytest.mark.parametrize("case", [
    "rel_pos_attention", "transformer_encoder",
    "masked_inter_speaker_attention", "group_norm", "layer_norm",
    "channel_layer_norm"])
def test_module_bf16_matches_jax(case):
    """Within one bfloat16 step of the output's peak."""
    jax_mod, port, x, jax_args, port_args = _module_pair(case)
    params = _bf16(_seeded_weights(port, 0))
    want = np.asarray(jax_mod.apply(params, jnp.asarray(x, jnp.bfloat16),
                                    *jax_args).astype(jnp.float32))
    port = port.to(torch.bfloat16).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(torch.bfloat16), *port_args)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ULP * np.abs(want).max())


def test_conformer_layer_bf16_matches_jax():
    """Within four bfloat16 steps of the output's peak at most and one step
    of its mean magnitude on average (see the module docstring for the
    sigmoid's roundings)."""
    jax_mod, port, x, _, _ = _module_pair("conformer_layer")
    params = _bf16(_seeded_weights(port, 0))
    want = np.asarray(jax_mod.apply(params, jnp.asarray(x, jnp.bfloat16))
                      .astype(jnp.float32))
    port = port.to(torch.bfloat16).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    err = np.abs(got - want)
    assert err.max() <= 4 * ULP * np.abs(want).max()
    assert err.mean() <= ULP * np.abs(want).mean()


def _sweep_errors(got, want, rows_got, rows_want):
    """(powers, windowed powers: max relative error; off-diagonal SI-SDR
    matrix: max abs dB; rows: min SI-SDR in dB)."""
    off = ~np.eye(got.n, dtype=bool)
    return (np.abs(got.powers / want.powers - 1).max(),
            np.abs(got.powers_win / want.powers_win - 1).max(),
            np.abs(got.sisdr_mat - want.sisdr_mat)[off].max(),
            min(si_sdr(rows_got[i], rows_want[i]) for i in rows_want))


def test_spotform_executor_bf16_matches_jax():
    """SpotformExecutor(use_bf16=True).sweep of six candidates on 8192
    samples of the bench scene with the narrow SpotNet: powers, windowed
    powers, the off-diagonal SI-SDR matrix and the rows, each within twice
    the JAX package's own bfloat16 error against its float32 sweep (for the
    rows' SI-SDR: at most 6 dB below it)."""
    spot = SpotNet(**SPOT_SMALL)
    params = _seeded_weights(spot, 0)
    seg = _fixture(50000, 8192)
    rng = np.random.default_rng(0)
    cands = [rng.integers(-20, 20, 6).astype(np.float64) for _ in range(6)]
    idx = range(6)

    def jax_sweep(bf16):
        ex = jax_spotform.SpotformExecutor(JaxSpotNet(**SPOT_SMALL), params,
                                           use_bf16=bf16)
        res = ex.sweep(seg, cands, strict=1, with_similarity=True)
        return res, res.gather(idx, quantize=False)

    (w32, rows32), (wbf, rows_bf) = jax_sweep(False), jax_sweep(True)
    port = spotform.SpotformExecutor(spot, use_bf16=True, device="cpu",
                                     chunk=4)
    assert next(port.model.parameters()).dtype == torch.bfloat16
    got = port.sweep(seg, cands, strict=1, with_similarity=True)
    rows = got.gather(idx, quantize=False)
    own = _sweep_errors(wbf, w32, rows_bf, rows32)
    err = _sweep_errors(got, wbf, rows, rows_bf)
    assert err[0] <= 2 * own[0] and err[1] <= 2 * own[1], (err, own)
    assert err[2] <= 2 * own[2], (err, own)
    assert err[3] >= own[3] - 6.0, (err, own)


def test_separation_bf16_matches_jax():
    """SeparationInference(use_bf16=True) with the narrow SepNet, three
    speakers on 8192 samples: the max error within twice the JAX package's
    own bfloat16 error against float32, each speaker's SI-SDR at most 6 dB
    below JAX's own."""
    sep = SepNet(**SEP_SMALL)
    params = _seeded_weights(sep, 1)
    seg = _fixture(50000, 8192)
    rng = np.random.default_rng(1)
    offs = [rng.integers(-30, 30, 6).astype(np.float64) for _ in range(3)]
    want32, want = (jax_spotform.SeparationInference(
        JaxSepNet(**SEP_SMALL), params, use_bf16=bf16).infer_sample(seg, offs)
        for bf16 in (False, True))
    got = spotform.SeparationInference(sep, use_bf16=True,
                                       device="cpu").infer_sample(seg, offs)
    assert got.shape == want.shape == (3, 8192) and got.dtype == np.float32
    own = np.abs(want - want32).max()
    assert np.abs(got - want).max() <= 2 * own
    for k in range(3):
        assert si_sdr(got[k], want[k]) >= si_sdr(want[k], want32[k]) - 6.0


@pytest.fixture
def four_survivors(monkeypatch):
    """Both packages keep the 4 strongest coarse survivors (MAX_BIG_PATCH,
    default 30), as tests/test_torch_eval.py does: with untrained networks
    every candidate passes the power gate."""
    from acousticswarms_speech_tpu import constants as jax_constants
    from acousticswarms_speech_tpu.search import subdivide as jax_subdivide
    from acousticswarms_speech_tpu_torch import constants
    from acousticswarms_speech_tpu_torch.search import subdivide

    for mod in (jax_subdivide, subdivide, jax_constants, constants):
        monkeypatch.setattr(mod, "MAX_BIG_PATCH", 4)


def test_joint_pipeline_small_nets_bf16_matches_jax(four_survivors):
    """The narrow-network pipeline of test_torch_pipeline.py in bfloat16,
    with two U-Net levels and 4 coarse survivors to keep it short:
    the JAX package's heads (matched by position, within one grid cell),
    the separated audio at >= 20 dB SI-SDR against JAX's, and the spot
    calls.  The localization audio is compared for the heads that elect
    the same member of their cluster: a cluster's head is its loudest
    member, and near-ties of power within bfloat16 noise can elect another
    member (one head of eight on this scene), whose waveform is another
    candidate's."""
    spot_cfg = dict(SPOT_SMALL, stride_list=(4, 4))
    sep_cfg = dict(SEP_SMALL, stride_list=(4, 4))
    spot_t, sep_t = SpotNet(**spot_cfg), SepNet(**sep_cfg)
    spot_p = _seeded_weights(spot_t, 0)
    sep_p = _seeded_weights(sep_t, 1)
    mix = _fixture(48000, 24000)
    pj, lj, aj, jp = _run_jax(JaxSpotNet(**spot_cfg), spot_p,
                              JaxSepNet(**sep_cfg), sep_p, mix, 0.25,
                              use_bf16=True)
    pt, lt, at, tp = _run_port(spot_t, sep_t, mix, 0.25, use_bf16=True)
    assert len(pt) == len(pj) >= 1
    assert tp.stage_metrics()["spotform_calls"] == \
        jp.stage_metrics()["spotform_calls"]
    pos_j = np.array([h[0].center_pos()[:2] for h in pj])
    elected = 0
    for k, h in enumerate(pt):
        d = np.abs(pos_j - np.asarray(h[0].center_pos()[:2])).max(1)
        j = int(d.argmin())
        assert d[j] <= GRID, (k, d)
        assert np.isfinite(at[k]).all()
        assert si_sdr(at[k], aj[j]) >= 20.0, k
        if np.array_equal(h[4]["audio_offset"], pj[j][4]["audio_offset"]):
            assert si_sdr(lt[k], lj[j]) >= 20.0, k
            elected += 1
    assert elected >= len(pt) - 1
