"""JointPipeline.forward(mix, profile_dir=...) and
separate_by_localization_by_sample, on the CPU: the profiled forward
writes a Chrome trace with one span per stage and returns what the
unprofiled forward returns; separation at given offsets equals the JAX
package's."""
import glob
import json

import numpy as np
import pytest

from acousticswarms_speech_tpu.models import SepNet as JaxSepNet
from acousticswarms_speech_tpu.models import SpotNet as JaxSpotNet
from acousticswarms_speech_tpu.pipeline.joint import JointPipeline as JaxPipeline
from acousticswarms_speech_tpu_torch.models import SepNet, SpotNet
from acousticswarms_speech_tpu_torch.pipeline.joint import STAGES, JointPipeline
from acousticswarms_speech_tpu_torch.search.spotform import DelayAndSumExecutor
from test_torch_pipeline import (SEP_SMALL, SPOT_SMALL, _fixture, _forward,
                                 _seeded_weights,
                                 one_torch_thread)  # noqa: F401 (autouse)


def test_profiled_forward_writes_stage_spans(tmp_path):
    """Delay-and-sum search and the narrow SepNet on 0.5 s of the bench
    scene: the five stage spans, named after the stage_metrics() keys, in
    one trace file, and the same heads and audio (bit for bit on the CPU)
    as without the profiler."""
    sep = SepNet(**SEP_SMALL)
    _seeded_weights(sep, 1)
    mix = _fixture(48000, 24000)
    outs = []
    for profile_dir in (None, str(tmp_path)):
        pipe = JointPipeline(DelayAndSumExecutor(device="cpu"), sep,
                             device="cpu", sweep_crop_seconds=0.25)
        outs.append(_forward(pipe, mix, profile_dir=profile_dir))
    (p0, l0, a0, _), (p1, l1, a1, pipe) = outs
    assert len(p0) == len(p1) >= 1
    for h0, h1 in zip(p0, p1):
        np.testing.assert_array_equal(h0[0].center_pos(), h1[0].center_pos())
    np.testing.assert_array_equal(l0, l1)
    np.testing.assert_array_equal(a0, a1)
    traces = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = [e["name"] for e in events
             if e.get("name") in STAGES and e.get("cat") == "user_annotation"]
    assert sorted(spans) == sorted(STAGES)
    assert set(STAGES) == {k for k in pipe.stage_metrics()
                           if k.startswith("time_")}


@pytest.mark.parametrize("n_speakers", [0, 1, 3])
def test_separate_by_localization_by_sample_matches_jax(n_speakers):
    """The narrow SepNet at given TDoA offsets on 8192 samples of the bench
    scene: within 1e-4 of the output's peak (float32 sums in other orders,
    as tests/test_torch_models.py), and None for no offsets."""
    spot, sep = SpotNet(**SPOT_SMALL), SepNet(**SEP_SMALL)
    spot_p = _seeded_weights(spot, 0)
    sep_p = _seeded_weights(sep, 1)
    jp = JaxPipeline(JaxSpotNet(**SPOT_SMALL), spot_p, JaxSepNet(**SEP_SMALL),
                     sep_p)
    tp = JointPipeline(spot, sep, device="cpu")
    seg = _fixture(60000, 8192)
    rng = np.random.default_rng(n_speakers)
    offs = [rng.integers(-30, 30, 6).astype(np.float64)
            for _ in range(n_speakers)]
    want = jp.separate_by_localization_by_sample(seg, offs)
    got = tp.separate_by_localization_by_sample(seg, offs)
    if n_speakers == 0:
        assert got is None and want is None
        return
    assert got.shape == want.shape == (n_speakers, 8192)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
