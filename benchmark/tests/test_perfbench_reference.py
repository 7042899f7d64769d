"""The comparison that decides `correct`, driven through a whole run on the
CPU at narrow widths (the harness's look for a card skipped): the port in
float32 agrees with the plain reference, its bfloat16 path does not, and
a run whose timed path is broken underneath comes out not correct."""
import math

import numpy as np
import pytest
import torch

from benchmark import check, harness
from benchmark.tests import tiny

SEED = 2 ** 33 + 5


def _run(trace=False, **kw):
    torch.set_num_threads(4)
    import time

    return harness.run_cell(tiny.spec(pool=3), SEED, 0.01, trace, "cpu",
                            time.perf_counter(), **kw)


@pytest.fixture(scope="module")
def sound():
    return _run()


def test_float32_port_agrees_with_the_reference(sound):
    assert sound["correct"] is True
    assert sound["attempted"] == 1 and sound["failed"] == 0
    numbers = {k: v["value"] for k, v in sound["check"].items()}
    assert set(numbers) == set(check.NUMBERS) | {"records_missing"}
    assert all(numbers[k] == 0 for k in check.EXACT + ("records_missing",)
               ), numbers
    for k in check.CONTINUOUS:
        assert math.isfinite(numbers[k]), numbers
        assert numbers[k] <= sound["check"][k]["limit"], numbers
    assert list(sound)[-1] == "check"


def test_bf16_control_is_not_correct():
    result = _run(control="bf16")
    assert result["correct"] is False
    numbers = {k: v["value"] for k, v in result["check"].items()}
    assert numbers["audio_err"] > result["check"]["audio_err"]["limit"] \
        or numbers["heads_diff"] > 0 or numbers["spot_calls_diff"] > 0


def _scale_output(cls, name, factor):
    orig = getattr(cls, name)

    def scaled(self, *args, **kwargs):
        return orig(self, *args, **kwargs) * factor

    return scaled


FAULTS = ("separated_audio_altered", "srp_map_altered", "half_batch_dropped")


@pytest.mark.parametrize("fault", FAULTS)
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    from acousticswarms_speech_tpu_torch.ops.srp import SrpMapComputer
    from acousticswarms_speech_tpu_torch.search import spotform

    if fault == "separated_audio_altered":
        monkeypatch.setattr(spotform.SeparationInference, "infer_sample",
                            _scale_output(spotform.SeparationInference,
                                          "infer_sample", np.float32(1.01)))
    elif fault == "srp_map_altered":
        monkeypatch.setattr(SrpMapComputer, "__call__",
                            _scale_output(SrpMapComputer, "__call__", 1.001))
    else:
        run = spotform._BatchedSweep._run

        def half(self, mix, shifts, onehot):
            """Half of the candidates swept; the others read zeros."""
            keep = (len(shifts) + 1) // 2
            parts = run(self, mix, shifts[:keep], onehot)
            return tuple(torch.cat([p, torch.zeros((len(shifts) - keep,
                                                    *p.shape[1:]),
                                                   dtype=p.dtype)])
                         for p in parts)

        monkeypatch.setattr(spotform._BatchedSweep, "_run", half)
    result = _run()
    assert result["correct"] is False, result["check"]


def test_traced_run_records_every_call():
    result = _run(trace=True)
    assert result["correct"] is True
    assert result["check"]["records_missing"]["value"] == 0


def test_sweeps_past_the_wrapper_are_not_correct():
    """Work moved off a function the benchmark records through (here the
    sweep, on a subclass of its own) fails the run instead of dropping out
    of the metrics read from those records."""
    from acousticswarms_speech_tpu_torch.search import spotform

    assert "sweep" not in vars(spotform.SpotformExecutor)
    spotform.SpotformExecutor.sweep = spotform._BatchedSweep.sweep
    try:
        result = _run(trace=True)
    finally:
        del spotform.SpotformExecutor.sweep
    assert result["check"]["records_missing"]["value"] >= 1
    assert result["correct"] is False


def test_a_record_point_gone_fails_the_run():
    class Port:
        pass

    with pytest.raises(RuntimeError, match="Port.sweep"):
        harness.Recorder(shapes=True)._replace(Port, "sweep", lambda f: f)
