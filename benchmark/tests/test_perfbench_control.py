"""The controls and the sound variants at each cell's own size on the card,
on three seeds, with a window long enough for the mixtures a run checks:
the port with TF32 on (the nearest precision below the configurations'
float32 with TF32 off) and the port's bfloat16 path must both come out not
correct, and each sound variant of `calibrate.py` (float32 summed in
another order) correct, or not correct only through a decision it flipped
(`check.decides_otherwise`)."""
import pytest

from benchmark import check
from benchmark.calibrate import SOUND

SEEDS = (2 ** 32 + 101, 2 ** 32 + 102, 2 ** 32 + 103)
WINDOW_S = {"release7.fixed_array": 10.0, "release7.new_array": 10.0}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("control", ["tf32", "bf16"])
@pytest.mark.parametrize("workload", sorted(WINDOW_S))
def test_control_is_not_correct(card, workload, control):
    from benchmark.calibrate import readings

    for r in readings(workload, SEEDS, control, WINDOW_S[workload], card):
        assert r["correct"] is False, r


@pytest.mark.gpu
@pytest.mark.parametrize("variant", SOUND)
@pytest.mark.parametrize("workload", sorted(WINDOW_S))
def test_sound_variant_is_correct(card, workload, variant):
    """Correct, but where a near tie let the reordered sums flip a decision
    (an exact number, or two heads' rank): the exact limits fail that run,
    and PERF.md records it."""
    from benchmark.calibrate import readings

    for r in readings(workload, SEEDS, variant, WINDOW_S[workload], card):
        assert r["failed"] == 0 and r["numbers"]["records_missing"] == 0, r
        assert r["correct"] or check.decides_otherwise(r["numbers"]), r
