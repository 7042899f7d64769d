"""The controls at each cell's own size on the card: the port with TF32 on
(the nearest precision below the configurations' float32 with TF32 off)
and the port's bfloat16 path must both come out not correct, on three
seeds, with a window long enough for the mixtures a run checks."""
import pytest

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
