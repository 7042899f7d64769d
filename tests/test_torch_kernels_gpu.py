"""The hand-written CUDA kernels of acousticswarms_speech_tpu_torch against
their plain PyTorch versions, on the card.

Every test here carries the `gpu` marker and skips without a CUDA device
(decided inside a fixture, so every worker collects the same tests).  This
file imports neither JAX nor the JAX package, so it runs on a machine that
has neither:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from acousticswarms_speech_tpu_torch.ops import roll_kernel  # noqa: E402
from acousticswarms_speech_tpu_torch.ops.shift import (  # noqa: E402
    roll_channels_batch,
    roll_channels_batch_plain,
    roll_zero_fill_batch,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    return torch.device("cuda")


def _shifts(B, T, gen, M=7):
    s = torch.randint(-T + 1, T, (B, M), generator=gen, dtype=torch.int32)
    for k, v in enumerate([-(T - 1), -5, 0, 3, T - 1][:B]):
        s[k] = v
    return s


@pytest.mark.parametrize("M", [7, 10])
@pytest.mark.parametrize("B,T", [(1, 1), (3, 5), (32, 72000), (37, 72000),
                                 (5, 144000), (512, 72000), (4, 1023),
                                 (7000, 1024)])
def test_roll_kernel_matches_plain(cuda, B, T, M):
    """Exact equality: the kernel copies samples.  T = 1023 and 5 take the
    scalar-store path, the others the 16-byte one.  B = 7000 at M = 10 puts
    70000 rows past the grid's y limit of 65535 (287 MB out), so blocks
    walk more than one row."""
    gen = torch.Generator().manual_seed(B * 100003 + T + M)
    mix = torch.randn(M, T, generator=gen).to(cuda)
    shifts = _shifts(B, T, gen, M).to(cuda)
    before = roll_kernel.roll_channels_batch_cuda.launches
    got = roll_channels_batch(mix, shifts)
    torch.cuda.synchronize()
    assert roll_kernel.roll_channels_batch_cuda.launches == before + 1
    assert torch.equal(got, roll_channels_batch_plain(mix, shifts))


def test_roll_zero_fill_on_card(cuda):
    gen = torch.Generator().manual_seed(1)
    mix = torch.randn(7, 4096, generator=gen).to(cuda)
    shifts = _shifts(6, 4096, gen).to(cuda)
    got = roll_zero_fill_batch(mix, shifts).cpu()
    want = roll_zero_fill_batch(mix.cpu(), shifts.cpu())
    assert torch.equal(got, want)


def test_roll_kernel_rejects_bad_inputs(cuda):
    mix = torch.zeros(7, 64, device=cuda)
    shifts = torch.zeros(2, 7, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        roll_kernel.roll_channels_batch_cuda(mix.double(), shifts)
    with pytest.raises(ValueError):
        roll_kernel.roll_channels_batch_cuda(mix.t(), shifts)
    with pytest.raises(ValueError):
        roll_kernel.roll_channels_batch_cuda(mix, shifts[:, :5].contiguous())


def test_roll_kernel_counts_launches_and_runs_in_threads(cuda):
    """Two threads launch the kernel at once: every result equals the
    plain version and every launch is counted once."""
    import threading

    gen = torch.Generator().manual_seed(5)
    mix = torch.randn(7, 9000, generator=gen).to(cuda)
    shifts = [_shifts(11, 9000, gen).to(cuda) for _ in range(2)]
    before = roll_kernel.roll_channels_batch_cuda.launches
    bad = []

    def run(k):
        for _ in range(50):
            got = roll_kernel.roll_channels_batch_cuda(mix, shifts[k])
            if not torch.equal(got, roll_channels_batch_plain(mix, shifts[k])):
                bad.append(k)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not bad
    assert roll_kernel.roll_channels_batch_cuda.launches - before == 100


def test_roll_ab_times_two_sources(cuda, tmp_path):
    """scripts/roll_ab builds a second copy of the kernel's source, holds it
    equal to the plain version and times both versions at each shape, twice
    a round (one order, then the reverse)."""
    import shutil

    from acousticswarms_speech_tpu_torch.scripts import roll_ab

    other = tmp_path / "copy.cu"
    shutil.copy(roll_kernel.SOURCE, other)
    res = roll_ab.compare({"current": roll_kernel.SOURCE, "copy": str(other)},
                          [(37, 10, 4096)], rounds=2, reps=2)
    times = res[(37, 10, 4096)]
    assert sorted(times) == ["copy", "current"]
    assert all(len(v) == 4 and min(v) > 0 for v in times.values())
