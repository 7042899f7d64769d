"""The launch path of the port's compiled code (runtime/build.py Library) on
a stand-in library, so that it runs without a card: the set-up function
once per device, the stream handle passed last, a non-zero cudaError
raised with the kernel's name, and each launch counted once on the
wrapper, from any thread.  The kernels themselves are held against their
plain versions by the `gpu` tests."""
import contextlib
import sys
import threading

import pytest
import torch

from acousticswarms_speech_tpu_torch.runtime import build as libbuild


class _FakeLib:
    def __init__(self):
        self.calls = []

    def setup(self):
        self.calls.append("setup")
        return 0

    def kernel(self, err, *args):
        self.calls.append((err, *args))
        return err


@pytest.fixture
def fake(monkeypatch):
    """A Library of roll.cu whose loaded library is a _FakeLib, on a CPU
    build of torch: device 0 current, the raw stream of device i is
    100 + i."""
    lib = libbuild.Library("roll.cu", None, init="setup")
    loaded = _FakeLib()
    monkeypatch.setattr(lib, "get", lambda: loaded)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 100 + index, raising=False)

    def wrapper():
        pass

    wrapper.launches = 0
    return lib, loaded, wrapper


def test_launch_sets_up_once_per_device_and_counts(fake):
    lib, loaded, wrapper = fake
    for _ in range(3):
        lib.launch("kernel", wrapper, torch.device("cuda"), 0, 7)
    lib.launch("kernel", wrapper, torch.device("cuda", 1), 0, 8)
    lib.launch("kernel", wrapper, torch.device("cuda", 0), 0, 9)
    assert loaded.calls == ["setup", (0, 7, 100), (0, 7, 100), (0, 7, 100),
                            "setup", (0, 8, 101), (0, 9, 100)]
    assert wrapper.launches == 5


def test_launch_error_raises_and_is_not_counted(fake):
    lib, loaded, wrapper = fake
    with pytest.raises(RuntimeError, match="roll.cu kernel failed: cudaError 9"):
        lib.launch("kernel", wrapper, torch.device("cuda"), 9)
    assert wrapper.launches == 0
    loaded.setup = lambda: 2
    with pytest.raises(RuntimeError, match="roll.cu setup failed: cudaError 2"):
        lib.launch("kernel", wrapper, torch.device("cuda", 3), 0)
    assert wrapper.launches == 0


def test_launches_from_many_threads_are_each_counted(fake):
    lib, _, wrapper = fake
    n_threads, per_thread = 16, 400
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            lib.launch("kernel", wrapper, torch.device("cuda"), 0)
            for _ in range(per_thread)]) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == n_threads * per_thread
