"""The port's msgpack reader and weight loading against flax, and the port's
import hygiene (it must not pull in JAX, flax, msgpack or the JAX package)."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from acousticswarms_speech_tpu_torch.models import load_release
from acousticswarms_speech_tpu_torch.models.msgpack_reader import (
    read_msgpack,
    unpackb,
)
from acousticswarms_speech_tpu_torch.models.weights import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RELEASES = ["speech_localization", "speech_separation"]


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("exp", RELEASES)
def test_reader_matches_flax_on_release(exp):
    """Every array of the release file, read by the port's reader, is
    bit-identical (values, dtype, shape) to flax's from_bytes."""
    path = os.path.join(REPO, "experiments", exp, "release", "params_f16.msgpack")
    with open(path, "rb") as f:
        raw = f.read()
    want = _flatten(serialization.from_bytes(None, raw))
    got = _flatten(read_msgpack(path))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_reader_scalar_and_container_types():
    """Scalars, strings, binaries, nested containers and small/large arrays
    round-trip through flax's writer and the port's reader."""
    rng = np.random.default_rng(0)
    tree = {
        "a": {"w": rng.normal(size=(3, 4)).astype(np.float32),
              "i": np.arange(300, dtype=np.int64)},
        "b": rng.normal(size=(70000,)).astype(np.float16),
        "c": np.zeros((0, 5), np.float32),
        "s": "x" * 40,
    }
    data = serialization.msgpack_serialize(tree)
    got = unpackb(data)
    assert got["s"] == tree["s"]
    for key in ("b", "c"):
        np.testing.assert_array_equal(got[key], tree[key])
    np.testing.assert_array_equal(got["a"]["w"], tree["a"]["w"])
    np.testing.assert_array_equal(got["a"]["i"], tree["a"]["i"])
    import msgpack

    for v in [0, 127, 128, -1, -33, 2 ** 16, -(2 ** 31), 2 ** 40, 1.5, True,
              None, b"\x00\x01", [1, [2, {"k": 3}]], "é" * 300]:
        assert unpackb(msgpack.packb(v, use_bin_type=True)) == v


@pytest.mark.parametrize("exp", RELEASES)
def test_load_release_matches_jax_loader(exp):
    """load_release holds, under strict names, the float32 casts of flax's
    arrays, as the JAX package's loader casts them
    (training/experiment.py:96-106)."""
    import jax.numpy as jnp

    exp_dir = os.path.join(REPO, "experiments", exp)
    with open(os.path.join(exp_dir, "release", "params_f16.msgpack"), "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    tree = jax.tree_util.tree_map(
        lambda v: np.asarray(jnp.asarray(v, dtype=jnp.float32)), tree)
    want = from_jax_params(tree)
    got = load_release(exp_dir, device="cpu").state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], v), k
    if exp == "speech_separation":
        assert "bottleneck_0_intra.mhsa.in_proj_bias" in got


def test_entry_points_raise_without_cuda(monkeypatch):
    """With no card, entry points asked for cuda (the default) raise."""
    from acousticswarms_speech_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        load_release(os.path.join(REPO, "experiments", "speech_separation"))
    assert resolve_device("cpu") == torch.device("cpu")


def test_import_hygiene_subprocess():
    """Importing the port and all its modules loads neither jax, flax,
    msgpack nor the JAX package."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import acousticswarms_speech_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from acousticswarms_speech_tpu_torch import JointPipeline, MicArray\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'msgpack', 'acousticswarms_speech_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
