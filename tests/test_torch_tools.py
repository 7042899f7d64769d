"""The port's tools (acousticswarms_speech_tpu_torch/scripts/) against the
JAX package's scripts and quickstart example, on the CPU: geometry caches,
the release-weights life cycle (export, gated export, seeding a checkpoint)
and the quickstart's positions."""
import importlib.util
import json
import os
import shutil

import jax
import numpy as np
import pytest
from flax import serialization

from acousticswarms_speech_tpu.training import checkpoints as jax_ckpt
from acousticswarms_speech_tpu_torch.models import SepNet, SpotNet
from acousticswarms_speech_tpu_torch.models.msgpack_reader import read_msgpack
from acousticswarms_speech_tpu_torch.models.weights import load_release
from acousticswarms_speech_tpu_torch.scripts import (export_if_better,
                                                     export_release,
                                                     precompute_geometry,
                                                     quickstart,
                                                     seed_checkpoint_from_release)
from acousticswarms_speech_tpu_torch.training import checkpoints as ckpt
from test_torch_pipeline import (SEP_SMALL, SPOT_SMALL, _seeded_weights,
                                 one_torch_thread)  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = os.path.join(REPO, ".devdata_v2", "test")
# The pipeline tests' narrow networks with two U-Net levels, so that the JAX
# package builds their parameters quickly.
NETS = {"SpeakerLocalization": (SpotNet, dict(SPOT_SMALL, stride_list=(4, 4))),
        "SpeakerSeparation": (SepNet, dict(SEP_SMALL, n_mics=7,
                                           stride_list=(4, 4)))}


def _jax_script(path, name):
    """A JAX-package script (scripts/, examples/) as a module."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_precompute_geometry_matches_jax(tmp_path, monkeypatch):
    """Two dev scenes at a 0.1 m grid: the same cache file in each scene,
    with equal arrays; the port's evaluation setup then reads it."""
    jax_script = _jax_script("scripts/precompute_geometry.py",
                             "jax_precompute_geometry")
    roots = {}
    for side in ("jax", "torch"):
        roots[side] = tmp_path / side
        for scene in ("00000", "00001"):
            os.makedirs(roots[side] / scene)
            shutil.copy(os.path.join(DEV, scene, "metadata.json"),
                        roots[side] / scene)
    monkeypatch.setattr("sys.argv", ["precompute_geometry.py",
                                     str(roots["jax"]), "0.1"])
    jax_script.main()
    precompute_geometry.main([str(roots["torch"]), "--grid_size", "0.1"])
    for scene in ("00000", "00001"):
        want = sorted(os.listdir(roots["jax"] / scene))
        assert sorted(os.listdir(roots["torch"] / scene)) == want
        caches = [f for f in want if f.startswith("tdoa_geometry_")]
        assert len(caches) == 1
        with np.load(roots["jax"] / scene / caches[0]) as a, \
                np.load(roots["torch"] / scene / caches[0]) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def _experiment(root, name, model_name, val_losses):
    """A narrow experiment whose checkpoints/ holds epochs 0 and 1 (weights
    from seeds 0 and 1) written by the port, with a sidecar of
    `val_losses`."""
    exp = os.path.join(root, name)
    os.makedirs(os.path.join(exp, "checkpoints"))
    cls, params = NETS[model_name]
    desc = {"model_name": model_name, "sr": 48000, "model_params": params,
            "lr_sched_params": {}, "training_params": {},
            "train_set_params": {}, "test_set_params": {}}
    with open(os.path.join(exp, "description.json"), "w") as f:
        json.dump(desc, f)
    for epoch in range(2):
        model = cls(**params)
        _seeded_weights(model, epoch)
        ckpt.save_params(os.path.join(exp, "checkpoints",
                                      f"{name}_{epoch}.msgpack"), model)
    ckpt.save_state(os.path.join(exp, "checkpoints", "state.msgpack"), None,
                    {}, [1.0] * len(val_losses), val_losses,
                    len(val_losses) - 1, 1e-3)
    return exp


def _release_bytes(exp):
    with open(os.path.join(exp, "release", "params_f16.msgpack"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("model_name", sorted(NETS))
def test_export_release_matches_jax_bit_for_bit(tmp_path, model_name):
    """The best checkpoint (epoch 1 by the sidecar) exported by both
    scripts: equal bytes; both packages load the file, to the float16
    rounding of the checkpoint's parameters."""
    jax_script = _jax_script("scripts/export_release.py", "jax_export_release")
    exp = _experiment(str(tmp_path), "exp", model_name, [2.0, 1.5])
    jax_script.export(exp)
    want = _release_bytes(exp)
    shutil.rmtree(os.path.join(exp, "release"))
    export_release.main([exp, "--device", "cpu"])
    assert _release_bytes(exp) == want

    trained = ckpt.load_params(os.path.join(exp, "checkpoints", "exp_1.msgpack"))
    port = load_release(exp, device="cpu").state_dict()
    for k, v in trained.items():
        np.testing.assert_array_equal(
            port[k].numpy(), v.numpy().astype(np.float16).astype(np.float32))
    # the JAX package's loader, into a template of the file's own structure
    template = jax.tree_util.tree_map(np.zeros_like,
                                      serialization.msgpack_restore(want))
    loaded = _flat(jax_ckpt.load_params(
        os.path.join(exp, "release", "params_f16.msgpack"),
        template)["params"])
    assert sorted(loaded) == sorted(trained)
    for k, v in trained.items():
        np.testing.assert_array_equal(loaded[k],
                                      v.numpy().astype(np.float16), err_msg=k)


@pytest.mark.parametrize("threshold", [1.4, 1.5, 1.6])
def test_export_if_better_decides_like_jax(tmp_path, monkeypatch, threshold):
    """Best validation loss 1.5: below, at and above the threshold.  The
    same decision on both sides, and the same file when it exports."""
    jax_script = _jax_script("scripts/export_if_better.py",
                             "jax_export_if_better")
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    exp = _experiment(str(tmp_path), "exp", "SpeakerLocalization", [2.0, 1.5])
    monkeypatch.setattr("sys.argv", ["export_if_better.py", exp,
                                     str(threshold)])
    jax_script.main()
    release = os.path.join(exp, "release")
    jax_exported = os.path.exists(release)
    want = _release_bytes(exp) if jax_exported else None
    shutil.rmtree(release, ignore_errors=True)
    got = export_if_better.export_if_better(exp, threshold, device="cpu")
    assert (got is not None) == jax_exported == (threshold >= 1.5)
    if jax_exported:
        assert _release_bytes(exp) == want


def test_seed_checkpoint_from_release_matches_jax(tmp_path, monkeypatch):
    """From an experiment with only release weights: the checkpoint tree
    the JAX script writes; a second call writes nothing."""
    jax_script = _jax_script("scripts/seed_checkpoint_from_release.py",
                             "jax_seed_checkpoint")
    src = _experiment(str(tmp_path / "src"), "exp", "SpeakerSeparation",
                      [2.0, 1.5])
    export_release.export(src, device="cpu")
    trees = {}
    for side in ("jax", "torch"):
        exp = str(tmp_path / side / "exp")
        os.makedirs(os.path.join(exp, "release"))
        for f in ("description.json", "release/params_f16.msgpack"):
            shutil.copy(os.path.join(src, f), os.path.join(exp, f))
        if side == "jax":
            monkeypatch.setattr("sys.argv", ["seed.py", exp, "7"])
            jax_script.main()
        else:
            out = seed_checkpoint_from_release.seed(exp, 7, device="cpu")
            assert out == os.path.join(exp, "checkpoints", "exp_7.msgpack")
            assert seed_checkpoint_from_release.seed(exp, 8,
                                                     device="cpu") is None
        assert os.listdir(os.path.join(exp, "checkpoints")) == ["exp_7.msgpack"]
        trees[side] = read_msgpack(os.path.join(exp, "checkpoints",
                                                "exp_7.msgpack"))
    _assert_trees_equal(trees["torch"], trees["jax"])
    assert _flat(trees["torch"])["params.preproc.weight"].dtype == np.float32


def test_quickstart_matches_jax(tmp_path):
    """The same scene (the JAX quickstart's), and the same heads from the
    delay-and-sum search, within a millimetre."""
    jax_quick = _jax_script("examples/quickstart.py", "jax_quickstart")
    mix_j = jax_quick.make_scene()
    mix_t = quickstart.make_scene(device="cpu")
    np.testing.assert_allclose(mix_t, mix_j, rtol=0,
                               atol=1e-6 * np.abs(mix_j).max())
    from acousticswarms_speech_tpu import JointPipeline as JaxPipeline
    from acousticswarms_speech_tpu.search.spotform import \
        DelayAndSumExecutor as JaxDelayAndSum

    jp = JaxPipeline.__new__(JaxPipeline)  # as examples/quickstart.py does
    jp.spot_model = JaxDelayAndSum()
    jp.sep_model = None
    jp.times = [0.0] * 5
    jp.previous_config = None
    jp.mic_processor = None
    jp.setup(quickstart.MIC_POS, quickstart.ROI, cache_dir=str(tmp_path))
    want, *_ = jp.localize_by_separation(mix_j)
    pipe, got = quickstart.localize(mix_j, device="cpu",
                                    cache_dir=str(tmp_path))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].center_pos(), w[0].center_pos(),
                                   atol=1e-3)
    with pytest.raises(ValueError, match="no separation network"):
        pipe.separate_by_localization(mix_j, got)


def test_tools_need_a_card_unless_asked_for_the_cpu(tmp_path):
    """Without a card, the tools that load a network raise instead of
    falling back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    exp = _experiment(str(tmp_path), "exp", "SpeakerLocalization", [1.0])
    bare = _experiment(str(tmp_path / "bare"), "exp", "SpeakerLocalization",
                       [1.0])
    shutil.rmtree(os.path.join(bare, "checkpoints"))
    for call in (lambda: export_release.main([exp]),
                 lambda: export_if_better.main([exp, "2.0"]),
                 lambda: seed_checkpoint_from_release.main([bare, "3"]),
                 lambda: quickstart.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
