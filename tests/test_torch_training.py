"""The port's training slice against the JAX package's, on the CPU: dataset
items, losses, the scheduler, checkpoints across packages, the sidecar, the
on-device noise augmentation, the init distribution, one train step of each
network at narrow widths, and one train() call with a resume."""
import json
import os
import random
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acousticswarms_speech_tpu.models import SepNet as JaxSepNet
from acousticswarms_speech_tpu.models import SpotNet as JaxSpotNet
from acousticswarms_speech_tpu.models.factory import init_model as jax_init_model
from acousticswarms_speech_tpu.training import checkpoints as jax_ckpt
from acousticswarms_speech_tpu.training import datasets as jax_datasets
from acousticswarms_speech_tpu.training import losses as jax_losses
from acousticswarms_speech_tpu.training.experiment import \
    best_checkpoint_path as jax_best_checkpoint_path
from acousticswarms_speech_tpu.training.schedulers import \
    ReduceLROnPlateau as JaxPlateau
from acousticswarms_speech_tpu.training.train import make_step_fns as jax_make_step_fns
from acousticswarms_speech_tpu_torch.models import SepNet, SpotNet
from acousticswarms_speech_tpu_torch.models.factory import init_model, param_count
from acousticswarms_speech_tpu_torch.training import checkpoints as ckpt
from acousticswarms_speech_tpu_torch.training import datasets
from acousticswarms_speech_tpu_torch.training import losses
from acousticswarms_speech_tpu_torch.training.experiment import (
    best_checkpoint_path,
    load_model_from_exp,
)
from acousticswarms_speech_tpu_torch.training.schedulers import ReduceLROnPlateau
from acousticswarms_speech_tpu_torch.training.train import (
    _device_perturb,
    make_step_fns,
    perturb_generator,
    to_device,
    train,
)
from test_torch_pipeline import (SEP_SMALL, SPOT_SMALL, _seeded_weights,
                                 one_torch_thread)  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = os.path.join(REPO, ".devdata_v2", "test")

# The pipeline tests' narrow networks with two U-Net levels, so that the JAX
# package compiles their init and train step quickly on the CPU.
STEP_SPOT = dict(SPOT_SMALL, stride_list=(4, 4))
STEP_SEP = dict(SEP_SMALL, stride_list=(4, 4))

DATASETS = {
    "loc": (jax_datasets.LocalizationDataset, datasets.LocalizationDataset,
            dict(compression_prob=0)),
    "sep": (jax_datasets.SeparationDataset, datasets.SeparationDataset,
            dict(compression_prob=0, n_speakers=5, crop_seconds=0.5)),
}


def _items(ds, n, seed, perturb_on_device=False):
    ds.perturb_on_device = perturb_on_device
    np.random.seed(seed)
    random.seed(seed)
    return [ds[i] for i in range(n)]


@pytest.mark.parametrize("kind", sorted(DATASETS))
@pytest.mark.parametrize("split", ["train", "test"])
def test_dataset_items_match_jax(kind, split):
    """Same global seeds -> equal items (exact: the same NumPy code on the
    same WAVs, host noise included)."""
    jax_cls, cls, kw = DATASETS[kind]
    want = _items(jax_cls(dataset_type=split, input_dir=DEV, **kw), 3, 7)
    got = _items(cls(dataset_type=split, input_dir=DEV, **kw), 3, 7)
    for w_item, g_item in zip(want, got):
        for w, g in zip(w_item, g_item):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("name", ["l1", "snr", "snr_w_scaled_neg", "fused",
                                  "sisdr"])
def test_losses_match_jax(name):
    """Each registered loss on outputs with silent and non-silent targets,
    to 1e-6 (relative to the loss's magnitude)."""
    rng = np.random.default_rng(0)
    out = rng.normal(size=(4, 1, 2000)).astype(np.float32) * 0.1
    gt = rng.normal(size=(4, 1, 2000)).astype(np.float32) * 0.1
    gt[1] = 0.0  # a negative (silent) target
    want = float(jax_losses.get_loss_fn(name)(jnp.asarray(out), jnp.asarray(gt)))
    got = float(losses.get_loss_fn(name)(torch.from_numpy(out),
                                         torch.from_numpy(gt)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)
    ns = losses.neg_sdr(torch.from_numpy(out[:, 0]), torch.from_numpy(gt[:, 0]),
                        "sisdr").numpy()
    np.testing.assert_allclose(
        ns, np.asarray(jax_losses.neg_sdr(jnp.asarray(out[:, 0]),
                                          jnp.asarray(gt[:, 0]), "sisdr")),
        rtol=1e-6, atol=1e-6)


def test_scheduler_sequence_matches_jax():
    rng = np.random.default_rng(1)
    vals = list(rng.normal(size=40).cumsum() * 0.1 + 5.0)
    a = JaxPlateau(lr_min=1e-5, factor=0.5, patience=2, dont_halve_until_epoch=5)
    b = ReduceLROnPlateau(lr_min=1e-5, factor=0.5, patience=2,
                          dont_halve_until_epoch=5)
    lr_a = lr_b = 1e-3
    for epoch, v in enumerate(vals):
        lr_a = a(lr_a, epoch, v)[1]
        lr_b = b(lr_b, epoch, v)[1]
        assert lr_a == lr_b and a.state_dict() == b.state_dict()


def _jax_template(model_cls, small, inputs):
    return jax_init_model(model_cls(**small), jax.random.PRNGKey(0), inputs)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_param_files_load_across_packages(tmp_path):
    """A params file the port writes loads with the JAX load_params to the
    same arrays (and is byte-identical to flax's encoding of them), and a
    JAX-written file loads in the port: exact."""
    model = SpotNet(**STEP_SPOT)
    _seeded_weights(model, 3)
    path = str(tmp_path / "port_0.msgpack")
    ckpt.save_params(path, model)
    template = _jax_template(JaxSpotNet, STEP_SPOT,
                             (jnp.zeros((1, 7, 256)), jnp.ones((1, 2))))
    loaded = _flat(jax_ckpt.load_params(path, template)["params"])
    state = model.state_dict()
    assert set(loaded) == set(state)
    for k, v in loaded.items():
        np.testing.assert_array_equal(v, state[k].numpy())

    jax_path = str(tmp_path / "jax_0.msgpack")
    jax_ckpt.save_params(jax_path, template)
    back = ckpt.load_params(jax_path)
    want = _flat(template["params"])
    assert set(back) == set(want)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), want[k])
    fresh = SpotNet(**STEP_SPOT)
    fresh.load_state_dict(back, strict=True)


def test_sidecar_round_trip_across_packages(tmp_path):
    """The port's state sidecar reads in the JAX package as the JAX one
    does, best-checkpoint selection agrees, and the optimizer state goes to
    a file the JAX package never opens."""
    sched = {"best_loss": -1.25, "bad_epochs": 1}
    kwargs = dict(train_losses=[0.5, 0.4, 0.3], val_losses=[0.9, 0.7, 0.8],
                  epoch=6, lr=1.5e-4, val_epochs=[4, 5, 6])
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters())
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    ckpt.save_state(str(port_dir / "state.msgpack"), opt, sched, **kwargs)
    jax_ckpt.save_state(str(jax_dir / "state.msgpack"), None, sched, **kwargs)
    assert not (port_dir / "state.msgpack").exists()
    assert (port_dir / ckpt.OPTIMIZER_FILE).exists()
    port_summary = jax_ckpt.load_state_summary(str(port_dir / "state.msgpack"))
    jax_summary = ckpt.load_state_summary(str(jax_dir / "state.msgpack"))
    assert port_summary == jax_summary
    assert ckpt.summary_val_epochs(jax_summary) == \
        jax_ckpt.summary_val_epochs(port_summary) == [4, 5, 6]
    pairs = [(4, "a_4"), (5, "a_5"), (6, "a_6")]
    assert best_checkpoint_path(port_summary, pairs) == \
        jax_best_checkpoint_path(port_summary, pairs) == "a_5"
    saved = ckpt.load_optimizer_state(str(port_dir / "state.msgpack"))
    assert saved["epoch"] == 6 and saved["lr"] == 1.5e-4
    opt2 = torch.optim.Adam(model.parameters())
    opt2.load_state_dict(saved["optimizer"])
    for a, b in zip(opt.state.values(), opt2.state.values()):
        torch.testing.assert_close(a["exp_avg"], b["exp_avg"], rtol=0, atol=0)


def test_device_perturb_distribution():
    """train._device_perturb, in the manner of the JAX package's test:
    deterministic per (seed, step), adds noise whose levels are bounded by
    the max variances (unit-variance pink * <=5e-3 + unit white * <=1e-3,
    so the noise std is well below 1e-2), different steps draw different
    noise, and the pink component has the 1/f spectrum of the host
    generator."""
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.standard_normal((2, 7, 4096)).astype(np.float32)
                            * 0.05)
    out1 = _device_perturb(perturb_generator(0, 5, "cpu"), data, 1e-3, 5e-3)
    out2 = _device_perturb(perturb_generator(0, 5, "cpu"), data, 1e-3, 5e-3)
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)
    noise = (out1 - data).numpy()
    assert 0 < noise.std() < 1e-2
    out3 = _device_perturb(perturb_generator(0, 6, "cpu"), data, 1e-3, 5e-3)
    assert (out3 - out1).abs().max() > 0

    from acousticswarms_speech_tpu_torch.utils.pink_noise import (
        powerlaw_psd_gaussian,
        powerlaw_psd_gaussian_torch,
    )

    gen = torch.Generator().manual_seed(1)
    dev = powerlaw_psd_gaussian_torch(1, (256, 4096), gen).numpy()
    host = powerlaw_psd_gaussian(1, (256, 4096), random_state=1)
    # about unit variance, and the same mean power per octave band (10%
    # over 256 draws; the lowest bins dominate and vary most)
    assert abs(dev.std() - 1) < 0.1 and abs(host.std() - 1) < 0.1
    pd = (np.abs(np.fft.rfft(dev, axis=-1)) ** 2).mean(axis=0)
    ph = (np.abs(np.fft.rfft(host, axis=-1)) ** 2).mean(axis=0)
    for lo in (8, 32, 128, 512):
        ratio = pd[lo:2 * lo].mean() / ph[lo:2 * lo].mean()
        assert 0.9 < ratio < 1.1, (lo, ratio)


@pytest.mark.parametrize("net", ["spot", "sep"])
def test_init_distribution_matches_jax(net):
    """A fresh model of the port is drawn from the JAX package's init
    distribution and rescale: every parameter tensor of at least 256
    elements has the JAX init's std within 10% and its max |value| within
    the same bound; zero/one inits are exact."""
    if net == "spot":
        model, jax_model, small = SpotNet(**STEP_SPOT), JaxSpotNet, STEP_SPOT
        inputs = (jnp.zeros((1, 7, 256)), jnp.ones((1, 2)))
    else:
        model, jax_model, small = SepNet(**STEP_SEP), JaxSepNet, STEP_SEP
        inputs = (jnp.zeros((1, 7 * 5, 256)), jnp.asarray([1]))
    init_model(model, seed=0)
    want = _flat(_jax_template(jax_model, small, inputs)["params"])
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    assert set(want) == set(state)
    assert param_count(model) == sum(v.size for v in want.values())
    for k, w in want.items():
        g = state[k]
        if np.all(w == w.flat[0]) and w.size > 1:
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif w.size >= 256:
            assert abs(g.std() / w.std() - 1) < 0.1, (k, g.std(), w.std())
            assert np.abs(g).max() <= np.abs(w).max() * 1.1, k


def _fixed_batch(net):
    """A batch of two dev-scene items from the test split (no host noise;
    the separation items are center crops), cut to the middle 16384
    samples (0.34 s) to keep the CPU step short."""
    if net == "spot":
        ds = datasets.LocalizationDataset(dataset_type="test", input_dir=DEV,
                                          compression_prob=0)
    else:
        ds = datasets.SeparationDataset(dataset_type="test", input_dir=DEV,
                                        compression_prob=0, n_speakers=5,
                                        crop_seconds=0.5)
    items = _items(ds, 2, 11)
    data, gt, cond = (np.stack(c) if isinstance(c[0], np.ndarray)
                      else np.asarray(c) for c in zip(*items))
    start = (data.shape[-1] - 16384) // 2
    data, gt = data[..., start:start + 16384], gt[..., start:start + 16384]
    assert (data.std(axis=(1, 2)) > 0).all()
    return data, gt, cond


@pytest.mark.parametrize("net", ["spot", "sep"])
def test_one_train_step_matches_jax(net):
    """One step of each network at narrow width through both packages'
    make_step_fns, perturbation off, fixed batch: the loss at rel 1e-5, the
    clipped gradients within 1e-4 of the largest gradient entry (float32
    sums in other orders through the backward pass; the JAX package's are
    read back from Adam's first moment, mu = 0.1 g after one step), and the
    updated parameters.

    Adam's first step moves each coordinate by lr * g / (|g| + 1e-8), about
    lr * sign(g): an update is either ~lr or, where |g| is near 1e-8, any
    value in (-lr, lr) that float differences in g can swing.  So the
    updated parameters must agree within 1e-3 * lr where |g| > 1e-6 (the
    relative error in g there moves the step by far less), and within
    2 * lr everywhere (a sign flip of a vanishing gradient)."""
    lr, clip = 1e-3, 1.0
    if net == "spot":
        name, loss_name = "SpeakerLocalization", "l1"
        model, jax_model = SpotNet(**STEP_SPOT), JaxSpotNet(**STEP_SPOT)
    else:
        name, loss_name = "SpeakerSeparation", "sisdr"
        model, jax_model = SepNet(**STEP_SEP), JaxSepNet(**STEP_SEP)
    params = _seeded_weights(model, 5)
    batch = _fixed_batch(net)

    _, train_step, _ = make_step_fns(model, name, loss_name, clip, lr)
    loss = float(train_step(to_device(batch, torch.device("cpu"))))
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    new = {k: p.detach().numpy() for k, p in model.named_parameters()}

    j_opt, j_step, _ = jax_make_step_fns(jax_model, name, loss_name, clip)
    opt_state = j_opt.init(params)
    opt_state.hyperparams["learning_rate"] = jnp.asarray(lr)
    j_params, opt_state, j_loss = j_step(params, opt_state,
                                         tuple(jnp.asarray(b) for b in batch))
    j_loss = float(j_loss)
    assert np.isfinite(j_loss) and abs(loss - j_loss) <= 1e-5 * abs(j_loss), \
        (loss, j_loss)
    mu = opt_state.inner_state[0].mu["params"]
    want_grads = {k: v / 0.1 for k, v in _flat(mu).items()}
    gmax = max(np.abs(g).max() for g in want_grads.values())
    assert np.isfinite(gmax) and gmax > 0
    for k, g in want_grads.items():
        np.testing.assert_allclose(grads[k], g, rtol=0, atol=1e-4 * gmax,
                                   err_msg=k)
    for k, w in _flat(j_params["params"]).items():
        diff = np.abs(new[k] - w)
        assert diff.max() <= 2 * lr, k
        big = np.abs(want_grads[k]) > 1e-6
        assert (diff[big] <= 1e-3 * lr).all(), (k, diff[big].max())


def _tiny_experiment(root, scenes):
    """An experiment dir for the narrow SepNet over a copy of `scenes`, on
    0.1 s crops (remat on)."""
    data = os.path.join(root, "data")
    for s in scenes:
        shutil.copytree(os.path.join(DEV, s), os.path.join(data, s))
    exp = os.path.join(root, "tiny_sep")
    os.makedirs(exp)
    data_params = {"input_dir": data, "n_mics": 7, "n_speakers": 5,
                   "compression_prob": 0, "crop_seconds": 0.1}
    desc = {
        "model_name": "SpeakerSeparation", "sr": 48000,
        "model_params": dict(STEP_SEP, n_mics=7, remat=True),
        "lr_sched_params": {"lr_min": 1e-8, "factor": 0.5, "patience": 3,
                            "dont_halve_until_epoch": 1},
        "training_params": {"gradient_clip": 1, "epochs": 1, "lr": 1e-3,
                            "batch_size": 1, "loss": "sisdr"},
        "train_set_params": data_params,
        "test_set_params": data_params,
    }
    with open(os.path.join(exp, "description.json"), "w") as f:
        json.dump(desc, f)
    return exp, desc


def test_train_writes_resumes_and_loads_best(tmp_path):
    """train() on the CPU, two steps per epoch over two dev scenes with the
    narrow SepNet (remat on): it writes a checkpoint and the sidecar, a
    second call resumes from it for one more epoch, and
    load_model_from_exp(mode="best") returns the checkpoint of the lower
    validation loss, which the JAX package's loader also reads."""
    exp, desc = _tiny_experiment(str(tmp_path), ["00000", "00001"])
    steps = []
    tl, vl = train(exp, max_steps_per_epoch=2, device="cpu",
                   on_step=lambda m, info: steps.append(info))
    assert len(tl) == len(vl) == 1 and np.isfinite(tl + vl).all()
    assert [s["step"] for s in steps] == [0, 1]
    ck = os.path.join(exp, "checkpoints")
    assert os.path.exists(os.path.join(ck, "tiny_sep_0.msgpack"))
    assert os.path.exists(os.path.join(ck, ckpt.OPTIMIZER_FILE))

    desc["training_params"]["epochs"] = 2
    with open(os.path.join(exp, "description.json"), "w") as f:
        json.dump(desc, f)
    tl, vl = train(exp, max_steps_per_epoch=2, device="cpu")
    assert len(tl) == len(vl) == 2
    summary = ckpt.load_state_summary(os.path.join(ck, "state.msgpack"))
    assert summary["val_epochs"] == [0, 1] and summary["epoch"] == 1

    best = int(np.argmin(vl))
    model = load_model_from_exp(exp, mode="best", device="cpu")
    want = ckpt.load_params(os.path.join(ck, f"tiny_sep_{best}.msgpack"))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)

    from acousticswarms_speech_tpu.training.experiment import \
        load_model_from_exp as jax_load_model_from_exp

    _, jax_params = jax_load_model_from_exp(exp, mode="best")
    for k, v in _flat(jax_params["params"]).items():
        np.testing.assert_array_equal(v, want[k].numpy())


def test_train_cli_needs_a_card_without_jax(tmp_path):
    """`python -m acousticswarms_speech_tpu_torch.training.train` defaults
    to cuda: without a card it raises before training, and the process
    never imports jax, flax, optax, msgpack or the JAX package."""
    exp, _ = _tiny_experiment(str(tmp_path), ["00000"])
    code = (
        "import sys, runpy\n"
        f"sys.argv = ['train', {exp!r}, '--max_steps_per_epoch', '1']\n"
        "try:\n"
        "    runpy.run_module('acousticswarms_speech_tpu_torch.training.train',"
        " run_name='__main__')\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'flax', 'optax', 'msgpack', 'acousticswarms_speech_tpu')]\n"
        "print('bad:', bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "raised: no CUDA device" in proc.stdout, proc.stdout
    assert "bad: []" in proc.stdout, proc.stdout
    assert not os.path.exists(os.path.join(exp, "checkpoints"))


def test_train_timing_prints_like_jax(tmp_path, monkeypatch, capsys):
    """ACOUSTIC_TRAIN_TIMING=1: a two-step epoch of each package's train()
    (the narrow SepNet of the test above, two dev scenes, a print every
    step) prints one line per step with the seconds spent fetching,
    stepping and syncing since the last print, in the same format; without
    the knob the port prints the plain line."""
    import re

    from acousticswarms_speech_tpu.training.train import train as jax_train

    line = re.compile(r"Train Epoch 0 \[(\d+)\] Loss: -?\d+\.\d{6}"
                      r"(  \(fetch \d+\.\ds step \d+\.\ds sync \d+\.\ds\))?$")

    def step_lines(fn, root, timing):
        monkeypatch.setenv("ACOUSTIC_TRAIN_TIMING", "1" if timing else "0")
        exp, _ = _tiny_experiment(str(tmp_path / root), ["00000", "00001"])
        capsys.readouterr()
        fn(exp)
        out = capsys.readouterr().out.splitlines()
        return [(m[1], m[2] is not None) for m in (
            line.match(ln) for ln in out if ln.startswith("Train Epoch"))]

    want = step_lines(lambda e: jax_train(e, print_interval=1,
                                          max_steps_per_epoch=2), "jax", True)
    got = step_lines(lambda e: train(e, print_interval=1, max_steps_per_epoch=2,
                                     device="cpu"), "port", True)
    assert got == want == [("0", True), ("1", True)]
    plain = step_lines(lambda e: train(e, print_interval=1,
                                       max_steps_per_epoch=2, device="cpu"),
                       "plain", False)
    assert plain == [("0", False), ("1", False)]
