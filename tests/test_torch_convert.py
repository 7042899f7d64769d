"""The port's converter of reference torch checkpoints (models/convert.py)
against the JAX package's, on the CPU: complete reference-named state dicts
of narrow SpotNet and SepNet networks, built with the JAX tests'
`_to_torch_names` helpers, convert to equal trees in both packages and to
networks whose forwards agree; a `.pt` checkpoint loads through
load_model_from_exp and through a `pretrain_path`; a key the converter
cannot place raises."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acousticswarms_speech_tpu.models import SepNet as JaxSepNet
from acousticswarms_speech_tpu.models import SpotNet as JaxSpotNet
from acousticswarms_speech_tpu.models import convert as jax_convert
from acousticswarms_speech_tpu_torch.models import SepNet, SpotNet
from acousticswarms_speech_tpu_torch.models import convert
from acousticswarms_speech_tpu_torch.models.weights import from_jax_params
from acousticswarms_speech_tpu_torch.training import train as train_mod
from acousticswarms_speech_tpu_torch.training.experiment import \
    load_model_from_exp
from test_convert_sep import CFG as SEP_CFG
from test_convert_sep import _to_torch_names as sep_torch_names
from test_torch_checkpoint_load import CFG as LOC_CFG
from test_torch_checkpoint_load import _to_torch_names as loc_torch_names
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from test_torch_training import _tiny_experiment

# The tolerance of tests/test_torch_models.py
RTOL, ATOL = 2e-4, 2e-5

NETS = {
    "SpeakerLocalization": (JaxSpotNet, SpotNet, LOC_CFG, loc_torch_names),
    "SpeakerSeparation": (JaxSepNet, SepNet, SEP_CFG, sep_torch_names),
}


def _inputs(model_name, seed=0):
    rng = np.random.default_rng(seed)
    if model_name == "SpeakerLocalization":
        x = rng.normal(size=(2, 4, 128)).astype(np.float32)
        return x, np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    x = rng.normal(size=(1, 8, 128)).astype(np.float32)
    return x, np.array([2])


def _source(model_name, seed=7):
    """(flax module, its variables, the reference-named numpy state dict)."""
    jax_cls, _, cfg, names = NETS[model_name]
    cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}
    model = jax_cls(**cfg)
    x, aux = _inputs(model_name)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                    jnp.asarray(x[:1]), jnp.asarray(aux[:1]))
    sd = {k: np.asarray(v) for k, v in names(variables).items()}
    return model, variables, sd


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _forward(model, x, aux):
    with torch.no_grad():
        return model(torch.from_numpy(x), torch.from_numpy(aux)).numpy()


def _exp(root, model_name, sd, name="exp"):
    """An experiment whose checkpoints/ holds only a reference `.pt`."""
    exp = os.path.join(root, name)
    os.makedirs(os.path.join(exp, "checkpoints"))
    desc = {"model_name": model_name, "sr": 48000,
            "model_params": NETS[model_name][2], "lr_sched_params": {},
            "training_params": {}, "train_set_params": {},
            "test_set_params": {}}
    with open(os.path.join(exp, "description.json"), "w") as f:
        json.dump(desc, f)
    torch.save({k: torch.tensor(v) for k, v in sd.items()},
               os.path.join(exp, "checkpoints", f"{name}_0.pt"))
    return exp


@pytest.mark.parametrize("model_name", sorted(NETS))
def test_convert_state_dict_matches_jax(model_name):
    """Every converted tensor equal, nothing unmatched, and the converted
    port network's forward agrees with the JAX network's."""
    model, variables, sd = _source(model_name)
    want, want_unmatched = jax_convert.convert_state_dict(sd, model_name)
    got, unmatched = convert.convert_state_dict(sd, model_name)
    assert unmatched == want_unmatched == []
    want_flat, got_flat = _flat(want["params"]), _flat(got["params"])
    assert sorted(got_flat) == sorted(want_flat)
    for k, v in want_flat.items():
        np.testing.assert_array_equal(got_flat[k], v)

    _, port_cls, cfg, _ = NETS[model_name]
    port = port_cls(**cfg).eval()
    convert.load_converted(port, sd, model_name)
    # the one parameter without a reference counterpart (the Conformer's
    # qkv bias) keeps the port's zero init, as the JAX merge keeps its
    # template's zeros
    for k, v in from_jax_params(variables).items():
        torch.testing.assert_close(port.state_dict()[k], v, rtol=0, atol=0)
    merged = jax.tree_util.tree_map(jnp.asarray, variables)
    x, aux = _inputs(model_name, seed=1)
    want_y = np.asarray(jax.jit(model.apply)(merged, jnp.asarray(x),
                                             jnp.asarray(aux)))
    np.testing.assert_allclose(_forward(port, x, aux), want_y, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("model_name", sorted(NETS))
def test_load_model_from_exp_converts_pt(tmp_path, model_name):
    """A `.pt` in an experiment's checkpoints/ loads through the port's
    load_model_from_exp to the network it was made from (the JAX package's
    loader of such a file is tested in tests/test_torch_checkpoint_load.py)."""
    model, variables, sd = _source(model_name, seed=3)
    exp = _exp(str(tmp_path), model_name, sd)
    port = load_model_from_exp(exp, mode="best", device="cpu")
    x, aux = _inputs(model_name, seed=2)
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x),
                                           jnp.asarray(aux)))
    np.testing.assert_allclose(_forward(port, x, aux), want, rtol=RTOL,
                               atol=ATOL)


def test_extra_key_raises_unless_not_strict(tmp_path):
    _, variables, sd = _source("SpeakerLocalization")
    sd = dict(sd, **{"totally.bogus.key": np.zeros(3, np.float32)})
    exp = _exp(str(tmp_path), "SpeakerLocalization", sd)
    with pytest.raises(ValueError, match="unmatched"):
        load_model_from_exp(exp, mode="best", device="cpu")
    model = load_model_from_exp(exp, mode="best", device="cpu",
                                strict_convert=False)
    for k, v in from_jax_params(variables).items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)
    # a key a rule matches but the network does not have (a deeper encoder)
    sd = dict(sd)
    del sd["totally.bogus.key"]
    sd["encoder.module_list.9.conv1.weight"] = np.zeros((2, 2, 2), np.float32)
    with pytest.raises(ValueError, match="unmatched"):
        convert.load_converted(SpotNet(**LOC_CFG), sd, "SpeakerLocalization")


def test_pretrain_path_pt_warm_starts(tmp_path, monkeypatch):
    """train() with a reference `.pt` pretrain_path starts from its
    converted weights (read where the step functions are built, before any
    step)."""
    exp, desc = _tiny_experiment(str(tmp_path), ["00000"])
    cfg = dict(desc["model_params"])
    cfg.pop("remat")
    cfg["stride_list"] = tuple(cfg["stride_list"])
    jax_model = JaxSepNet(**cfg)
    variables = jax.jit(jax_model.init)(
        jax.random.PRNGKey(5), jnp.zeros((1, 7 * cfg["max_speakers"], 256)),
        jnp.asarray([2]))
    pt = os.path.join(str(tmp_path), "stage1.pt")
    torch.save({k: torch.tensor(np.asarray(v))
                for k, v in sep_torch_names(variables).items()}, pt)
    desc["training_params"]["pretrain_path"] = pt
    with open(os.path.join(exp, "description.json"), "w") as f:
        json.dump(desc, f)

    seen = {}

    class Stop(Exception):
        pass

    def capture(model, *args, **kwargs):
        seen.update({k: v.clone() for k, v in model.state_dict().items()})
        raise Stop

    monkeypatch.setattr(train_mod, "make_step_fns", capture)
    with pytest.raises(Stop):
        train_mod.train(exp, max_steps_per_epoch=1, device="cpu")
    want = from_jax_params(variables)
    assert sorted(seen) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(seen[k], v, rtol=0, atol=0)
