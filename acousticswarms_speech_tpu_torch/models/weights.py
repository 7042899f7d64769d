"""Release weights for the port (JAX: training/experiment.py:96-106 and
models/convert.py).

The JAX parameter trees already use torch names and layouts, and the port's
module attributes follow the JAX tree, so the conversion is a flatten with
"." and a dtype cast.
"""
from __future__ import annotations

import json
import os
from typing import Mapping

import numpy as np
import torch

from ..device import resolve_device
from .localization import SpotNet
from .msgpack_reader import read_msgpack
from .separation import SepNet

MODEL_REGISTRY = {
    "SpeakerLocalization": SpotNet,
    "SpeakerSeparation": SepNet,
}


def from_jax_params(tree: Mapping, dtype=torch.float32) -> dict[str, torch.Tensor]:
    """A JAX parameter tree of numpy arrays (with or without its top-level
    "params" key) -> a state_dict of the port's modules."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            name = f"{prefix}{key}"
            if isinstance(val, Mapping):
                walk(val, name + ".")
            else:
                out[name] = torch.from_numpy(
                    np.array(val, dtype=np.float32)).to(dtype)

    walk(tree, "")
    return out


def create_model(model_name: str, model_params: Mapping) -> torch.nn.Module:
    """The network `model_name` names, built from a description's
    `model_params` (`remat` recomputes activations while training)."""
    params = dict(model_params)
    params.pop("device", None)  # a JAX-only knob
    return MODEL_REGISTRY[model_name](**params)


def load_release(exp_dir: str, device=None,
                 dtype: torch.dtype = torch.float32) -> torch.nn.Module:
    """Build the experiment's network from `description.json` and load its
    float16 release weights (`release/params_f16.msgpack`).  Returns the
    module in eval mode on `device` (default cuda)."""
    device = resolve_device(device)
    with open(os.path.join(exp_dir, "description.json")) as f:
        desc = json.load(f)
    model = create_model(desc["model_name"], desc["model_params"])
    tree = read_msgpack(os.path.join(exp_dir, "release", "params_f16.msgpack"))
    model.load_state_dict(from_jax_params(tree, dtype), strict=True)
    return model.to(device=device, dtype=dtype).eval()
