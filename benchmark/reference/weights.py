# Frozen copy of acousticswarms_speech_tpu_torch/models/weights.py
# (from_jax_params, create_model) at commit 300ffdc, part of the benchmark's
# plain reference: it imports nothing of the port.
"""The networks of a description, and release weights read from msgpack."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .localization import SpotNet
from .msgpack_reader import read_msgpack
from .separation import SepNet

MODEL_REGISTRY = {
    "SpeakerLocalization": SpotNet,
    "SpeakerSeparation": SepNet,
}


def create_model(model_name: str, model_params: Mapping) -> torch.nn.Module:
    """The network `model_name` names, built from a description's
    `model_params`."""
    params = dict(model_params)
    params.pop("device", None)
    return MODEL_REGISTRY[model_name](**params)


def from_jax_params(tree: Mapping) -> dict[str, torch.Tensor]:
    """A parameter tree of numpy arrays (with or without its top-level
    "params" key) -> a float32 state_dict of the networks here."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            name = f"{prefix}{key}"
            if isinstance(val, Mapping):
                walk(val, name + ".")
            else:
                out[name] = torch.from_numpy(np.array(val, dtype=np.float32))

    walk(tree, "")
    return out


def read_release(path: str) -> dict[str, torch.Tensor]:
    """The float32 state_dict of a release file (`params_f16.msgpack`)."""
    return from_jax_params(read_msgpack(path))
