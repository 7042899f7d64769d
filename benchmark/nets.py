"""The networks' weights, as the benchmark hands them to both sides.

A configuration's `weights` is either `release` (the float16 release files
of the checkout's experiment directories, which the port reads with its
own loader and the reference with its own msgpack reader) or `seeded`: weights drawn on the device from
the seed in the configuration's file, in one draw per network, from the
distribution of the port's `init_model` (models/factory.py at 300ffdc):
- a weight of two or more dims is U(-sqrt(3 / fan_in), sqrt(3 / fan_in))
  with fan_in = prod(shape[1:]), and a conv or linear bias
  U(-1 / sqrt(fan_in)) of its weight's fan_in;
- attention input-projection biases and the relative-position biases are
  zero, norm weights one and norm biases zero;
- then every 3-D weight and its bias is divided by
  sqrt(std(weight) / 0.1), as the reference repository's `rescale_module`.
"""
from __future__ import annotations

import math
import os

import torch

from .reference.weights import create_model, read_release

ZERO_INIT = ("in_proj_bias", "pos_bias_u", "pos_bias_v")
RESCALE_REFERENCE = 0.1


@torch.no_grad()
def seeded_state_dict(model_name: str, params: dict, seed: int,
                      device) -> dict[str, torch.Tensor]:
    """The float32 state_dict of a network drawn from `seed` on `device`."""
    with torch.device("meta"):
        shapes = {n: p.shape for n, p in
                  create_model(model_name, params).named_parameters()}
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    out, pos = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        u = draw[pos : pos + n].view(shape)
        pos += n
        prefix, _, leaf = name.rpartition(".")
        weight = shapes.get(f"{prefix}.weight" if prefix else "weight")
        if leaf in ZERO_INIT:
            out[name] = torch.zeros(shape, device=device)
        elif len(shape) == 1 and (weight is None or len(weight) == 1):
            out[name] = (torch.ones(shape, device=device) if leaf == "weight"
                         else torch.zeros(shape, device=device))
        elif len(shape) >= 2:
            out[name] = u * math.sqrt(3.0 / math.prod(shape[1:]))
        else:
            out[name] = u / math.sqrt(math.prod(weight[1:]))
    for name, w in list(out.items()):
        prefix, _, leaf = name.rpartition(".")
        if leaf != "weight" or w.dim() != 3:
            continue
        scale = torch.sqrt(w.std(correction=0) / RESCALE_REFERENCE)
        w.div_(scale)
        bias = f"{prefix}.bias" if prefix else "bias"
        if bias in out:
            out[bias].div_(scale)
    return out


def state_dicts(config: dict, root: str, device) -> dict:
    """{"spotnet": state_dict, "sepnet": state_dict}, float32 on `device`,
    made by the benchmark from the configuration alone."""
    weights = config["weights"]
    out = {}
    for net in ("spotnet", "sepnet"):
        spec = config[net]
        if weights["kind"] == "release":
            sd = read_release(os.path.join(root, weights[net], "release",
                                           "params_f16.msgpack"))
            out[net] = {k: v.to(device) for k, v in sd.items()}
        elif weights["kind"] == "seeded":
            out[net] = seeded_state_dict(spec["model_name"],
                                         spec["model_params"],
                                         weights["seeds"][net], device)
        else:
            raise ValueError(f"unknown weights {weights['kind']!r}")
    return out


def reference_networks(config: dict, root: str, device):
    """(SpotNet, SepNet) of the plain reference, float32, in eval mode."""
    sds = state_dicts(config, root, device)
    nets = []
    for net in ("spotnet", "sepnet"):
        spec = config[net]
        with torch.device("meta"):
            model = create_model(spec["model_name"], spec["model_params"])
        model.load_state_dict(sds[net], strict=True, assign=True)
        nets.append(model.eval())
    return tuple(nets)
