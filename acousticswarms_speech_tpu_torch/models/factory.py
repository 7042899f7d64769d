"""Model construction, init-time weight rescaling and parameter counts
(JAX: models/factory.py).

`init_model` draws a fresh network from the JAX package's init
distribution, then applies `rescale_params`, the reference's
`rescale_module` (reference sep/training/SpeakerLocalization/network.py:
10-26): every Conv1d / ConvTranspose1d weight (and its bias) is divided by
sqrt(std(weight) / reference) right after the random init.

The JAX package's initializers, by parameter (models/modules.py and
models/conformer.py there):
- a weight of two or more dims (Conv1d (O, I/g, K), ConvTranspose1d
  (I, O, K), Linear (O, I), attention in/positional projections) is
  U(-sqrt(3 / fan_in), sqrt(3 / fan_in)) with fan_in = prod(shape[1:]);
- its bias is U(-1 / sqrt(fan_in), 1 / sqrt(fan_in));
- attention input-projection biases and the relative-position biases u, v
  are zero; norm weights are one and norm biases zero.
"""
from __future__ import annotations

import math

import torch

from .weights import MODEL_REGISTRY, create_model  # noqa: F401  (re-exported)

_ZERO_INIT = ("in_proj_bias", "pos_bias_u", "pos_bias_v")


@torch.no_grad()
def rescale_params(model: torch.nn.Module, reference: float = 0.1) -> None:
    """Divide every 3-D `weight` (and its sibling `bias`) by
    sqrt(std(weight) / reference), in place."""
    params = dict(model.named_parameters())
    for name, w in params.items():
        prefix, _, leaf = name.rpartition(".")
        if leaf != "weight" or w.dim() != 3:
            continue
        scale = torch.sqrt(w.std(correction=0) / reference)
        w.div_(scale)
        bias = params.get(f"{prefix}.bias" if prefix else "bias")
        if bias is not None:
            bias.div_(scale)


@torch.no_grad()
def init_model(model: torch.nn.Module, seed: int = 0,
               reference: float | None = 0.1) -> torch.nn.Module:
    """Draw fresh parameters from the JAX package's init distribution (see
    the module docstring) with a `torch.Generator` seeded by `seed`, then
    rescale them like the reference.  In place; returns `model`."""
    gen = torch.Generator().manual_seed(seed)
    params = dict(model.named_parameters())
    for name, p in params.items():
        prefix, _, leaf = name.rpartition(".")
        weight = params.get(f"{prefix}.weight" if prefix else "weight")
        if leaf in _ZERO_INIT:
            val = torch.zeros(p.shape)
        elif p.dim() == 1 and (weight is None or weight.dim() == 1):
            # norm scale and shift
            val = torch.ones(p.shape) if leaf == "weight" else torch.zeros(p.shape)
        elif p.dim() >= 2:
            bound = math.sqrt(3.0 / math.prod(p.shape[1:]))
            val = torch.empty(p.shape).uniform_(-bound, bound, generator=gen)
        else:  # the bias of a conv or linear layer
            bound = 1.0 / math.sqrt(math.prod(weight.shape[1:]))
            val = torch.empty(p.shape).uniform_(-bound, bound, generator=gen)
        p.copy_(val)
    if reference is not None:
        rescale_params(model, reference)
    return model


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
