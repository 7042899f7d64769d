"""Work that a call needs, from its shapes: the networks' floating-point
operations and the roll kernel's bytes, and the card's published peaks.

The operations are counted by `torch.utils.flop_counter.FlopCounterMode`
over the reference networks on the meta device (no data, no arithmetic):
the matrix products and convolutions that the call's shapes need, two
operations to a multiply-add, whatever implements them.  SpotNet's count
is linear in the candidates, so it is counted at one candidate of each
length; SepNet's at each speaker count and length it runs at.
"""
from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference.weights import create_model

# NVIDIA's data sheet of the H100 SXM, dense, at its 700 W limit.
PEAKS = {
    "H100": {"float32_flops": 67e12, "bfloat16_flops": 989e12,
             "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> dict | None:
    """The published peaks of the card named `device_name`, or None."""
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    return None


@functools.lru_cache(maxsize=None)
def _flops(model_name: str, params_json: str, shape: tuple,
           extra: tuple) -> int:
    params = json.loads(params_json)
    with torch.device("meta"):
        model = create_model(model_name, params).eval()
        x = torch.zeros(shape)
        arg = torch.zeros(extra) if model_name == "SpeakerLocalization" \
            else torch.tensor(extra)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x, arg)
    return int(counter.get_total_flops())


def spotnet_flops(spec: dict, n: int, M: int, T: int) -> int:
    """SpotNet on `n` candidates of (M, T)."""
    return n * _flops(spec["model_name"],
                      json.dumps(spec["model_params"], sort_keys=True),
                      (1, M, T), (1, 2))


def sepnet_flops(spec: dict, S: int, M: int, T: int) -> int:
    """SepNet on one mixture of (M, T) at `S` speakers."""
    return _flops(spec["model_name"],
                  json.dumps(spec["model_params"], sort_keys=True),
                  (1, S * M, T), (S,))


def roll_bytes(B: int, M: int, T: int) -> int:
    """The roll kernel's launch of B candidates over an (M, T) float32
    mixture: the mixture and the int32 shifts read once, the (B, M, T)
    float32 output written once."""
    return 4 * (M * T + B * M) + 4 * B * M * T
