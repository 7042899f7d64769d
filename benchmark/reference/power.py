# Frozen copy of acousticswarms_speech_tpu_torch/ops/power.py at commit 300ffdc,
# part of the benchmark's plain reference: it imports nothing of the port.
"""Candidate power metrics of the sweep (JAX: ops/power.py).

Per spotformed candidate: the mean-subtracted total power, and the maximum
over i of the RMS of x[i : i + window] with zero padding past the end.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F


def windowed_rms_max(x: torch.Tensor, window: int = 12000) -> torch.Tensor:
    """x: (B, T) mean-subtracted -> (B,) max sliding-window RMS."""
    T = x.shape[1]
    cs = torch.cumsum(F.pad(x * x, (0, window)), dim=1)
    sums = cs[:, window - 1 : window - 1 + T] - F.pad(cs[:, :T], (1, 0))[:, :T]
    return torch.sqrt(torch.amax(sums / window, dim=1))


def candidate_powers(x: torch.Tensor):
    """x: (B, T) raw spotformed outputs -> (centered, total power (B,),
    windowed RMS max (B,))."""
    centered = x - x.mean(dim=1, keepdim=True)
    total = torch.sum(centered * centered, dim=1)
    return centered, total, windowed_rms_max(centered)
