"""Batched per-channel time shifts (JAX: ops/shift.py).

`roll_channels_batch` is the sweep's data movement: it aligns the mixture to
every candidate's TDoA.  On a CUDA tensor it launches the hand-written
kernel (ops/roll_kernel.py, csrc/roll.cu); on a CPU tensor it runs the plain
`torch.gather` version, which is also the kernel's test oracle.
"""
from __future__ import annotations

import torch

from .roll_kernel import roll_channels_batch_cuda


def roll_channels_batch_plain(mix: torch.Tensor,
                              shifts: torch.Tensor) -> torch.Tensor:
    """mix (M, T), shifts (B, M) int -> (B, M, T) with
    out[b, m, i] = mix[m, (i - shifts[b, m]) mod T]."""
    M, T = mix.shape
    B = shifts.shape[0]
    t = torch.arange(T, device=mix.device)
    src = torch.remainder(t[None, None, :] - shifts[:, :, None].long(), T)
    return torch.gather(mix[None].expand(B, M, T), 2, src)


def roll_channels_batch(mix: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Circular per-channel roll of a candidate batch: (M, T), (B, M) ->
    (B, M, T).  Channel m of candidate b rolls by +shifts[b, m]."""
    if mix.device.type == "cpu":
        return roll_channels_batch_plain(mix, shifts)
    return roll_channels_batch_cuda(mix, shifts)


def roll_zero_fill_batch(mix: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """(M, T), (S, M) -> (S, M, T): the roll with wrapped samples zeroed
    (a positive shift zeros the head, a negative one the tail)."""
    T = mix.shape[1]
    rolled = roll_channels_batch(mix, shifts)
    t = torch.arange(T, device=mix.device)[None, None, :]
    s = shifts[:, :, None].long()
    valid = torch.where(s > 0, t >= s, t < T + s)
    return torch.where(valid, rolled, torch.zeros((), dtype=rolled.dtype,
                                                  device=rolled.device))
