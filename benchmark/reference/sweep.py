# Frozen copy of acousticswarms_speech_tpu_torch/search/spotform.py and
# ops/shift.py at commit 300ffdc, part of the benchmark's plain reference: it
# imports nothing of the port.  The roll is the plain `torch.gather` version
# (no CUDA kernel), sweeps run synchronously, in float32 only, on one device.
"""Spotforming sweeps and separation inference, plain PyTorch.

A sweep rolls the mixture to every candidate's TDoA, runs SpotNet over the
rolled block in chunks of `chunk` candidates, and keeps per candidate the
centred output, its total power and its largest windowed RMS; the fine
sweep also keeps the pairwise SI-SDR matrix of the outputs.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import normalize_input, unnormalize_input
from .power import candidate_powers
from .similarity import sisdr_matrix

# Candidates per SpotNet forward, as the port's default.
MAP_CHUNK = 64


def to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def roll_channels_batch(mix: torch.Tensor,
                        shifts: torch.Tensor) -> torch.Tensor:
    """mix (M, T), shifts (B, M) int -> (B, M, T) with
    out[b, m, i] = mix[m, (i - shifts[b, m]) mod T]."""
    M, T = mix.shape
    B = shifts.shape[0]
    t = torch.arange(T, device=mix.device)
    src = torch.remainder(t[None, None, :] - shifts[:, :, None].long(), T)
    return torch.gather(mix[None].expand(B, M, T), 2, src)


def roll_zero_fill_batch(mix: torch.Tensor,
                         shifts: torch.Tensor) -> torch.Tensor:
    """(M, T), (S, M) -> (S, M, T): the roll with wrapped samples zeroed
    (a positive shift zeros the head, a negative one the tail)."""
    T = mix.shape[1]
    rolled = roll_channels_batch(mix, shifts)
    t = torch.arange(T, device=mix.device)[None, None, :]
    s = shifts[:, :, None].long()
    valid = torch.where(s > 0, t >= s, t < T + s)
    return torch.where(valid, rolled, torch.zeros((), dtype=rolled.dtype,
                                                  device=rolled.device))


def _quantize_rows(x: torch.Tensor):
    """Per-row int16 quantization: (int16 rows, float32 scales)."""
    scale = torch.clamp(torch.amax(torch.abs(x), dim=1), min=1e-12) / 32767.0
    q = torch.clamp(torch.round(x / scale[:, None]), -32768, 32767)
    return q.to(torch.int16), scale


def _shift_matrix(patch_list, num_mic: int) -> np.ndarray:
    shifts = np.zeros((len(patch_list), num_mic), dtype=np.int32)
    for k, p in enumerate(patch_list):
        off = p.sample_offset if hasattr(p, "sample_offset") else p
        shifts[k, 1:] = -np.round(np.asarray(off)).astype(np.int32)
    return shifts


class SweepResult:
    """A finished sweep: powers and the SI-SDR matrix on the host, the
    centred outputs on the device."""

    def __init__(self, out: torch.Tensor, totals: torch.Tensor,
                 wins: torch.Tensor, sim: torch.Tensor | None):
        self._out = out
        self.n = out.shape[0]
        self.powers = to_numpy(totals)
        self.powers_win = to_numpy(wins)
        self.sisdr_mat = None if sim is None else to_numpy(sim)

    def is_ready(self) -> bool:
        return True

    def gather(self, indices) -> dict[int, np.ndarray]:
        """Selected centred outputs through int16 with a per-row scale, as
        the port copies them to the host."""
        indices = [int(i) for i in indices]
        if not indices:
            return {}
        rows = self._out[torch.as_tensor(indices, device=self._out.device)]
        q, scales = _quantize_rows(rows)
        sel = to_numpy(q).astype(np.float32) * to_numpy(scales)[:, None]
        return {i: sel[k] for k, i in enumerate(indices)}


class SpotformExecutor:
    """SpotNet over the candidates of a sweep; `calls` counts them."""

    def __init__(self, model: torch.nn.Module, device="cuda",
                 chunk: int = MAP_CHUNK):
        self.device = torch.device(device)
        self.chunk = chunk
        self.model = model.to(self.device).eval()
        self.calls = 0

    def _chunk_fn(self, rolled, onehot):
        normed, means, stds = normalize_input(rolled)
        w = onehot[None, :].expand(rolled.shape[0], 2)
        out = self.model(normed, w)
        return candidate_powers(unnormalize_input(out, means, stds)[:, 0])

    @torch.no_grad()
    def sweep(self, input_channels, patch_list, strict: int = 0,
              with_similarity: bool = False) -> SweepResult:
        mix = torch.as_tensor(input_channels, dtype=torch.float32,
                              device=self.device).contiguous()
        shifts = torch.as_tensor(_shift_matrix(patch_list, mix.shape[0]),
                                 device=self.device)
        onehot = torch.tensor([1.0, 0.0] if strict == 1 else [0.0, 1.0],
                              device=self.device)
        rolled = roll_channels_batch(mix, shifts)
        parts = [self._chunk_fn(rolled[i : i + self.chunk], onehot)
                 for i in range(0, len(shifts), self.chunk)]
        out, totals, wins = (torch.cat([p[k] for p in parts])
                             for k in range(3))
        self.calls += len(patch_list)
        sim = sisdr_matrix(out) if with_similarity else None
        return SweepResult(out, totals, wins, sim)


class SeparationInference:
    """One SepNet forward over all speakers."""

    def __init__(self, model: torch.nn.Module, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def infer(self, input_channels, sample_list) -> np.ndarray:
        """input_channels: (M, T); sample_list: patches or (M-1,) offset
        vectors.  Returns (len(sample_list), T)."""
        S = len(sample_list)
        mix = torch.as_tensor(input_channels, dtype=torch.float32,
                              device=self.device).contiguous()
        M, T = mix.shape
        shifts = torch.as_tensor(_shift_matrix(sample_list, M),
                                 device=self.device)
        normed, means, stds = normalize_input(
            roll_zero_fill_batch(mix, shifts).reshape(1, S * M, T))
        out = self.model(normed, torch.tensor([S], device=self.device))
        return to_numpy((out * stds + means)[0, :S])
