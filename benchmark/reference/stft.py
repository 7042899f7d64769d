# Frozen copy of acousticswarms_speech_tpu_torch/ops/stft.py at commit 300ffdc,
# part of the benchmark's plain reference: it imports nothing of the port.
"""Band-limited framed STFT for SRP-PHAT (JAX: ops/stft.py).

Rectangular window, hop = nfft // 4 and (T - nfft) // hop + 1 full frames,
as pyroomacoustics' `stft.analysis` that the reference's SRP stage uses.
The JAX package computes the selected bins as a matmul DFT because its TPU
runtime had no FFT; here `torch.fft.rfft` computes them.
"""
from __future__ import annotations

import numpy as np
import torch


def num_frames(T: int, nfft: int, hop: int) -> int:
    return (T - nfft) // hop + 1


def stft_bins(x: torch.Tensor, bins: torch.Tensor, nfft: int, hop: int):
    """x: (..., T) real -> (re, im), each (..., n_frames, K), where
    re + 1j * im = rfft(frame)[bins]."""
    frames = x.unfold(-1, nfft, hop)  # (..., n_frames, nfft)
    spec = torch.fft.rfft(frames, n=nfft, dim=-1)[..., bins]
    return spec.real, spec.imag


def stft_windowed_bins(signal: torch.Tensor, bins: torch.Tensor, window: int,
                       step: int, nfft: int, hop: int):
    """STFT of the analysis windows [j*step, j*step + window) for all j with
    j*step + window <= T and j < T//step - 1.

    signal: (M, T).  Returns (re, im): (n_windows, M, frames_per_window, K).
    """
    M, T = signal.shape
    frame_number = T // step - 1
    n_windows = sum(
        1 for j in range(max(frame_number, 0)) if j * step + window <= T)
    starts = np.arange(n_windows) * step
    idx = torch.as_tensor(starts[:, None] + np.arange(window)[None, :],
                          device=signal.device)
    wins = signal[:, idx].transpose(0, 1)  # (W, M, window)
    return stft_bins(wins, bins, nfft, hop)
