"""Spectral-gating denoiser.

Host NumPy, copied from the JAX package's `utils/denoise.py` for the PyTorch port
(the port imports nothing of that package).

Replacement for the reference's `noisereduce` wrapper
(reference sep/helpers/utils.py:66-67), implementing the classic
spectral-gating algorithm: estimate a per-frequency noise profile from a
noise-only clip, build a soft time-frequency gate where the signal exceeds
the noise floor by a margin, smooth the gate over time/frequency, and
resynthesize with overlap-add.
"""
from __future__ import annotations

import numpy as np
from scipy import signal as sps
from scipy.ndimage import uniform_filter


def denoise(signal: np.ndarray, noise_sample: np.ndarray, sr: int,
            stationary: bool = False, n_std_thresh: float = 1.5,
            prop_decrease: float = 1.0, n_fft: int = 2048,
            n_jobs: int = 1) -> np.ndarray:
    """Reduce noise in `signal` given a noise-only `noise_sample`.

    Matches the call signature of the reference helper; `n_jobs` is accepted
    for compatibility.
    """
    x = np.asarray(signal, dtype=np.float64)
    noise = np.asarray(noise_sample, dtype=np.float64)
    hop = n_fft // 4

    f, t, Z = sps.stft(x, fs=sr, nperseg=n_fft, noverlap=n_fft - hop)
    _, _, N = sps.stft(noise, fs=sr, nperseg=n_fft, noverlap=n_fft - hop)

    noise_mag = np.abs(N)
    noise_mean = noise_mag.mean(axis=1, keepdims=True)
    noise_std = noise_mag.std(axis=1, keepdims=True)
    thresh = noise_mean + n_std_thresh * noise_std

    mag = np.abs(Z)
    if stationary:
        gate = (mag > thresh).astype(np.float64)
    else:
        # soft gate: sigmoid of the dB margin over the noise threshold
        margin_db = 20.0 * (np.log10(mag + 1e-12) - np.log10(thresh + 1e-12))
        gate = 1.0 / (1.0 + np.exp(-margin_db))

    # smooth the gate to avoid musical noise
    gate = uniform_filter(gate, size=(3, 5))
    mask = 1.0 - prop_decrease * (1.0 - gate)

    _, y = sps.istft(Z * mask, fs=sr, nperseg=n_fft, noverlap=n_fft - hop)
    return y[: x.shape[-1]].astype(signal.dtype
                                   if hasattr(signal, "dtype") else np.float64)
