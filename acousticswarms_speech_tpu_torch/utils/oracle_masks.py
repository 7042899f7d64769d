"""Oracle STFT mask baselines: IRM and IBM (JAX package:
utils/oracle_masks.py, copied as host SciPy).

nfft=2048 STFT oracle baselines, used as separation upper bounds.  They
run on ground-truth WAVs on the host.
"""
from __future__ import annotations

import numpy as np
from scipy import signal as sps

N_FFT = 2048


def do_irm(mix: np.ndarray, sources: np.ndarray, fs: int = 48000,
           power: float = 1.0) -> np.ndarray:
    """Ideal Ratio Mask separation.

    mix: (T,) mixture at the reference mic; sources: (S, T) ground-truth
    images at the same mic.  Returns (S, T) masked reconstructions.
    """
    f, t, Zmix = sps.stft(mix, fs=fs, nperseg=N_FFT)
    mags = []
    specs = []
    for s in sources:
        _, _, Z = sps.stft(s, fs=fs, nperseg=N_FFT)
        specs.append(Z)
        mags.append(np.abs(Z) ** power)
    mags = np.stack(mags)
    denom = np.sum(mags, axis=0) + 1e-12
    outs = []
    for i in range(len(sources)):
        mask = mags[i] / denom
        _, x = sps.istft(Zmix * mask, fs=fs, nperseg=N_FFT)
        outs.append(x[: mix.shape[-1]])
    return np.stack(outs)


def do_ibm(mix: np.ndarray, sources: np.ndarray, fs: int = 48000) -> np.ndarray:
    """Ideal Binary Mask separation: each TF bin goes to the dominant source."""
    _, _, Zmix = sps.stft(mix, fs=fs, nperseg=N_FFT)
    mags = []
    for s in sources:
        _, _, Z = sps.stft(s, fs=fs, nperseg=N_FFT)
        mags.append(np.abs(Z))
    mags = np.stack(mags)
    winner = np.argmax(mags, axis=0)
    outs = []
    for i in range(len(sources)):
        mask = (winner == i).astype(np.float64)
        _, x = sps.istft(Zmix * mask, fs=fs, nperseg=N_FFT)
        outs.append(x[: mix.shape[-1]])
    return np.stack(outs)
