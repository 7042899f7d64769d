"""Wideband MUSIC pseudo-spectrum baseline (JAX package: dsp/music.py).

Per-bin covariance, Hermitian eigendecomposition, noise-subspace
projection against the grid's mode vectors, per-bin normalization,
averaged over bins and over non-overlapping analysis windows.

Torch in complex128 on the caller's device (cuda unless named): the K bins'
7x7 covariances go through one batched `torch.linalg.eigh`, and the
analysis windows are one batch instead of a loop.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import FS, SPEED_OF_SOUND
from ..device import resolve_device


def grid_mode_vectors(grids: np.ndarray, mic_pos: np.ndarray,
                      freq_bins: np.ndarray, fs: int, nfft: int,
                      c: float = SPEED_OF_SOUND, sign: float = -1.0,
                      device=None) -> torch.Tensor:
    """Steering vectors exp(sign * 1j*omega*d/c): (K, M, G) complex128 on
    `device`, mic z treated as 0 (the geometry convention of the SRP
    steering table).

    Note on `sign`: a source delayed by d/c appears in the STFT as
    exp(-1j*omega*d/c), so the physically matched steering vector uses
    sign=-1 (the default here).  The reference builds exp(+1j*...): for its
    SRP the sign cancels in the pair products, but for MUSIC's subspace
    projection the +1j convention degrades localization markedly."""
    dev = resolve_device(device)
    grids = torch.as_tensor(np.asarray(grids), dtype=torch.float64, device=dev)
    mic_pos = torch.as_tensor(np.asarray(mic_pos), dtype=torch.float64,
                              device=dev)
    dx = grids[None, :, 0] - mic_pos[:, None, 0]
    dy = grids[None, :, 1] - mic_pos[:, None, 1]
    dz = grids[None, :, 2]
    dist = torch.sqrt(dx ** 2 + dy ** 2 + dz ** 2) / c  # (M, G)
    omega = (2 * np.pi * fs
             * torch.as_tensor(np.asarray(freq_bins), dtype=torch.float64,
                               device=dev) / nfft)
    phase = sign * omega[:, None, None] * dist[None]
    return torch.polar(torch.ones_like(phase), phase)


def _stft(x: torch.Tensor, nfft: int, hop: int) -> torch.Tensor:
    """Plain framing (no window, no centre padding) and an rfft per frame:
    x (..., T) -> (..., frames, bins).  Not torch.stft, which pads."""
    return torch.fft.rfft(x.unfold(-1, nfft, hop), dim=-1)


def _windows_stft(signal, window: int, n_windows: int, nfft: int,
                  device) -> torch.Tensor:
    """The first `n_windows` non-overlapping `window`-sample windows of
    `signal` (M, T) in float64 on `device` -> (W, M, bins, frames)."""
    x = torch.as_tensor(signal, device=device).to(torch.float64)
    segs = x[:, :n_windows * window].reshape(x.shape[0], n_windows, window)
    return _stft(segs.transpose(0, 1), nfft, nfft // 4).transpose(-1, -2)


class MUSIC:
    """num_src=3 wideband MUSIC over precomputed mode vectors."""

    def __init__(self, freq_bins: np.ndarray, mode_vec: torch.Tensor,
                 num_src: int = 3, frequency_normalization: bool = True):
        self.freq_bins = np.asarray(freq_bins)
        self.num_freq = len(self.freq_bins)
        self.mode_vec = mode_vec  # (K, M, G)
        assert mode_vec.shape[0] == self.num_freq
        self.n_points = mode_vec.shape[-1]
        self.num_src = num_src
        self.frequency_normalization = frequency_normalization

    def _bins(self, X: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.freq_bins, device=X.device)

    def covariances(self, X: torch.Tensor) -> torch.Tensor:
        """X (..., M, F_all, frames) -> the selected bins' covariances
        (..., K, M, M), averaged over frames."""
        Xs = X[..., self._bins(X), :].transpose(-3, -1)  # (..., frames, K, M)
        C = Xs[..., :, None] * Xs.conj()[..., None, :]
        return C.mean(dim=-4)

    def process(self, X: torch.Tensor) -> torch.Tensor:
        """X: (..., M, F_all, frames) complex.  Returns (..., G)."""
        M = X.shape[-3]
        _, v = torch.linalg.eigh(self.covariances(X))
        Es = v[..., -self.num_src:]  # (..., K, M, num_src) signal subspace
        eye = torch.eye(M, dtype=v.dtype, device=v.device)
        cross = eye - Es @ Es.conj().transpose(-1, -2)  # (..., K, M, M)

        mode = self.mode_vec  # (K, M, G)
        # a^H P a per grid point and bin
        pa = torch.einsum("...kij,kjg->...kig", cross, mode)
        denom = (mode.conj() * pa).sum(dim=-2)  # (..., K, G)
        Pssl = 1.0 / denom.abs()

        if self.frequency_normalization:
            Pssl = Pssl / Pssl.amax(dim=-1, keepdim=True)
        return Pssl.sum(dim=-2) / self.num_freq

    # Reference-style alias
    MUSIC_process = process


def music_map_window(signal, geom, freq_bins: np.ndarray, nfft: int,
                     window: int | None = None, device=None) -> np.ndarray:
    """Windowed MUSIC map over the geometry's cluster grid, averaged over
    non-overlapping windows; (G,) float64 on the host."""
    dev = resolve_device(device)
    T = signal.shape[1]
    if window is None:
        window = 36000 if T >= 72000 else 24000
    mode = grid_mode_vectors(geom.grids, geom.mic_pos, freq_bins, FS, nfft,
                             device=dev)
    node = MUSIC(freq_bins, mode)
    n_windows = T // window
    if n_windows == 0:
        return np.zeros(geom.num_clusters)
    X = _windows_stft(signal, window, n_windows, nfft, dev)
    return node.process(X).mean(dim=0).cpu().numpy()
