"""SRP-PHAT steered-response map (JAX: ops/srp.py).

Phase-only STFT of overlapping analysis windows, the covariance of each mic
pair per (window, bin), one (G, K*P) @ (K*P, W) steering product for all
windows, and the max over windows clamped at 0.
"""
from __future__ import annotations

import numpy as np
import torch

from .stft import stft_windowed_bins


def pair_indices(num_mic: int) -> tuple[np.ndarray, np.ndarray]:
    """Upper-triangle (i < j) microphone pairs, row-major."""
    return np.triu_indices(num_mic, k=1)


def build_steering_table(grids: np.ndarray, mic_pos: np.ndarray,
                         freq_bins: np.ndarray, fs: int, nfft: int,
                         c: float = 343.0) -> tuple[np.ndarray, np.ndarray]:
    """Host steering table: (steer_re, steer_im), each (G, K*P) float32,
    the pair phase products exp(1j * omega_k * (d_i - d_j) / c).

    As in the reference, microphone z is treated as 0 while the grid z is
    used as-is."""
    grids = np.asarray(grids, dtype=np.float64)
    mic_pos = np.asarray(mic_pos, dtype=np.float64)
    M = mic_pos.shape[0]
    dx = grids[None, :, 0] - mic_pos[:, None, 0]
    dy = grids[None, :, 1] - mic_pos[:, None, 1]
    dz = grids[None, :, 2]  # mic z treated as 0 (reference quirk)
    dist = np.sqrt(dx ** 2 + dy ** 2 + dz ** 2) / c  # (M, G) seconds

    ii, jj = pair_indices(M)
    ddiff = dist[ii] - dist[jj]  # (P, G)

    omega = 2.0 * np.pi * fs * np.asarray(freq_bins, dtype=np.float64) / nfft
    K, (P, G) = len(omega), ddiff.shape
    steps = np.diff(omega)
    if K > 1 and np.allclose(steps, steps[0]):
        # Consecutive bins: e^{i w_k d} = e^{i w_0 d} (e^{i dw d})^k, one
        # complex64 multiply per bin (the same recurrence as the JAX package,
        # so the two tables agree to the last bit).
        ddiff_t = np.ascontiguousarray(ddiff.T)  # (G, P)
        phasor = np.exp(1j * omega[0] * ddiff_t).astype(np.complex64)
        step_ph = np.exp(1j * steps[0] * ddiff_t).astype(np.complex64)
        steer_re = np.empty((G, K, P), dtype=np.float32)
        steer_im = np.empty((G, K, P), dtype=np.float32)
        for k in range(K):
            steer_re[:, k, :] = phasor.real
            steer_im[:, k, :] = phasor.imag
            if k + 1 < K:
                phasor *= step_ph
        return steer_re.reshape(G, K * P), steer_im.reshape(G, K * P)
    phase = omega[:, None, None] * ddiff[None, :, :]  # (K, P, G)
    steer_re = np.cos(phase).transpose(2, 0, 1).reshape(G, -1)
    steer_im = np.sin(phase).transpose(2, 0, 1).reshape(G, -1)
    return steer_re.astype(np.float32), steer_im.astype(np.float32)


def srp_phat_map(signal: torch.Tensor, steer_re: torch.Tensor,
                 steer_im: torch.Tensor, bins: torch.Tensor, window: int,
                 nfft: int, hop: int, tol: float = 1e-8) -> torch.Tensor:
    """signal: (M, T); steer_*: (G, K*P); bins: (K,) STFT bin indices.
    Returns the (G,) float32 map: max over analysis windows, clamped at 0."""
    M = signal.shape[0]
    re, im = stft_windowed_bins(signal.float(), bins, window, window // 2,
                                nfft, hop)  # each (W, M, frames, K)
    mag = torch.clamp(torch.sqrt(re * re + im * im), min=tol)
    pre, pim = re / mag, im / mag

    frames = re.shape[2]
    ii, jj = pair_indices(M)
    # C_mn = sum_t p_m conj(p_n) = (RmRn + ImIn) + 1j (ImRn - RmIn)
    cov_re = (torch.einsum("wmtk,wntk->wkmn", pre, pre)
              + torch.einsum("wmtk,wntk->wkmn", pim, pim)) / frames
    cov_im = (torch.einsum("wmtk,wntk->wkmn", pim, pre)
              - torch.einsum("wmtk,wntk->wkmn", pre, pim)) / frames
    ii_t = torch.as_tensor(ii, device=signal.device)
    jj_t = torch.as_tensor(jj, device=signal.device)
    W = cov_re.shape[0]
    cov_re = cov_re[:, :, ii_t, jj_t].reshape(W, -1)  # (W, K*P)
    cov_im = cov_im[:, :, ii_t, jj_t].reshape(W, -1)

    maps = steer_re @ cov_re.T - steer_im @ cov_im.T  # (G, W)
    maps = maps / (len(bins) * len(ii))
    return torch.clamp(torch.amax(maps, dim=1), min=0.0)


def srp_window_size(T: int) -> int:
    """Analysis-window policy of the reference."""
    return 36000 if T >= 72000 else 24000


class SrpMapComputer:
    """The device-resident steering tables of one geometry."""

    def __init__(self, grids, mic_pos, freq_bins, fs, nfft, c=343.0,
                 device="cuda"):
        self.device = torch.device(device)
        self.nfft = nfft
        self.hop = nfft // 4
        self.num_grids = len(grids)
        steer_re, steer_im = build_steering_table(
            grids, mic_pos, np.asarray(freq_bins), fs, nfft, c)
        self.steer_re = torch.as_tensor(steer_re, device=self.device)
        self.steer_im = torch.as_tensor(steer_im, device=self.device)
        self.bins = torch.as_tensor(np.asarray(freq_bins), device=self.device)

    def __call__(self, signal, window: int) -> torch.Tensor:
        signal = torch.as_tensor(signal, dtype=torch.float32,
                                 device=self.device)
        return srp_phat_map(signal, self.steer_re, self.steer_im, self.bins,
                            window, self.nfft, self.hop)
