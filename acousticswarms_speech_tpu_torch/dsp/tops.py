"""TOPS (Test of Orthogonality of Projected Subspaces) wideband DoA
baseline (JAX package: dsp/tops.py).

Near-field variant over the geometry's candidate grid positions.  For each
grid point, the signal subspace at a reference bin is phase-transformed to
the other bins and projected onto those bins' noise subspaces; the inverse
of the smallest singular value of the stacked projections is the spatial
spectrum.

Torch in complex128 on the caller's device (cuda unless named), batched
over grid points and bins.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import FS, SPEED_OF_SOUND
from ..device import resolve_device
from .music import MUSIC, _windows_stft, grid_mode_vectors


class TOPS(MUSIC):
    def __init__(self, mic_pos: np.ndarray, grids_pos: np.ndarray,
                 freq_bins: np.ndarray, mode_vec: torch.Tensor, nfft: int,
                 c: float = SPEED_OF_SOUND, fs: int = FS, num_src: int = 3):
        super().__init__(freq_bins, mode_vec, num_src=num_src)
        mic_pos = np.asarray(mic_pos, dtype=np.float64)
        mic_center = mic_pos.mean(axis=0)
        self.mic_pos = mic_pos - mic_center
        self.grids_pos = np.asarray(grids_pos, dtype=np.float64) - mic_center
        self.nfft = nfft
        self.c = c
        self.fs = fs

    def projections(self, X: torch.Tensor) -> torch.Tensor:
        """X: (M, F_all, frames) complex -> D (G, num_src,
        (K-1)(M-num_src)), the stacked projections of every grid point."""
        dev = X.device
        M = X.shape[0]
        K = self.num_freq
        ns = self.num_src

        # reference bin: largest total power among selected bins
        bins = self._bins(X)
        max_bin = int(torch.argmax(X[:, bins, :].abs().sum(dim=0).sum(dim=1)))
        f0 = self.freq_bins[max_bin]

        _, v = torch.linalg.eigh(self.covariances(X))
        F_sig = v[..., -ns:]          # (K, M, num_src)
        W_noise = v[..., : M - ns]    # (K, M, M - num_src)

        # phase transformation per grid point and bin
        f = torch.as_tensor(1.0 / self.nfft / self.c * 2 * np.pi * self.fs
                            * (self.freq_bins - f0), dtype=torch.float64,
                            device=dev)  # (K,)
        grids = torch.as_tensor(self.grids_pos, device=dev)
        mics = torch.as_tensor(self.mic_pos, device=dev)
        path_s = torch.linalg.norm(grids, dim=1)  # (G,)
        delta = path_s[None, :] - torch.linalg.norm(
            grids[None, :, :] - mics[:, None, :], dim=-1)  # (M, G)

        others = [k for k in range(K) if k != max_bin]
        sel = torch.as_tensor(others, device=dev)
        phase = f[sel, None, None] * delta[None]  # (K-1, M, G)
        Phi = torch.polar(torch.ones_like(phase), phase)
        F0 = F_sig[max_bin]  # (M, num_src)
        # D blocks U_k W_k, with U_k = conj(diag(Phi_k) F0)^T per grid point,
        # stacked over the K-1 non-reference bins in bin order
        U = (Phi[:, :, :, None] * F0[None, :, None, :]).conj()  # (K-1,M,G,ns)
        blocks = torch.einsum("kmgs,kmn->gskn", U, W_noise[sel])
        return blocks.reshape(blocks.shape[0], ns, -1)

    def process(self, X: torch.Tensor) -> torch.Tensor:
        """X: (M, F_all, frames) complex.  Returns (G,): the inverse of the
        smallest singular value of each grid point's projections D.

        That singular value is taken as the square root of the smallest
        eigenvalue of the num_src x num_src Gram matrix D D^H, the same
        quantity: `torch.linalg.svdvals` of the (22563, 3, 788) stack of a
        dev scene took 11.7 s on an H100, whose batched SVD covers only
        small matrices, and the Gram route 2.1 ms, agreeing to 3e-15
        (chip_smoke.py, baselines phase)."""
        D = self.projections(X)
        gram = D @ D.conj().transpose(-1, -2)
        smallest = torch.linalg.eigvalsh(gram)[:, 0].clamp(min=0).sqrt()
        return 1.0 / torch.clamp(smallest, min=1e-12)

    _process = process


def tops_map_window(signal, geom, freq_bins: np.ndarray, nfft: int,
                    window: int = 72000, device=None) -> np.ndarray:
    """Windowed TOPS map over fixed 72000-sample windows, averaged; a
    signal shorter than one window gives one run over all of it.  (G,)
    float64 on the host."""
    dev = resolve_device(device)
    mode = grid_mode_vectors(geom.grids, geom.mic_pos, freq_bins, FS, nfft,
                             device=dev)
    node = TOPS(geom.mic_pos, geom.grids, freq_bins, mode, nfft=nfft)
    T = signal.shape[1]
    n_windows = T // window
    if n_windows == 0:  # shorter than the TOPS window: one truncated run
        X = _windows_stft(signal, T, 1, nfft, dev)
    else:
        X = _windows_stft(signal, window, n_windows, nfft, dev)
    acc = torch.stack([node.process(x) for x in X]).sum(dim=0)
    return (acc / X.shape[0]).cpu().numpy()
