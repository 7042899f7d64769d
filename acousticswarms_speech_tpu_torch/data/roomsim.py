"""Shoebox image-source room simulator (JAX package: data/roomsim.py).

The Allen & Berkley (1979) image-source model with fractional-delay
windowed-sinc injection, as pyroomacoustics formulates it:

- image positions R = ((-1)^p * s + 2 r .* L) over p in {0,1}^3, r in Z^3
- per-image amplitude = beta^(#wall hits) / (4 pi d), beta = sqrt(1 - a)
- each image contributes an 81-tap windowed-sinc at its fractional delay

The image lattice and its pruning are host NumPy, copied from the JAX
package.  The render (the sinc taps scattered into each impulse response)
and the convolution of each source with its responses are torch code in
float64 on the room's device (cuda unless the caller names another), all
microphones of a source in one batched call.  The sinc kernel is built in
float32 and accumulated in float64, as the JAX package does, so that the
taps agree.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
from scipy.fft import next_fast_len

from ..device import resolve_device

FDL = 81  # fractional delay filter length (matches pra's default)
EARLY_WINDOW_S = 0.008  # early reflections rendered with the full sinc
FDL_TAIL = 11           # tail fractional-delay taps (near-allpass to ~19 kHz)


def _image_sources(src: np.ndarray, room: np.ndarray, max_order: int):
    """All image positions and wall-hit counts up to `max_order` reflections.

    Returns (positions (N, 3), hits (N,)).  The (p, r) lattice is
    materialized with broadcasting."""
    dims = len(room)
    src = np.asarray(src, dtype=np.float64)[:dims]
    room = np.asarray(room, dtype=np.float64)
    n = max_order // 2 + 1
    ax = np.arange(-n, n + 1, dtype=np.int32)
    grids = np.meshgrid(*([ax] * dims), indexing="ij")
    r = np.stack([g.ravel() for g in grids], axis=1)  # (R, dims)
    # hits(r, p) >= 2*||r||_1 - dims, so the L1 ball prescreens the lattice
    # (keeps ~17% in 3-D) before the 2^dims mirror expansion
    r = r[np.abs(r).sum(1) * 2 - dims <= max_order]
    ps = np.array(list(itertools.product((0, 1), repeat=dims)),
                  dtype=np.int32)  # (P, dims)
    hits = (np.abs(r[None, :, :] - ps[:, None, :])
            + np.abs(r)[None, :, :]).sum(-1)  # (P, R)
    mask = hits <= max_order
    pos = ((1 - 2 * ps)[:, None, :].astype(np.float64) * src[None, None, :]
           + 2.0 * r[None, :, :] * room[None, None, :])  # (P, R, dims)
    return pos[mask], hits[mask]


def prune_images(images, mic_center: np.ndarray, absorption: float,
                 rel_cutoff: float, margin: float = 2.0):
    """Drop images whose amplitude upper bound is below `rel_cutoff` of the
    strongest image as seen from anywhere within `margin` meters of
    `mic_center` (mic-independent, so one pruning serves a whole array).

    The default 1e-4 cutoff is -80 dB relative to the direct path, 20 dB
    below the RT60 definition's -60 dB tail end."""
    if rel_cutoff <= 0.0:
        return images
    positions, hits = images
    beta = np.sqrt(max(1.0 - absorption, 0.0))
    d = np.linalg.norm(positions - np.asarray(mic_center, dtype=np.float64),
                       axis=1)
    log_beta = np.log(max(beta, 1e-30))
    # amp bound: beta^hits / (4 pi max(d - margin, d_floor))
    bound = hits * log_beta - np.log(4.0 * np.pi
                                     * np.maximum(d - margin, 1e-3))
    keep = bound >= bound.max() + np.log(rel_cutoff)
    return positions[keep], hits[keep]


def _hanning(fdl: int) -> np.ndarray:
    """np.hanning(fdl + 2)[1:-1]: the window without its two zero ends (not
    torch.hann_window(fdl), whose ends differ)."""
    return np.hanning(fdl + 2)[1:-1].astype(np.float32)


def _scatter_sinc(rirs: torch.Tensor, row: torch.Tensor, delay: torch.Tensor,
                  amp: torch.Tensor, fdl: int) -> None:
    """Add `fdl`-tap windowed-sinc pulses at fractional `delay`s (float64)
    with amplitudes `amp` (float32) into rows `row` of `rirs` (R, L)
    float64, in place."""
    L = rirs.shape[1]
    dev = rirs.device
    half = (fdl - 1) // 2
    t0 = torch.floor(delay).to(torch.int64)
    frac = (delay - t0).to(torch.float32)
    offsets = torch.arange(-half, half + 1, device=dev)
    arg = offsets.to(torch.float32)[None, :] - frac[:, None]
    window = torch.as_tensor(_hanning(fdl), device=dev)[None, :]
    # np.sinc's form, in float32: sin(pi x) / (pi x) with x = 0 -> 1e-20
    y = torch.pi * torch.where(arg == 0, torch.full_like(arg, 1e-20), arg)
    kernel = (torch.sin(y) / y * window) * amp[:, None]
    start = t0[:, None] + offsets[None, :]
    valid = (start >= 0) & (start < L)
    flat = row[:, None] * L + start.clamp(0, L - 1)
    vals = torch.where(valid, kernel, torch.zeros_like(kernel))
    rirs.view(-1).index_add_(0, flat.reshape(-1),
                             vals.reshape(-1).to(torch.float64))


def render_rirs(images, mics: np.ndarray, absorption: float, fs: int,
                c: float = 343.0, exact: bool = False, device=None):
    """Impulse responses from one source's `images` (positions, hits) to
    every microphone of `mics` (M, 3), on `device`.

    Returns (rirs (M, L) float64, lengths (M,)): row m holds mic m's
    response in its first lengths[m] samples (the length `compute_rir`
    gives it) and zeros after.

    Rendering is hybrid: images arriving within EARLY_WINDOW_S of a mic's
    direct path (the TDoA-carrying part) get the full 81-tap sinc, the
    diffuse tail an 11-tap sinc; `exact=True` renders everything with the
    full sinc."""
    dev = resolve_device(device)
    positions, hits = images
    mics = np.asarray(mics, dtype=np.float64).reshape(-1, positions.shape[1])
    pos = torch.as_tensor(positions, dtype=torch.float64, device=dev)
    mic = torch.as_tensor(mics, dtype=torch.float64, device=dev)
    beta = float(np.sqrt(max(1.0 - absorption, 0.0)))
    d = torch.linalg.norm(pos[None, :, :] - mic[:, None, :], dim=-1)  # (M, N)
    d = torch.clamp(d, min=1e-3)
    hits_t = torch.as_tensor(hits, dtype=torch.float64, device=dev)
    amp = (beta ** hits_t[None, :] / (4.0 * np.pi * d)).to(torch.float32)
    delay = d / c * fs  # fractional samples

    lengths = (torch.ceil(delay.amax(dim=1)).to(torch.int64)
               + FDL + 1).cpu().numpy()
    M, N = delay.shape
    rirs = torch.zeros((M, int(lengths.max())), dtype=torch.float64,
                       device=dev)
    rows = torch.arange(M, device=dev)[:, None].expand(M, N)
    if exact:
        early = torch.ones_like(delay, dtype=torch.bool)
    else:
        early = delay <= delay.amin(dim=1, keepdim=True) + EARLY_WINDOW_S * fs
    _scatter_sinc(rirs, rows[early], delay[early], amp[early], FDL)
    tail = ~early
    if bool(tail.any()):
        _scatter_sinc(rirs, rows[tail], delay[tail], amp[tail], FDL_TAIL)
    return rirs, lengths


def compute_rir(src: np.ndarray, mic: np.ndarray, room: np.ndarray,
                absorption: float, max_order: int, fs: int,
                c: float = 343.0, images=None,
                rel_cutoff: float = 0.0, exact: bool = False,
                device=None) -> torch.Tensor:
    """Room impulse response from `src` to `mic`: a 1-D float64 tensor on
    `device` (cuda unless named).

    `images`: optional precomputed (positions, hits) from `_image_sources`
    (they depend only on the source).  `rel_cutoff` > 0 additionally prunes
    images below that fraction of the strongest image's amplitude (see
    `prune_images`).  Rendering as in `render_rirs`."""
    if images is None:
        images = _image_sources(np.asarray(src, dtype=np.float64),
                                np.asarray(room, dtype=np.float64),
                                max_order)
    if rel_cutoff > 0.0:
        images = prune_images(images, mic, absorption, rel_cutoff, margin=0.0)
    rirs, lengths = render_rirs(images, np.asarray(mic)[None], absorption,
                                fs, c, exact, device)
    return rirs[0, :lengths[0]]


def convolve(sig: torch.Tensor, rirs: torch.Tensor) -> torch.Tensor:
    """Full linear convolution of `sig` (T,) with each row of `rirs` (M, L),
    as scipy's fftconvolve: (M, T + L - 1)."""
    n = sig.shape[-1] + rirs.shape[-1] - 1
    size = next_fast_len(n, real=True)
    spec = torch.fft.rfft(sig, n=size)[None, :] * torch.fft.rfft(rirs, n=size)
    return torch.fft.irfft(spec, n=size)[:, :n]


class ShoeBox:
    """Minimal pyroomacoustics-compatible shoebox room whose render runs on
    `device` (cuda unless named)."""

    def __init__(self, p, fs: int, max_order: int = 10,
                 absorption: float = 0.3, c: float = 343.0,
                 rel_cutoff: float = 3e-5, device=None):
        self.room = np.asarray(p, dtype=np.float64)
        self.fs = fs
        self.max_order = max_order
        self.absorption = absorption
        self.c = c
        self.rel_cutoff = rel_cutoff
        self.device = resolve_device(device)
        self.mic_array: np.ndarray | None = None
        self.sources: list[tuple[np.ndarray, np.ndarray]] = []

    def add_microphone_array(self, mic_positions: np.ndarray) -> None:
        """mic_positions: (dims, M) like pra, or (M, dims)."""
        mp = np.asarray(mic_positions, dtype=np.float64)
        if mp.shape[0] in (2, 3) and mp.shape[0] < mp.shape[1]:
            mp = mp.T
        self.mic_array = mp  # (M, dims)

    def add_source(self, position, signal) -> None:
        self.sources.append((np.asarray(position, dtype=np.float64),
                             np.asarray(signal, dtype=np.float64)))

    def simulate(self, return_premix: bool = True) -> np.ndarray:
        """Returns premix (n_sources, n_mics, T) float64 on the host, like
        `pra.ShoeBox.simulate(return_premix=True)`: per-source reverberant
        images at every microphone, zero-padded to the longest one."""
        assert self.mic_array is not None and self.sources
        M = self.mic_array.shape[0]
        S = len(self.sources)

        mic_center = self.mic_array.mean(axis=0)
        margin = float(np.linalg.norm(self.mic_array - mic_center,
                                      axis=1).max()) + 0.01
        outs = []
        for src, sig in self.sources:
            images = _image_sources(src, self.room, self.max_order)
            images = prune_images(images, mic_center, self.absorption,
                                  self.rel_cutoff, margin=margin)
            rirs, lengths = render_rirs(images, self.mic_array,
                                        self.absorption, self.fs, self.c,
                                        device=self.device)
            conv = convolve(torch.as_tensor(sig, device=self.device), rirs)
            # each mic's convolution is len(sig) + lengths[m] - 1 long, as
            # fftconvolve with its own response gives it
            n = len(sig) + torch.as_tensor(lengths, device=self.device) - 1
            keep = torch.arange(conv.shape[1], device=self.device) < n[:, None]
            outs.append(torch.where(keep, conv, torch.zeros_like(conv)))

        T = max(x.shape[1] for x in outs)
        premix = torch.zeros((S, M, T), dtype=torch.float64, device=self.device)
        for s, x in enumerate(outs):
            premix[s, :, :x.shape[1]] = x
        return premix.cpu().numpy()


def inverse_sabine(rt60: float, room_dim) -> tuple[float, int]:
    """Absorption + ISM order for a target RT60 (Sabine's formula), as
    pyroomacoustics' helper."""
    room_dim = np.asarray(room_dim, dtype=np.float64)
    V = float(np.prod(room_dim))
    if len(room_dim) == 3:
        S = 2.0 * (room_dim[0] * room_dim[1] + room_dim[1] * room_dim[2]
                   + room_dim[0] * room_dim[2])
    else:
        S = 2.0 * np.sum(room_dim)
    c = 343.0
    a = 24.0 * np.log(10.0) * V / (c * S * rt60)
    if a >= 1.0:
        raise ValueError(
            "evaluation of parameters failed. room may be too large for "
            "required RT60."
        )
    R = np.min(room_dim) / 2.0
    max_order = int(np.ceil(c * rt60 / (2.0 * R)))
    return float(a), max_order
