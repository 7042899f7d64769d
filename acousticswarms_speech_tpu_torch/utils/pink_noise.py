"""Gaussian (1/f)**beta colored-noise generator (Timmer & Koenig 1995)
(JAX: utils/pink_noise.py).

The host NumPy generator is copied from the JAX package; the on-device
generator draws with a `torch.Generator` and inverts with `torch.fft`.

Capability match for reference sep/helpers/pink_noise.py (used as a
training-time perturbation).  Implemented directly from the published
algorithm: draw Fourier components with power-law scaled variance, force the
DC / Nyquist components real, inverse-rFFT and normalize to unit variance.
"""
from __future__ import annotations

import numpy as np
import torch


def powerlaw_psd_gaussian(exponent: float, size, fmin: float = 0.0,
                          random_state=None) -> np.ndarray:
    try:
        size = list(size)
    except TypeError:
        size = [size]
    samples = size[-1]
    s_scale, sigma = _psd_scale(exponent, samples, fmin)
    size[-1] = len(s_scale)
    dims_to_add = len(size) - 1
    s_scale = s_scale[(np.newaxis,) * dims_to_add + (Ellipsis,)]

    rng = _as_rng(random_state)
    # standard_normal(dtype=float32) * scale is ~10x faster than
    # Generator.normal(scale=<array>) (which draws per-element in float64)
    # and this runs in the training data-prep hot loop (perturb_audio) on a
    # single host core; float32 keeps the irfft in complex64.
    s_scale = s_scale.astype(np.float32)
    if isinstance(rng, np.random.RandomState):
        sr = rng.normal(size=size).astype(np.float32) * s_scale
        si = rng.normal(size=size).astype(np.float32) * s_scale
    else:
        sr = rng.standard_normal(size, dtype=np.float32) * s_scale
        si = rng.standard_normal(size, dtype=np.float32) * s_scale

    if not (samples % 2):
        si[..., -1] = 0
        sr[..., -1] *= np.sqrt(2)
    si[..., 0] = 0
    sr[..., 0] *= np.sqrt(2)

    s = (sr + 1j * si).astype(np.complex64)
    return np.fft.irfft(s, n=samples, axis=-1) / sigma


def _psd_scale(exponent: float, samples: int, fmin: float = 0.0):
    """Host-side rFFT amplitude scaling + output sigma shared by the numpy
    and torch generators."""
    f = np.fft.rfftfreq(samples)
    if not (0 <= fmin <= 0.5):
        raise ValueError("fmin must be chosen between 0 and 0.5.")
    fmin = max(fmin, 1.0 / samples)
    s_scale = f.copy()
    ix = int(np.sum(s_scale < fmin))
    if ix and ix < len(s_scale):
        s_scale[:ix] = s_scale[ix]
    s_scale = s_scale ** (-exponent / 2.0)
    w = s_scale[1:].copy()
    w[-1] *= (1 + (samples % 2)) / 2.0
    sigma = 2 * np.sqrt(np.sum(w ** 2)) / samples
    return s_scale.astype(np.float32), float(sigma)


def powerlaw_psd_gaussian_torch(exponent: float, shape, generator,
                                fmin: float = 0.0, device=None):
    """:func:`powerlaw_psd_gaussian` on a torch device, for the training
    step's noise augmentation.  `generator` is a `torch.Generator` on
    `device` (default: the generator's device).

    Same Timmer & Koenig construction and edge handling as the numpy
    version: two normal draws scaled by the power law, the DC (and even-T
    Nyquist) components made real, one batched irfft."""
    device = generator.device if device is None else torch.device(device)
    shape = tuple(shape)
    samples = shape[-1]
    s_scale_np, sigma = _psd_scale(exponent, samples, fmin)
    s_scale = torch.as_tensor(s_scale_np, device=device)
    fshape = shape[:-1] + (s_scale_np.shape[0],)
    sr_ = torch.randn(fshape, generator=generator, device=device) * s_scale
    si_ = torch.randn(fshape, generator=generator, device=device) * s_scale
    if not (samples % 2):
        si_[..., -1] = 0.0
        sr_[..., -1] *= np.sqrt(2)
    si_[..., 0] = 0.0
    sr_[..., 0] *= np.sqrt(2)
    s = torch.complex(sr_, si_)
    return torch.fft.irfft(s, n=samples, dim=-1) / sigma


def _as_rng(random_state):
    if random_state is None or isinstance(random_state, (int, np.integer)):
        return np.random.default_rng(random_state)
    if isinstance(random_state, (np.random.Generator, np.random.RandomState)):
        return random_state
    raise ValueError("random_state must be int, Generator or RandomState")
