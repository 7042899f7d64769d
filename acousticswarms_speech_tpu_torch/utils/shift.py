"""Shift / TDoA geometry math.

Host NumPy, copied from the JAX package's `utils/shift.py` for the PyTorch port
(the port imports nothing of that package).

Counterpart of reference sep/helpers/utils.py:98-153
(`phase_offset`, `criterion`, `shift_mixture_given_samples`,
`get_shift_vector`).  Host-side variants operate on numpy; device variants
live in `ops.shift`.
"""
from __future__ import annotations

import numpy as np

from ..constants import SPEED_OF_SOUND


def phase_offset(a: np.ndarray, b: np.ndarray, sr: int) -> np.ndarray:
    """Propagation delay (samples) between point(s) `a` and point `b`."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    axis = 0 if a.ndim == 1 else 1
    return np.linalg.norm(b - a, axis=axis) * sr / SPEED_OF_SOUND


def criterion(m: np.ndarray, s: np.ndarray, sr: int) -> np.ndarray:
    """Shift audio from channel at `m` to appear as though it started at `s`."""
    return -phase_offset(m, s, sr)


def get_shift_vector(
    target_position: np.ndarray,
    mic_positions: np.ndarray,
    sr: int,
    reference_channel: int = 0,
) -> np.ndarray:
    """Integer sample shifts that align every channel to the reference channel
    for a source at `target_position` (reference: utils.py:145-153)."""
    d = phase_offset(mic_positions, np.asarray(target_position), sr)
    vec = -(d - d[reference_channel])
    return np.round(vec).astype(np.int32)


def sample_offsets_for(
    positions: np.ndarray, mic_positions: np.ndarray, sr: int
) -> np.ndarray:
    """TDoA vectors (num_points, M-1): delay(mic_i) - delay(mic_0) in samples,
    for each candidate position.  Vectorized equivalent of
    SRP_Prunning.calculate_offset_pair (reference .../SRP_Prunning.py:257-263)."""
    positions = np.atleast_2d(np.asarray(positions, dtype=np.float64))
    d = np.linalg.norm(
        positions[:, None, :] - mic_positions[None, :, :], axis=-1
    )  # (N, M)
    off = (d[:, 1:] - d[:, :1]) / SPEED_OF_SOUND * sr
    return off


def shift_mixture_given_samples(
    input_data: np.ndarray, shifts: np.ndarray, inverse: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Circularly shift each channel by its sample shift
    (reference: utils.py:119-141).  Shifts larger than the signal zero the
    channel out, mirroring the reference's guard."""
    shifts = np.array(shifts, copy=True)
    out = np.zeros_like(input_data)
    T = input_data.shape[1]
    for c in range(input_data.shape[0]):
        s = int(shifts[c])
        if abs(s) > T:
            shifts[c] = T
            continue
        if inverse:
            s = -s
        out[c] = np.roll(input_data[c], s)
        shifts[c] = s
    return out, shifts


def shift_crop_given_samples(
    input_data: np.ndarray, shifts: np.ndarray, start: int, length: int
) -> np.ndarray:
    """``shift_mixture_given_samples(x, shifts)[0][:, start:start+length]``
    without materializing the full-length shifted array.

    For an interior window (margin ``max|shift|+1`` fits inside the
    signal), a circular shift never wraps the global edges into the crop, so
    each channel is a direct strided read — this is the training data-prep
    hot path when ``crop_seconds`` is set (full-T shift of a (35, 144k)
    stack costs ~0.3 s/item on one host core, all of it thrown away by the
    crop).  Boundary windows fall back to the exact full shift + crop."""
    shifts = np.asarray(shifts)
    n, T = input_data.shape
    m = (int(np.max(np.abs(shifts))) if shifts.size else 0) + 1
    if m <= T and start - m >= 0 and start + length + m <= T:
        sl = input_data[:, start - m : start + length + m]
        out = np.empty((n, length), dtype=np.float32)
        for c in range(n):
            s = int(shifts[c])
            # roll(y, s)[m : m+length] == y[m-s : m-s+length] when |s| <= m
            out[c] = sl[c, m - s : m - s + length]
        return out
    full, _ = shift_mixture_given_samples(input_data, shifts)
    return np.ascontiguousarray(full[:, start : start + length],
                                dtype=np.float32)


def to_categorical(index: int, num_classes: int) -> np.ndarray:
    """1-hot encoding (reference: utils.py:155-159)."""
    data = np.zeros((num_classes,), dtype=np.float32)
    data[index] = 1.0
    return data
