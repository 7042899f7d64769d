"""Signal metrics: SI-SDR, voiced-segment splitting, windowed power.

Host NumPy, copied from the JAX package's `utils/metrics.py` for the PyTorch port
(the port imports nothing of that package).

Librosa-free reimplementation of reference sep/helpers/eval_utils.py
(si_sdr, split_wav, split_wise_sisdr) and
reference sep/helpers/local_utils_3d.py:13-17 (max_avg_power).
"""
from __future__ import annotations

import math

import numpy as np
from scipy.ndimage import uniform_filter1d

MIN_ERR = 1e-8

# SI-SDR assigned to degenerate (zero-energy) inputs: far below every
# decision threshold in the pipeline (NMS merge -1/-2/-7, eval match -15),
# so a silent head/candidate is always "maximally dissimilar" instead of
# NaN silently flowing into NMS comparisons (VERDICT r3 weak #5).
SISDR_FLOOR = -80.0


def si_sdr(estimated_signal: np.ndarray, reference_signals: np.ndarray,
           scaling: bool = True) -> float:
    """Scale-invariant SDR (scalar), matching eval_utils.py:11-39.

    Zero-energy reference or zero projection returns SISDR_FLOOR instead of
    NaN/-inf (the reference divides by zero there)."""
    ref = np.asarray(reference_signals, dtype=np.float64)
    est = np.asarray(estimated_signal, dtype=np.float64)
    Rss = float(np.dot(ref, ref))
    if scaling:
        if Rss <= 0.0 or not np.isfinite(Rss):
            return SISDR_FLOOR
        a = np.dot(ref, est) / Rss
    else:
        a = 1.0
    e_true = a * ref
    e_res = est - e_true
    Sss = float((e_true ** 2).sum())
    Snn = float((e_res ** 2).sum()) + MIN_ERR
    if Sss <= 0.0 or not np.isfinite(Sss) or not np.isfinite(Snn):
        return SISDR_FLOOR
    return max(10 * math.log10(Sss / Snn), SISDR_FLOOR)


def rms_frames(x: np.ndarray, frame_length: int = 1024, hop_length: int = 256,
               center: bool = True) -> np.ndarray:
    """Frame-wise RMS, matching librosa.feature.rms semantics (centered,
    zero-padded frames)."""
    x = np.asarray(x, dtype=np.float64)
    if center:
        x = np.pad(x, (frame_length // 2, frame_length // 2))
    n_frames = 1 + (len(x) - frame_length) // hop_length if len(x) >= frame_length else 0
    if n_frames <= 0:
        return np.zeros((0,))
    idx = np.arange(frame_length)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = x[idx]
    return np.sqrt(np.mean(frames ** 2, axis=1))


def _nonsilent_intervals(x: np.ndarray, top_db: float, ref: float | None,
                         frame_length: int, hop_length: int) -> np.ndarray:
    """Boundaries (in samples) of non-silent runs, matching
    librosa.effects.split behavior."""
    rms = rms_frames(x, frame_length, hop_length, center=True)
    if rms.size == 0:
        return np.zeros((0, 2), dtype=int)
    ref_val = np.max(rms) if ref is None else ref
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / max(ref_val, 1e-10))
    non_silent = db > -top_db
    edges = np.flatnonzero(np.diff(non_silent.astype(np.int8)))
    starts = []
    ends = []
    if non_silent[0]:
        starts.append(0)
    for e in edges:
        if non_silent[e + 1]:
            starts.append(e + 1)
        else:
            ends.append(e + 1)
    if non_silent[-1]:
        ends.append(len(non_silent))
    intervals = np.stack([np.array(starts), np.array(ends)], axis=1) * hop_length
    return np.minimum(intervals, len(x))


def split_wav(wav: np.ndarray, top_db: float = 18) -> list[list[int]]:
    """Split a waveform into voiced segments of 1000..4000 samples
    (reference: eval_utils.py:43-70)."""
    MIN_SEG = 1000
    MAX_SEG = 4000
    power_list = rms_frames(wav, 1024, 256)
    max_ref = np.amax(power_list) if power_list.size else 0.0
    split_threshold = 0.04
    ref = split_threshold if max_ref < split_threshold else None
    intervals = _nonsilent_intervals(wav, top_db, ref, 1024, 256)

    finetune_seg: list[list[int]] = []
    for start, end in intervals:
        interval_len = end - start
        if interval_len < MIN_SEG:
            continue
        if interval_len > MAX_SEG:
            num_seg = interval_len // MAX_SEG
            for i in range(num_seg):
                if i >= num_seg - 1:
                    finetune_seg.append([start + i * MAX_SEG, end])
                else:
                    finetune_seg.append([start + i * MAX_SEG, start + (i + 1) * MAX_SEG])
        else:
            finetune_seg.append([int(start), int(end)])
    return finetune_seg


def split_wise_sisdr(estimated_signal: np.ndarray, reference_signals: np.ndarray,
                     seg_index: list[list[int]]) -> list[float]:
    """Per-segment SI-SDR (reference: eval_utils.py:73-82).

    Vectorized with prefix sums: every segment's dot products come from three
    cumulative-sum arrays, so the cost is O(T + n_segments) instead of a
    Python-level si_sdr call per segment (which dominates NMS time for many
    candidates)."""
    assert len(seg_index) > 0
    est = np.asarray(estimated_signal, dtype=np.float64)
    ref = np.asarray(reference_signals, dtype=np.float64)
    ce2 = np.concatenate([[0.0], np.cumsum(est * est)])
    cr2 = np.concatenate([[0.0], np.cumsum(ref * ref)])
    cer = np.concatenate([[0.0], np.cumsum(est * ref)])
    segs = np.asarray(seg_index)
    a, b = segs[:, 0], segs[:, 1]
    Ree = ce2[b] - ce2[a]
    Rss = cr2[b] - cr2[a]
    dot = cer[b] - cer[a]
    ok = Rss > 0.0
    Sss = np.where(ok, dot * dot / np.where(ok, Rss, 1.0), 0.0)
    Snn = Ree - Sss + MIN_ERR
    out = np.where(
        ok & (Sss > 0.0) & (Snn > 0.0),
        10.0 * np.log10(np.maximum(Sss, 1e-300)
                        / np.maximum(Snn, 1e-300)),
        SISDR_FLOOR,
    )
    return list(np.maximum(out, SISDR_FLOOR))


def max_avg_power(x: np.ndarray, window_size: int = 12000):
    """Maximum sliding-window RMS and the corresponding window
    (reference: local_utils_3d.py:13-17)."""
    max_avg_energy = uniform_filter1d(
        x ** 2, size=window_size, mode="constant", origin=-window_size // 2
    )
    max_avg_energy = np.sqrt(np.abs(max_avg_energy))
    y = int(np.argmax(max_avg_energy))
    return max_avg_energy.max(), np.pad(x, (0, window_size))[y : y + window_size]
