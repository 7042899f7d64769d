# Frozen copy of acousticswarms_speech_tpu_torch/search/consistency.py at commit 300ffdc,
# part of the benchmark's plain reference: it imports nothing of the port.
"""TDoA-consistency scoring for spotformed candidate heads.

Host NumPy, copied from the JAX package's `search/consistency.py` for the PyTorch port
(the port imports nothing of that package).

The trained-to-date spot net's dominant failure mode (PERF.md round-4
labeled NMS accounting) is extracting the scene's dominant speaker at
off-target positions; such a head's audio is near-identical to the true
head's (median +10.9 dB pair SI-SDR), so no SI-SDR merge threshold can
separate them — but their *time structure* differs: an extraction that
really comes from its claimed position correlates with each raw mic
channel at lags matching the claimed per-mic TDoA offsets, while a leaked
extraction correlates at the *true* source's TDoAs.

Scoring (validated against GT audio on probe scenes, PERF.md round-4):

- **GCC-PHAT whitening.**  Plain cross-correlation argmax is dominated by
  the speech signal's own autocorrelation and by reverberant reflections
  (GT-labeled heads measured median deviation 135 samples); whitening the
  cross-spectrum makes the direct-path lag the argmax (genuine pairings
  score 0-1 samples).
- **Robust time base + median deviation.**  1-2 of the 7 mics typically
  mis-lock (the speaker is drowned out at that mic), so both the unknown
  absolute alignment of the extraction and the per-mic deviations are
  estimated with medians: model ``lag_m = s + c_m`` with ``c_0 = 0``,
  ``c_m = round(claimed offset m)``; ``s = median(lag - c)``;
  score = ``median |lag - s - c|``.  Genuine: ~0; leaked: roughly the
  median TDoA gap between the claimed and true positions (probe scenes:
  p10 >= 6, median 15-60 — compare the mining label threshold of 4.9
  samples, data/generate_srp_sample.py).

No reference counterpart: the reference's converged net is position-
selective enough that power-ranked NMS suffices (Mic_Array.py:399-500).
Scores are recorded into power-trace records for offline labeled
validation (scripts/replay_nms.py) before any gating decision is enabled;
the gate itself is env-opt-in (NMS_TDOA_GATE).
"""
from __future__ import annotations

import numpy as np

# Search window for cross-correlation lags, in samples.  Claimed relative
# TDoAs on the table geometry reach +-110 samples at 48 kHz (seen in GT
# offsets); the window must cover them with margin or the argmax of an
# out-of-window true lag aliases to a wrong in-window peak.
MAX_LAG = 256


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _lag_window(corr: np.ndarray, n: int, max_lag: int) -> np.ndarray:
    """Restrict a circular correlation (..., n) to lags [-max_lag, max_lag]
    and return the argmax lag per row."""
    window = np.concatenate(
        [corr[..., n - max_lag:], corr[..., : max_lag + 1]], axis=-1
    )
    return window.argmax(axis=-1).astype(np.int64) - max_lag


def _phat(spec: np.ndarray) -> np.ndarray:
    return spec / np.maximum(np.abs(spec), 1e-12)


def measured_lags(head_audio: np.ndarray, mix: np.ndarray,
                  max_lag: int = MAX_LAG) -> np.ndarray:
    """Per-mic GCC-PHAT argmax lag of `head_audio` (T,) against each raw
    channel of `mix` (M, T): lag_m = argmax_l IFFT[whiten(conj(Y) X_m)](l),
    restricted to |l| <= max_lag.  Zero-padding past T + 2*max_lag makes
    the restricted window wrap-free for the unwhitened linear correlation;
    under PHAT whitening the IFFT is no longer that exact linear
    correlation, so the guarantee is approximate there (practically
    negligible — ADVICE r4)."""
    y = np.asarray(head_audio, dtype=np.float32)
    x = np.asarray(mix, dtype=np.float32)
    T = min(y.shape[-1], x.shape[-1])
    y, x = y[:T], x[:, :T]
    n = _next_pow2(T + 2 * max_lag + 1)
    Y = np.fft.rfft(y, n)
    X = np.fft.rfft(x, n, axis=-1)
    corr = np.fft.irfft(_phat(np.conj(Y)[None, :] * X), n, axis=-1)
    return _lag_window(corr, n, max_lag)


def _robust_deviation(lags: np.ndarray, claimed_rel) -> float:
    """Median |lag - s - c| with the time base s itself a median estimate;
    c = [0, round(claimed_rel)].  Robust to a minority of mis-locked mics
    (including mic 0 — no channel is privileged as the base)."""
    c = np.concatenate([[0.0], np.round(np.asarray(claimed_rel,
                                                   dtype=np.float64))])
    s = np.median(lags - c)
    return float(np.median(np.abs(lags - s - c)))


def head_deviations(head_audios, mix: np.ndarray, claimed_list,
                    max_lag: int = MAX_LAG) -> list[float]:
    """`tdoa_deviation` for many heads of one scene, computing the mix
    channels' FFTs once (the per-scene cost is then one rfft per head)."""
    if not head_audios:
        return []
    x = np.asarray(mix, dtype=np.float32)
    T = min(min(np.asarray(y).shape[-1] for y in head_audios), x.shape[-1])
    n = _next_pow2(T + 2 * max_lag + 1)
    X = np.fft.rfft(x[:, :T], n, axis=-1)
    devs = []
    for y, claimed in zip(head_audios, claimed_list):
        Y = np.fft.rfft(np.asarray(y, dtype=np.float32)[:T], n)
        corr = np.fft.irfft(_phat(np.conj(Y)[None, :] * X), n, axis=-1)
        lags = _lag_window(corr, n, max_lag)
        devs.append(_robust_deviation(lags, claimed))
    return devs


def tdoa_deviation(head_audio: np.ndarray, mix: np.ndarray,
                   claimed_pair_offsets: np.ndarray,
                   max_lag: int = MAX_LAG) -> float:
    """Robust median deviation (samples) between measured GCC-PHAT lags and
    the head's claimed pair offsets (same TDoA convention as the GT labels,
    pipeline/evaluate.py:94-101: offset[i-1] = delay of mic i minus mic 0).

    ~0 for an extraction genuinely at the claimed position; roughly the
    median TDoA gap between the claimed and true source positions for a
    leaked extraction."""
    lags = measured_lags(head_audio, mix, max_lag)
    return _robust_deviation(lags, claimed_pair_offsets)
