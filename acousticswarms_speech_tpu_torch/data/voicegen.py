"""Synthetic speech ("voice bank") generator: Klatt-style formant synthesis
(JAX package: data/voicegen.py, copied as host NumPy and SciPy).

VCTK-layout speaker banks of synthetic speech with the spectro-temporal
structure the pipeline depends on:

- harmonic voiced segments (glottal pulse train) with moving formants, so
  cross-mic phase is coherent and SRP-PHAT / spotforming see speech-like
  signals rather than stationary noise;
- per-speaker identity (f0 register, vocal-tract length scale, breathiness),
  so separation learns speaker-discriminative masks;
- syllabic rhythm with pauses, fricatives and plosive bursts, so the
  energy-based segment metrics (utils/metrics.py split_wav) behave as they
  do on real speech.

Every draw comes from an explicit `np.random.Generator`, so a bank is
bit-equal to the JAX package's for the same seed.

CLI:  python -m acousticswarms_speech_tpu_torch.data.voicegen <out_dir> \
          --n_speakers 50 --clips_per_speaker 12 --duration 4.0
"""
from __future__ import annotations

import argparse
import os

import numpy as np
from scipy.signal import lfilter

from ..constants import FS
from ..utils import write_wav

# Vowel formant targets (F1..F4, Hz) — canonical male values; scaled per
# speaker by the vocal-tract-length factor.
VOWELS = {
    "a": (730, 1090, 2440, 3400),
    "e": (530, 1840, 2480, 3500),
    "i": (270, 2290, 3010, 3700),
    "o": (570, 840, 2410, 3300),
    "u": (300, 870, 2240, 3400),
    "ae": (660, 1720, 2410, 3500),
    "er": (490, 1350, 1690, 3300),
    "uh": (520, 1190, 2390, 3400),
}
VOWEL_BW = (60.0, 90.0, 150.0, 250.0)  # formant bandwidths (Hz)

# Fricative noise bands (center Hz, bandwidth Hz, voiced?)
FRICATIVES = [
    (4500.0, 3000.0, False),   # s-like
    (2500.0, 2500.0, False),   # sh-like
    (1200.0, 1800.0, False),   # f-like
    (3500.0, 2800.0, True),    # z-like (voiced)
]


class SpeakerProfile:
    """Randomly drawn per-speaker identity parameters."""

    def __init__(self, rng: np.random.Generator):
        self.f0_base = float(rng.uniform(85.0, 255.0))
        self.f0_range = float(rng.uniform(0.15, 0.45))  # relative excursion
        # vocal-tract length scale: shorter tract -> higher formants
        self.formant_scale = float(rng.uniform(0.88, 1.22))
        self.breathiness = float(rng.uniform(0.01, 0.08))
        self.rate = float(rng.uniform(3.2, 5.2))  # syllables / second
        self.jitter = float(rng.uniform(0.004, 0.012))
        self.shimmer = float(rng.uniform(0.03, 0.10))
        self.vibrato_hz = float(rng.uniform(4.0, 6.5))
        self.vibrato_depth = float(rng.uniform(0.0, 0.02))


def _resonator_coeffs(f: np.ndarray, bw: float, fs: int):
    """Two-pole resonator (Klatt): per-sample time-varying coefficients."""
    r = np.exp(-np.pi * bw / fs)
    theta = 2.0 * np.pi * f / fs
    b1 = 2.0 * r * np.cos(theta)
    b2 = -r * r
    a0 = 1.0 - b1 - b2
    return a0, b1, b2


def _tv_resonator(x: np.ndarray, f_track: np.ndarray, bw: float, fs: int,
                  hop: int = 480) -> np.ndarray:
    """Time-varying resonator: piecewise-constant coefficients per 10 ms hop,
    filter state carried across hops (standard frame-wise Klatt practice)."""
    y = np.empty_like(x)
    zi = np.zeros(2)
    for s in range(0, len(x), hop):
        e = min(s + hop, len(x))
        a0, b1, b2 = _resonator_coeffs(float(f_track[s]), bw, fs)
        b = np.array([a0])
        a = np.array([1.0, -b1, -b2])
        y[s:e], zi = lfilter(b, a, x[s:e], zi=zi)
    return y


def _glottal_source(f0_track: np.ndarray, voiced: np.ndarray, fs: int,
                    rng: np.random.Generator, jitter: float, shimmer: float,
                    breathiness: float) -> np.ndarray:
    """LF-flavoured glottal flow derivative: per-period waveshaped phase with
    cycle-level jitter/shimmer, plus aspiration noise in open phases."""
    n = len(f0_track)
    out = np.zeros(n)
    # integrate instantaneous frequency -> phase; add jitter as random-walk
    # modulation of f0 at the pitch-period scale (approximated per 5 ms).
    jit = rng.normal(0.0, jitter, size=n // 240 + 1)
    jit = np.repeat(jit, 240)[:n]
    inst_f = f0_track * (1.0 + jit)
    phase = np.cumsum(inst_f / fs)
    frac = phase % 1.0
    # glottal flow derivative: -sin(pi*frac)^2 like open phase with a sharp
    # closure (negative spike) — differentiated Rosenberg pulse shape.
    open_q = 0.6
    op = frac < open_q
    pulse = np.where(op, np.sin(np.pi * frac / open_q) ** 2, 0.0)
    dpulse = np.diff(pulse, prepend=pulse[:1]) * fs / 200.0
    # shimmer: per-period amplitude modulation (cycle index ~ floor(phase))
    cyc = np.floor(phase).astype(np.int64)
    amp_per_cyc = 1.0 + rng.normal(0.0, shimmer, size=int(cyc.max()) + 2)
    dpulse = dpulse * amp_per_cyc[cyc]
    # aspiration noise strongest during the open phase
    asp = rng.normal(0.0, 1.0, n) * (0.3 + 0.7 * pulse) * breathiness * 8.0
    out = (dpulse + asp) * voiced
    return out


def _noise_band(n: int, center: float, bw: float, fs: int,
                rng: np.random.Generator) -> np.ndarray:
    x = rng.normal(0.0, 1.0, n)
    track = np.full(n, center)
    return _tv_resonator(x, track, bw, fs)


def _moving_average(x: np.ndarray, w: int) -> np.ndarray:
    """O(n) centered moving average via cumulative sum, edge-padded."""
    if w <= 1:
        return x
    pad = np.pad(x, (w // 2, w - w // 2), mode="edge")
    cs = np.cumsum(pad, dtype=np.float64)
    return ((cs[w:] - cs[:-w]) / w)[: len(x)]


def _smooth_steps(values: np.ndarray, lengths: np.ndarray, n: int,
                  fs: int, smooth_ms: float = 40.0) -> np.ndarray:
    """Piecewise-constant track from per-segment values, then moving-average
    smoothed (formant/f0 interpolation between targets)."""
    track = np.repeat(values, lengths)[:n]
    if len(track) < n:
        track = np.pad(track, (0, n - len(track)), mode="edge")
    w = max(int(fs * smooth_ms / 1000.0), 1)
    return _moving_average(track.astype(np.float64), w)


def synthesize_utterance(profile: SpeakerProfile, duration: float,
                         rng: np.random.Generator, fs: int = FS) -> np.ndarray:
    """One utterance of `duration` seconds for the given speaker."""
    n = int(round(duration * fs))
    vowel_keys = list(VOWELS)

    # --- build the segment plan: phrases of syllables separated by pauses --
    segs = []  # (kind, length_samples, payload)
    t = 0
    while t < n:
        # phrase of 3..9 syllables
        n_syl = int(rng.integers(3, 10))
        for _ in range(n_syl):
            syl_len = int(fs / profile.rate * rng.uniform(0.7, 1.4))
            # optional onset consonant (40%: plosive 15% / fricative 25%)
            u = rng.uniform()
            if u < 0.15:
                closure = int(fs * rng.uniform(0.02, 0.05))
                burst = int(fs * rng.uniform(0.008, 0.02))
                segs.append(("sil", closure, None))
                segs.append(("burst", burst, None))
                t += closure + burst
            elif u < 0.40:
                fric_len = int(fs * rng.uniform(0.05, 0.12))
                segs.append(("fric", fric_len,
                             FRICATIVES[rng.integers(len(FRICATIVES))]))
                t += fric_len
            # vowel nucleus (possibly a diphthong glide)
            v1 = vowel_keys[rng.integers(len(vowel_keys))]
            v2 = vowel_keys[rng.integers(len(vowel_keys))] \
                if rng.uniform() < 0.3 else v1
            segs.append(("vowel", syl_len, (v1, v2)))
            t += syl_len
            if t >= n:
                break
        pause = int(fs * rng.uniform(0.08, 0.35))
        segs.append(("sil", pause, None))
        t += pause

    # --- tracks ----------------------------------------------------------
    kinds = [s[0] for s in segs]
    lengths = np.array([s[1] for s in segs])
    total = int(lengths.sum())

    # voicing amplitude per segment with soft 15 ms edges
    voiced_amp = np.zeros(total)
    # formant tracks: start from neutral schwa, fill vowel targets
    f_vals = np.empty((len(segs), 4))
    neutral = np.array(VOWELS["uh"])
    pos = 0
    for i, (kind, ln, payload) in enumerate(segs):
        if kind == "vowel":
            v1, v2 = payload
            f_vals[i] = np.array(VOWELS[v1])
            # diphthong: second half drifts toward v2 — handled by placing
            # the mean target; the 40 ms smoother produces the glide
            f_vals[i] = 0.5 * (np.array(VOWELS[v1]) + np.array(VOWELS[v2]))
            voiced_amp[pos:pos + ln] = rng.uniform(0.75, 1.0)
        elif kind == "fric" and payload[2]:
            f_vals[i] = neutral
            voiced_amp[pos:pos + ln] = 0.4  # voiced fricative hum
        else:
            f_vals[i] = neutral
        pos += ln
    # soft edges on voicing (~15 ms)
    va = _moving_average(voiced_amp, max(int(fs * 0.015), 1))

    formants = np.stack(
        [_smooth_steps(f_vals[:, k] * profile.formant_scale, lengths, total,
                       fs) for k in range(4)], axis=0)

    # f0: phrase declination + per-syllable accents + vibrato
    f0_seg = np.array([
        profile.f0_base * (1.0 + profile.f0_range * rng.uniform(-0.5, 1.0))
        if k == "vowel" else profile.f0_base for k in kinds
    ])
    f0 = _smooth_steps(f0_seg, lengths, total, fs, smooth_ms=80.0)
    decl = np.linspace(1.06, 0.94, total)
    tt = np.arange(total) / fs
    vib = 1.0 + profile.vibrato_depth * np.sin(
        2 * np.pi * profile.vibrato_hz * tt)
    f0 = f0 * decl * vib

    # --- synthesis --------------------------------------------------------
    src = _glottal_source(f0, va, fs, rng, profile.jitter, profile.shimmer,
                          profile.breathiness)
    # cascade formant resonators
    y = src
    for k in range(4):
        y = _tv_resonator(y, formants[k], VOWEL_BW[k], fs)
    # radiation characteristic (first difference, mild)
    y = np.diff(y, prepend=y[:1]) + 0.15 * y

    # unvoiced segments: fricatives and bursts added on top
    pos = 0
    for kind, ln, payload in segs:
        if kind == "fric":
            c, bw, _ = payload
            band = _noise_band(ln, c * profile.formant_scale, bw, fs, rng)
            band *= np.std(y[np.abs(y) > 0][:48000] if np.any(y) else [1.0])
            env = np.hanning(ln) ** 0.5 if ln > 1 else np.ones(ln)
            y[pos:pos + ln] += band * env * 0.8
        elif kind == "burst":
            burst = rng.normal(0.0, 1.0, ln)
            burst = _tv_resonator(burst, np.full(ln, 2000.0 *
                                                 profile.formant_scale),
                                  3000.0, fs, hop=ln)
            env = np.exp(-np.linspace(0, 6, ln))
            scale = np.std(y) if np.std(y) > 0 else 1.0
            y[pos:pos + ln] += burst * env * 2.0 * scale
        pos += ln

    y = y[:n]
    if len(y) < n:
        y = np.pad(y, (0, n - len(y)))
    peak = np.abs(y).max()
    if peak > 0:
        y = y / peak * 0.45
    return y.astype(np.float32)


def generate_voice_bank(out_dir: str, n_speakers: int = 50,
                        clips_per_speaker: int = 12, duration: float = 4.0,
                        fs: int = FS, seed: int = 0) -> None:
    """VCTK-layout bank: <out_dir>/spkNN/clipK.wav (mono, 16-bit)."""
    master = np.random.default_rng(seed)
    for s in range(n_speakers):
        prof = SpeakerProfile(np.random.default_rng(master.integers(2**63)))
        spk_dir = os.path.join(out_dir, f"spk{s:03d}")
        os.makedirs(spk_dir, exist_ok=True)
        for c in range(clips_per_speaker):
            rng = np.random.default_rng(master.integers(2**63))
            y = synthesize_utterance(prof, duration, rng, fs)
            write_wav(os.path.join(spk_dir, f"clip{c}.wav"), y, fs)
        print(f"[voicegen] speaker {s + 1}/{n_speakers} done", flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("out_dir")
    p.add_argument("--n_speakers", type=int, default=50)
    p.add_argument("--clips_per_speaker", type=int, default=12)
    p.add_argument("--duration", type=float, default=4.0)
    p.add_argument("--sr", type=int, default=FS)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args()
    generate_voice_bank(a.out_dir, a.n_speakers, a.clips_per_speaker,
                        a.duration, a.sr, a.seed)


if __name__ == "__main__":
    main()
