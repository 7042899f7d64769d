"""The traffic generator: one general generator that reads a traffic mix's
parameters (`benchmark/traffic/<name>.json`) and makes a pool of distinct
mixtures, rendered on the device.

The mixtures come from the mix's own `seed`, not the run's: the work of a
mixture depends on what it holds (its SRP peaks set how many candidates
the search sweeps), and not only on its scene: on an H100, re-mixes of
the same scenes drawn from the run's seed made forwards of 5.5-13.8 s
where this pool's take 7.7-12.2 s, and the rate a draw of the seed.
Every run sees the same mixtures in the same order; the run's seed draws
which of them the reference checks.

A mix file's keys:
- `seed`: draws the voices, the scenes and the re-mixes;
- `layout`: "fixed" (every mixture is recorded by the configuration's own
  array, `array` in its file) or "per_mixture" (every mixture comes with a
  table layout of its own, drawn by the dataset generator's desk rules:
  the swarm redeploys between recordings);
- `talkers`, `seconds`: talkers per scene and the length of a mixture;
- `scenes`: scenes rendered in set-up (for "per_mixture", one per mixture);
- `voices`: utterances synthesized for the run, each scene drawing its
  talkers from them without repeats;
- `pool`: mixtures made, the warm-up's first; `warmup`: mixtures the
  warm-up takes.
Every mix shares the room (`ROOM`, `ABSORPTION`, `MAX_ORDER`: bench.py's)
and the re-mix gains (`GAIN_DB`).

A scene is rendered on the device once: each talker's spatial image at
every microphone.  Mixture i is a re-mix of scene i mod `scenes`: each
talker gets a gain and a circular time offset, the same offset on every
microphone, so the spatial cues stay while what overlaps with what
changes, as successive windows of one meeting do.  No two mixtures of a
pool are equal, and `Pool.take` fails past the end of the pool: a run
never gives a mixture twice.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from . import layouts
from .room import ShoeBox
from .voices import SpeakerProfile, synthesize_utterance

FS = 48000
VOICE_PEAK = 0.7  # each utterance's peak before the room, as bench.py's scene
ROOM = (7.0, 6.0, 2.3)  # bench.py's shoebox room [x, y, z] m
ABSORPTION = 0.6
MAX_ORDER = 6
GAIN_DB = (-3.0, 3.0)  # a talker's gain in a re-mix


def load(name: str) -> dict:
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           f"{name}.json")) as f:
        return json.load(f)


class Pool:
    """Distinct mixtures, each with its array and search range (ROI)."""

    def __init__(self, mixes, mic_positions, rois, warmup: int):
        self.mixes = mixes            # list of (M, T) float32 arrays
        self.mic_positions = mic_positions
        self.rois = rois
        self.warmup = warmup

    def __len__(self) -> int:
        return len(self.mixes)

    def take(self, i: int):
        """(mixture, mic positions, ROI) of mixture `i` of the pool."""
        if i >= len(self.mixes):
            raise RuntimeError(f"the traffic pool of {len(self.mixes)} "
                               f"mixtures is exhausted: a run never repeats "
                               f"a mixture; make the pool larger")
        return self.mixes[i], self.mic_positions[i], self.rois[i]


def _talkers_in_box(n: int, mic_positions: np.ndarray, roi, rng):
    """`n` talker positions in the ROI shrunk by 0.1 m (the dataset
    generator's ROI is its talker box grown by 0.1 m), outside the array's
    keepout box, at the dataset generator's minimum spacing."""
    lo = np.array([roi[0], roi[2], roi[4]]) + 0.1
    hi = np.array([roi[1], roi[3], roi[5]]) - 0.1
    keep_lo = mic_positions[:, :2].min(axis=0) - 0.25
    keep_hi = mic_positions[:, :2].max(axis=0) + 0.25
    out = []
    for _ in range(n):
        for _attempt in range(1000):
            pos = lo + (hi - lo) * rng.random_sample(3)
            if np.all((pos[:2] >= keep_lo) & (pos[:2] <= keep_hi)):
                continue
            if all(np.linalg.norm(p - pos) >= layouts.MIN_SPEAKER_DIST
                   for p in out):
                break
        else:
            raise RuntimeError("could not place the talkers in the ROI")
        out.append(pos)
    return np.array(out)


def _render(mic_positions: np.ndarray, talkers: np.ndarray, voices: list,
            T: int, device) -> np.ndarray:
    """(S, M, T) float32 spatial images of the talkers at every mic."""
    room = ShoeBox(list(ROOM), fs=FS, max_order=MAX_ORDER,
                   absorption=ABSORPTION, device=device)
    room.add_microphone_array(np.asarray(mic_positions).T)
    for pos, x in zip(talkers, voices):
        room.add_source(pos, x)
    premix = room.simulate(return_premix=True)[:, :, :T]
    return premix.astype(np.float32)


def make_pool(traffic: dict, config: dict, device) -> Pool:
    """The pool of distinct mixtures of the mix, from its `seed`."""
    seq = np.random.SeedSequence(traffic["seed"])
    voice_seq, scene_seq, mix_seq = seq.spawn(3)
    T = int(round(traffic["seconds"] * FS))
    n_mics = config["n_mics"]

    voices = []
    for s in voice_seq.spawn(traffic["voices"]):
        prof_rng, utt_rng = (np.random.default_rng(x) for x in s.spawn(2))
        x = synthesize_utterance(SpeakerProfile(prof_rng), traffic["seconds"],
                                 utt_rng, FS)
        voices.append(x / max(float(np.abs(x).max()), 1e-6) * VOICE_PEAK)

    scene_rng = np.random.RandomState(np.random.MT19937(scene_seq))
    if traffic["layout"] == "per_mixture" and traffic["scenes"] < traffic["pool"]:
        raise ValueError("a per_mixture mix renders one scene per mixture")
    images, arrays, rois = [], [], []
    for _ in range(traffic["scenes"]):
        if traffic["layout"] == "fixed":
            mics = np.asarray(config["array"]["mic_positions"], np.float64)
            roi = list(config["array"]["roi"])
            talkers = _talkers_in_box(traffic["talkers"], mics, roi,
                                      scene_rng)
        elif traffic["layout"] == "per_mixture":
            mics, _, wall = layouts.get_random_mic_positions_desk(
                n_mics, 0, ROOM[0], 0, ROOM[1], scene_rng)
            talkers, _, roi = layouts.get_random_speaker_positions(
                traffic["talkers"], mics, wall, 0, ROOM[0], ROOM[1], 0,
                scene_rng)
            talkers = np.asarray(talkers)
            roi = [float(x) for x in roi]
        else:
            raise ValueError(f"unknown layout {traffic['layout']!r}")
        if mics.shape[0] != n_mics:
            raise ValueError(f"the array has {mics.shape[0]} mics, the "
                             f"configuration {n_mics}")
        pick = scene_rng.choice(len(voices), traffic["talkers"], replace=False)
        images.append(_render(mics, talkers,
                              [voices[k] for k in pick], T, device))
        arrays.append(mics)
        rois.append(roi)

    mix_rng = np.random.default_rng(mix_seq)
    lo, hi = GAIN_DB
    mixes, seen = [], set()
    mic_list, roi_list = [], []
    for i in range(traffic["pool"]):
        k = i % len(images)
        img = images[k]
        gains = 10.0 ** (mix_rng.uniform(lo, hi, img.shape[0]) / 20.0)
        offsets = mix_rng.integers(0, T, img.shape[0])
        mix = np.zeros(img.shape[1:], np.float32)
        for s in range(img.shape[0]):
            mix += np.float32(gains[s]) * np.roll(img[s], int(offsets[s]),
                                                  axis=-1)
        key = hashlib.sha256(mix.tobytes()).hexdigest()
        if key in seen:
            raise RuntimeError(f"mixture {i} repeats an earlier one")
        seen.add(key)
        mixes.append(mix)
        mic_list.append(arrays[k])
        roi_list.append(rois[k])
    return Pool(mixes, mic_list, roi_list, traffic["warmup"])
