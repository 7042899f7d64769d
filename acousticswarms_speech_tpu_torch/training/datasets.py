"""Training datasets: localization (pos/neg/hard-negative sampling) and
separation (per-speaker shifted stacks with drop/add augmentation).

Host NumPy, copied from the JAX package's `training/datasets.py` for the
PyTorch port (the port imports nothing of that package).  WAVs are read
with the port's `utils/audio.py`; the JAX package's optional native WAV
loader is not used.

Counterpart of reference sep/training/base_dataset.py,
SpeakerLocalization/dataset.py and SpeakerSeparation/dataset.py.  Samples
are numpy arrays; `BatchLoader` provides shuffling, fixed batching and a
background prefetch thread (the reference used torch DataLoader worker
processes).
"""
from __future__ import annotations

import json
import os
import queue
import random
import threading
from pathlib import Path

import numpy as np

from ..constants import (
    CHANNELS_PER_MIC,
    CODEC_FRAME_DURATION_S,
    MAX_SHIFTS,
    MAX_SPEAKER_RELATIVE_HEIGHT,
    NEG_SAMPLE_INITIAL_CANDIDATES,
    ROOM_DIM,
)
from ..runtime import native
from ..utils import (
    get_shift_vector,
    powerlaw_psd_gaussian,
    read_audio_file,
    shift_crop_given_samples,
    shift_mixture_given_samples,
    to_categorical,
)
from ..utils.codec import OpusCodec


# In-RAM decoded-WAV cache: a 3 s corpus epoch re-reads every scene's wavs
# (7 mixture channels + GT voices); at reference scale that is ~15 GB of
# repeated disk IO + WAV parsing per epoch on a single host core.  Cached
# arrays are never mutated by consumers (shift/perturb copy; the GT path
# returns a copy).  Cap via ACOUSTIC_WAV_CACHE_MB (0 disables).
_WAV_CACHE: dict = {}
_WAV_CACHE_STATE = {"bytes": 0}
_WAV_CACHE_LIMIT = float(os.environ.get("ACOUSTIC_WAV_CACHE_MB",
                                        "20000")) * 1e6


def _cache_put(key, arr: np.ndarray) -> np.ndarray:
    if _WAV_CACHE_STATE["bytes"] + arr.nbytes <= _WAV_CACHE_LIMIT:
        _WAV_CACHE[key] = arr
        _WAV_CACHE_STATE["bytes"] += arr.nbytes
    return arr


def _cached_voice(path: str, sr) -> np.ndarray:
    """GT voice read with caching; returns a private copy (the codec
    augmentation mutates its target in place)."""
    arr = _WAV_CACHE.get(path)
    if arr is None:
        arr = _cache_put(path, read_audio_file(path, sr))
    return arr.copy()


def _load_mixture(curr_dir, mics) -> np.ndarray:
    """All mixture channels of a sample, (M, T), through the WAV cache, read
    by the native parallel WAV loader (runtime/native.py)."""
    key = (str(curr_dir), tuple(mics))
    cached = _WAV_CACHE.get(key)
    if cached is not None:
        return cached
    paths = [str(os.path.join(curr_dir, m)) + "_mixed.wav" for m in mics]
    first = native.load_wav(paths[0])
    return _cache_put(key, native.load_wavs(paths, len(first)))


class BaseDataset:
    def __init__(self, input_dir, dataset_type, sr, compression_prob,
                 max_white_noise_variance=1e-3, max_pink_noise_variance=5e-3):
        # An interrupted generator can leave a scene dir without its
        # metadata.json (wavs are written after it); listing only complete
        # scenes keeps training alive across partial corpus writes.
        self.dirs = sorted(
            d for d in Path(input_dir).glob("[0-9]*")
            if (d / "metadata.json").exists())
        self.dataset_type = dataset_type
        self.sr = sr
        if dataset_type == "train":
            self.training = True
            self.perturb_prob = 1
            self.compression_prob = compression_prob
        else:
            self.training = False
            self.perturb_prob = 0
            # validation: codec always applied iff it can appear in training
            self.compression_prob = float(abs(compression_prob) > 1e-6)
        if self.compression_prob > 0:
            self.codec = OpusCodec(CHANNELS_PER_MIC, sr, CODEC_FRAME_DURATION_S)
        self.max_white_noise_variance = max_white_noise_variance
        self.max_pink_noise_variance = max_pink_noise_variance
        # When True, the training loop applies the noise augmentation on
        # the device inside the train step (train._device_perturb) and the
        # host perturb_audio is skipped here.
        self.perturb_on_device = False

    def __len__(self):
        return len(self.dirs)

    # -- negative-region sampling (base_dataset.py:52-200) -----------------
    def _voice_sample_offsets(self, metadata):
        real_sample = metadata.get("real", False)
        voices = [x for x in metadata if "voice" in x]
        mic_positions = np.array(
            [metadata[x]["position"] for x in metadata if "mic" in x]
        )
        offsets = np.zeros((len(voices), mic_positions.shape[0]))
        if real_sample:
            for i, voice in enumerate(voices):
                shift = np.array(metadata[voice]["shifts"], dtype=np.float64)
                shift -= shift[0]
                offsets[i] = -shift
        else:
            for i, voice in enumerate(voices):
                pos = np.array(metadata[voice]["position"])
                offsets[i] = get_shift_vector(pos, mic_positions, self.sr)
        return offsets, mic_positions

    def get_points_outside_patch_union(self, candidate_points,
                                       voice_sample_offsets, mic_positions,
                                       window_condition):
        remaining_shifts, valid_points, distances = [], [], []
        for candidate in candidate_points:
            cand_off = get_shift_vector(candidate, mic_positions, self.sr)
            diff = np.abs(voice_sample_offsets - cand_off)
            closest = np.min(np.max(diff, axis=1))
            if closest > MAX_SHIFTS[window_condition] + 1:
                remaining_shifts.append(cand_off)
                valid_points.append(candidate)
                distances.append(np.min(np.linalg.norm(diff, ord=1, axis=1)))
        return remaining_shifts, distances, valid_points

    def get_negative_region(self, metadata, window_condition):
        voice_offsets, mic_positions = self._voice_sample_offsets(metadata)
        lx = np.min(mic_positions[:, 0]) - ROOM_DIM
        ux = np.max(mic_positions[:, 0]) + ROOM_DIM
        ly = np.min(mic_positions[:, 1]) - ROOM_DIM
        uy = np.max(mic_positions[:, 1]) + ROOM_DIM

        candidate_shifts = []
        while len(candidate_shifts) == 0:
            npts = NEG_SAMPLE_INITIAL_CANDIDATES
            pts = [np.random.uniform(lx, ux, npts),
                   np.random.uniform(ly, uy, npts)]
            if mic_positions.shape[1] == 3:
                pts.append(np.random.uniform(0, MAX_SPEAKER_RELATIVE_HEIGHT, npts))
            pts = np.array(pts).T
            candidate_shifts, distances, valid_points = \
                self.get_points_outside_patch_union(
                    pts, voice_offsets, mic_positions, window_condition
                )
        p = np.array([np.min(1 / d) for d in distances])
        p /= p.sum()
        idx = np.random.choice(len(candidate_shifts), p=p)
        return candidate_shifts[idx], valid_points[idx]

    def get_negative_region_srp(self, metadata, window_condition, negative_list):
        """SRP-mined hard negatives (base_dataset.py:85-135)."""
        voice_offsets, _ = self._voice_sample_offsets(metadata)
        patch_width = MAX_SHIFTS[window_condition]
        while True:
            challenge = negative_list[np.random.choice(len(negative_list))]
            random_shift = -np.array([0] + list(challenge), dtype=np.float64)
            random_shift[1:] += np.random.choice([-2, -1, 0, 1, 2],
                                                 len(random_shift) - 1)
            ok = True
            for i in range(voice_offsets.shape[0]):
                if np.amax(np.abs(voice_offsets[i] - random_shift)) <= patch_width + 1:
                    ok = False
                    break
            if ok:
                return random_shift, None

    # -- augmentations (base_dataset.py:202-239) ---------------------------
    def perturb_audio(self, input_audio: np.ndarray) -> np.ndarray:
        # float32 throughout: this runs per sample in the single-core data
        # prep loop; float64 legacy-RNG noise was the measured bottleneck
        # (780 of 830 ms per item).
        rng = np.random.default_rng(np.random.randint(2 ** 31))
        pink_level = self.max_pink_noise_variance * np.random.rand()
        pink = np.float32(pink_level) * powerlaw_psd_gaussian(
            1, input_audio.shape, random_state=rng
        )
        white_level = self.max_white_noise_variance * np.random.rand()
        white = np.float32(white_level) * rng.standard_normal(
            input_audio.shape, dtype=np.float32)
        return input_audio.astype(np.float32, copy=False) + white + pink

    def apply_codec(self, shifted_vector, target_voice_data):
        for i in range(shifted_vector.shape[0]):
            shifted_vector[i] = self.codec.apply(shifted_vector[i])
        for i in range(target_voice_data.shape[0]):
            target_voice_data[i] = self.codec.apply(target_voice_data[i])
        return shifted_vector, target_voice_data


class LocalizationDataset(BaseDataset):
    """Pos/neg spotforming training samples with window conditioning
    (reference: SpeakerLocalization/dataset.py)."""

    def __init__(self, dataset_type, input_dir, n_mics=7, sr=48000,
                 negatives=0.3, max_white_noise_variance=1e-3,
                 max_pink_noise_variance=5e-3, compression_prob=0.7,
                 fixed_window_condition=-1, challenge_ratio=0.8,
                 use_dereverb=False, use_denoised=False, scale_neg_prob=False):
        super().__init__(input_dir, dataset_type, sr, compression_prob,
                         max_white_noise_variance, max_pink_noise_variance)
        self.n_mics = n_mics
        self.window_condition = fixed_window_condition
        self.negatives = negatives
        self.challenge_ratio = challenge_ratio
        self.scale_neg_prob = scale_neg_prob
        self.dereverb = use_dereverb
        self.use_denoised = use_denoised

    def __getitem__(self, idx):
        curr_dir = self.dirs[idx % len(self.dirs)]
        with open(Path(curr_dir) / "metadata.json") as f:
            metadata = json.load(f)
        real_sample = metadata.get("real", False)
        if not real_sample:
            for key in metadata:
                if key.startswith("voice"):
                    metadata[key]["shifts"] = [0] + metadata[key]["shifts"]

        if self.window_condition < 0:
            window_condition = np.random.randint(2)
        else:
            window_condition = self.window_condition
        width_embedding = to_categorical(window_condition, 2)

        challenge_path = Path(curr_dir) / "challeng_sample.json"
        srp_false_positives = []
        if challenge_path.exists():
            with open(challenge_path) as f:
                srp_false_positives = json.load(f)["negative_sample"]

        if self.scale_neg_prob:
            num_speakers = len([k for k in metadata if "voice" in k])
            fp_per_spk = len(srp_false_positives) / max(num_speakers, 1)
            neg_prob = float(np.clip(
                (0.5 - 0.3) / (14 - 6) * fp_per_spk + 0.15, 0.2, 0.5
            ))
        else:
            neg_prob = self.negatives

        if np.random.uniform() < neg_prob:
            use_challenging = False
            if np.random.uniform() < self.challenge_ratio and srp_false_positives:
                target_shift, _ = self.get_negative_region_srp(
                    metadata, window_condition, srp_false_positives
                )
                use_challenging = True
            if not use_challenging:
                target_shift, _ = self.get_negative_region(
                    metadata, window_condition
                )
            pos = False
        else:
            target_shift = self.get_positive_region(metadata, window_condition)
            pos = True

        all_sources, target = self.get_mixture_and_gt(
            metadata, curr_dir, target_shift, window_condition, pos
        )
        if pos:
            assert (target > 0).any()
        else:
            assert (target == 0).all()
        return (all_sources.astype(np.float32), target.astype(np.float32),
                width_embedding.astype(np.float32))

    def get_positive_region(self, metadata, window_condition):
        real_sample = metadata.get("real", False)
        voice_keys = [x for x in metadata if "voice" in x]
        voice = random.choice(voice_keys)
        shifts = np.array(metadata[voice]["shifts"], dtype=np.int64)
        shifts = -(shifts - shifts[0])
        if not real_sample and self.training:
            shifts = shifts + np.random.randint(
                -MAX_SHIFTS[window_condition], MAX_SHIFTS[window_condition] + 1,
                size=shifts.shape[-1],
            )
            shifts[0] = 0
        return shifts

    def get_mixture_and_gt(self, metadata, curr_dir, target_shift,
                           window_condition, pos=True):
        real_sample = metadata.get("real", False)
        voices = [k for k in metadata if "voice" in k]
        mics = [k for k in metadata if "mic" in k]

        mixture = _load_mixture(curr_dir, mics)
        target_shift = np.round(np.asarray(target_shift)).astype(np.int32)
        shifted_vector, shifts = shift_mixture_given_samples(mixture,
                                                             target_shift)
        assert shifts[0] == 0

        target_voice_data = np.zeros((1, shifted_vector.shape[-1]))
        included = []
        for i, voice in enumerate(voices):
            vshift = np.array(metadata[voice]["shifts"], dtype=np.float64)
            vshift = -(vshift - vshift[0])
            dist = np.linalg.norm(vshift - target_shift, ord=np.inf)
            if dist <= MAX_SHIFTS[window_condition]:
                included.append((dist, i))
        included.sort(key=lambda x: x[0])

        if included:
            voice = voices[included[0][1]]
            if self.use_denoised:
                denoised = os.path.join(curr_dir,
                                        f"{mics[0]}_{voice}_denoised.wav")
                path = denoised if os.path.exists(denoised) else \
                    os.path.join(curr_dir, f"{mics[0]}_{voice}.wav")
            else:
                suffix = "_dereverb" if self.dereverb else ""
                path = os.path.join(curr_dir, f"{mics[0]}_{voice}{suffix}.wav")
            target_voice_data = _cached_voice(path, self.sr)

        if self.training and not self.perturb_on_device:
            shifted_vector = self.perturb_audio(shifted_vector)
        if (not real_sample) and (np.random.random() < self.compression_prob):
            shifted_vector, target_voice_data = self.apply_codec(
                shifted_vector, target_voice_data
            )
        return shifted_vector, target_voice_data


class SeparationDataset(BaseDataset):
    """Per-speaker shifted mixture stacks with drop/add augmentation
    (reference: SpeakerSeparation/dataset.py)."""

    def __init__(self, input_dir, dataset_type, n_mics=7, n_speakers=5,
                 sr=48000, compression_prob=0.7, max_white_noise_variance=1e-3,
                 max_pink_noise_variance=5e-3, speaker_drop_prob=0.1,
                 speaker_add_prob=0.1, crop_seconds=0.0):
        super().__init__(input_dir, dataset_type, sr, compression_prob,
                         max_white_noise_variance, max_pink_noise_variance)
        self.n_mics = n_mics
        self.n_speakers = n_speakers
        self.speaker_drop_prob = speaker_drop_prob
        self.speaker_add_prob = speaker_add_prob
        # Optional fixed-length crop: the networks are fully convolutional
        # over T, so training on shorter random crops (deterministic center
        # crop for validation) trades conformer context for activation
        # memory — it lets full-width SepNet train on long scenes within one
        # chip's HBM while inference still runs the full mixture.
        self.crop_seconds = crop_seconds

    def __getitem__(self, idx):
        curr_dir = self.dirs[idx % len(self.dirs)]
        sources, target, num = self.get_mixture_and_gt(curr_dir)
        return sources.astype(np.float32, copy=False), \
            target.astype(np.float32, copy=False), num

    def get_mixture_and_gt(self, curr_dir):
        with open(os.path.join(curr_dir, "metadata.json")) as f:
            metadata = json.load(f)
        real_sample = metadata.get("real", False)
        voices = [k for k in metadata if "voice" in k]

        if self.training:
            random.shuffle(voices)
            if random.random() < self.speaker_drop_prob:
                voices.pop()
                random.shuffle(voices)
            if len(voices) < self.n_speakers and \
                    random.random() < self.speaker_add_prob:
                fake_shifts, fake_pos = self.get_negative_region(metadata, 1)
                metadata["fake_voice"] = dict(
                    position=(None if fake_pos is None else list(fake_pos)),
                    shifts=list(-np.asarray(fake_shifts)),
                )
                voices.append("fake_voice")
                random.shuffle(voices)

        mics = [k for k in metadata if "mic" in k]
        mic_positions = np.array([metadata[k]["position"] for k in mics])
        mixture = _load_mixture(curr_dir, mics)

        # Crop selection happens BEFORE shifting so the per-speaker shifted
        # stack, the noise perturbation and the codec all run at the crop
        # length, not the full scene length (at 1.5 s crops of 3 s scenes
        # that halves the dominant per-item host cost; shift_crop reads the
        # window straight out of the full signal).
        T = mixture.shape[1]
        tc = int(self.crop_seconds * self.sr) if self.crop_seconds else 0
        if tc and T > tc:
            start = (np.random.randint(0, T - tc + 1) if self.training
                     else (T - tc) // 2)
        else:
            start, tc = 0, T

        shifted_vector = np.zeros((self.n_mics * self.n_speakers, tc),
                                  dtype=np.float32)
        target_voice_data = np.zeros((self.n_speakers, tc), dtype=np.float32)
        assert len(voices) <= self.n_speakers

        for i, voice in enumerate(voices):
            if voice == "fake_voice":
                gt = None
            else:
                denoised = os.path.join(curr_dir,
                                        f"{mics[0]}_{voice}_denoised.wav")
                path = denoised if os.path.exists(denoised) else \
                    os.path.join(curr_dir, f"{mics[0]}_{voice}.wav")
                gt = _cached_voice(path, self.sr)

            if real_sample or voice == "fake_voice":
                vshift = np.array(metadata[voice]["shifts"], dtype=np.float64)
                vshift = -(vshift - vshift[0])
            else:
                vshift = get_shift_vector(
                    np.array(metadata[voice]["position"]), mic_positions,
                    self.sr,
                )
            if self.training and not real_sample:
                pert = np.random.randint(-MAX_SHIFTS[0], MAX_SHIFTS[0] + 1,
                                         size=vshift.shape[-1])
                pert[0] = 0
                vshift = vshift + pert

            shifted_vector[i * self.n_mics:(i + 1) * self.n_mics] = \
                shift_crop_given_samples(
                    mixture, np.asarray(vshift).astype(np.int32), start, tc)
            if gt is not None:
                target_voice_data[i] = gt[0, start : start + tc]

        if self.training and not self.perturb_on_device:
            shifted_vector = self.perturb_audio(shifted_vector)
        if (not real_sample) and (np.random.random() < self.compression_prob):
            shifted_vector, target_voice_data = self.apply_codec(
                shifted_vector, target_voice_data
            )
        return shifted_vector, target_voice_data, len(voices)


class BatchLoader:
    """Minimal shuffling batch loader with one background prefetch thread
    (replaces torch DataLoader, reference train.py:90-106)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, prefetch: int = 2, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.prefetch = prefetch
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        self.epoch += 1

        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            try:
                for b in batches:
                    items = [self.dataset[int(i)] for i in b]
                    cols = list(zip(*items))
                    out = tuple(
                        np.stack(c) if isinstance(c[0], np.ndarray)
                        else np.asarray(c)
                        for c in cols
                    )
                    q.put(out)
                q.put(stop)
            except BaseException as e:  # propagate instead of hanging q.get
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
