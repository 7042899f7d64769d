"""Synthetic dataset generator: random rooms, desk-edge robot swarms,
speakers with keepout, image-source simulation, per-mic GT + mixtures
(JAX package: data/generate_dataset.py).

The scene sampling is the JAX package's, with one change: every draw comes
from an explicit `np.random.RandomState` passed to each sampling function,
where the JAX package draws from the global state seeded once in `main()`.
`RandomState(s)` gives the stream `np.random.seed(s)` gives, and the draws
come in the same order, so a scene equals the JAX package's for the same
seed.  The room render runs on the device of `--device` (data/roomsim.py).

- random room 6-8 m x 6-8 m x 2-2.5 m; absorption U(0.1, 0.99) or sampled
  rt60 U(0.08, 0.7) via inverse Sabine
- desk placed against a random wall; robots expand from the desk center to
  its edges with angle/extent perturbations
- speakers in a wall-dependent ROI with desk keepout and a minimum speaker
  separation
- per-mic GT images, mixture wavs and metadata.json in the reference schema
- optional colocated (Echo-Dot-style) circular-array variant

CLI:  python -m acousticswarms_speech_tpu_torch.data.generate_dataset \
          <voice_dir> <output_path> [--device cpu] ...
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from pathlib import Path

import numpy as np

from ..constants import FS, SPEED_OF_SOUND
from ..utils import write_wav
from ..utils.audio import read_wav
from .roomsim import ShoeBox, inverse_sabine

# Scene constants (reference: generate_dataset.py:18-63)
FG_VOL_MIN, FG_VOL_MAX = 0.2, 0.5
MAX_SPEAKER_HEIGHT, MIN_SPEAKER_HEIGHT = 0.7, 0.1
MIN_SPEAKER_DIST = 0.51
MIC_HEIGHT = 0.02
MIN_ABSORPTION, MAX_ABSORPTION = 0.1, 0.99
ROOM_LENGTH_MIN, ROOM_LENGTH_MAX = 6, 8
ROOM_WIDTH_MIN, ROOM_WIDTH_MAX = 6, 8
CEIL_MIN, CEIL_MAX = 2, 2.5
DESK_LENGTH_MIN, DESK_LENGTH_MAX = 1.2, 2
DESK_WIDTH_MIN, DESK_WIDTH_MAX = 0.6, 1.2
WALL_KEEPOUT = 0.5
SPK_RANGE_W, SPK_RANGE_H = 3, 4.5
EXPAND_MAX_DEV = 0.08
THETA_MAX_DEV = np.deg2rad(6)
ECHO_DOT_DIAMETER = 0.1


def point_in_box(pos, left, right, top, bottom):
    return left <= pos[0] <= right and bottom <= pos[1] <= top


def is_valid_mic_array(array, left, right, bottom, top, threshold=0.06):
    return bool(np.all(
        (array[:, 0] > left + threshold) & (array[:, 0] < right - threshold)
        & (array[:, 1] > bottom + threshold) & (array[:, 1] < top - threshold)
    ))


# Three-desks variant: fixed (length, width) sampling ranges per desk size
# (reference: generate_dataset.py:160-171)
THREE_DESK_SIZES = (
    ("large", (1.9, 2.0), (1.1, 1.2)),
    ("middle", (1.4, 1.5), (0.8, 0.9)),
    ("small", (1.0, 1.1), (0.5, 0.6)),
)


def _desk_expansion(n_mics, desk_length, desk_width, rng):
    """Desk-local robot coordinates: mic 0 at the desk center, the others
    expanded toward the desk edges over a half-circle of headings with angle
    and landing perturbations (reference: :176-244)."""
    middle_angle = np.arctan(desk_length / 2 / desk_width)
    angle_list = np.linspace(0, np.pi, n_mics - 1) - np.pi / 2
    mic_positions = np.zeros((n_mics, 2))
    for i in range(n_mics - 1):
        move_angle = angle_list[i] + rng.uniform(-THETA_MAX_DEV,
                                                       THETA_MAX_DEV)
        if -middle_angle < move_angle < middle_angle:
            expand_r = desk_width / np.cos(move_angle)
        elif move_angle > middle_angle:
            expand_r = desk_length / 2 / np.sin(move_angle)
        else:
            expand_r = desk_length / 2 / np.sin(-move_angle)
        expand_r -= 0.04  # robot backoff
        mic_positions[i + 1] = [
            expand_r * np.cos(move_angle)
            + rng.uniform(-EXPAND_MAX_DEV, EXPAND_MAX_DEV),
            expand_r * np.sin(move_angle)
            + rng.uniform(-EXPAND_MAX_DEV, EXPAND_MAX_DEV),
        ]
    return mic_positions


def get_random_mic_positions_desk(n_mics, left, right, bottom, top, rng,
                                  dimensions=3):
    """Desk-edge robot expansion geometry (reference: :341-475)."""
    for _ in range(200):
        desk_length = rng.uniform(DESK_LENGTH_MIN, DESK_LENGTH_MAX)
        desk_width = rng.uniform(DESK_WIDTH_MIN, DESK_WIDTH_MAX)
        mic_positions = _desk_expansion(n_mics, desk_length, desk_width, rng)

        cx, cy, theta, pickup_wall = _place_on_wall(desk_length, left, right,
                                                    bottom, top, rng)
        rot = np.array([[np.cos(theta), np.sin(theta)],
                        [-np.sin(theta), np.cos(theta)]])
        mic_positions = mic_positions @ rot + np.array([cx, cy])

        if is_valid_mic_array(mic_positions, left, right, bottom, top):
            if dimensions == 3:
                mic_positions = np.concatenate(
                    [mic_positions,
                     MIC_HEIGHT * np.ones((n_mics, 1))], axis=1)
            return mic_positions, [desk_length, desk_width], int(pickup_wall)
    raise RuntimeError("could not place a valid mic array")


def _place_on_wall(desk_length, left, right, bottom, top, rng):
    """Pick a wall and a desk-center pose against it: distance to the picked
    wall <= 35 cm, >= 1.8 m to the side walls, rotation bounded by pi/8 and
    shrunk so the desk stays in-room (reference: :253-319)."""
    DESK_WALL_MIN_DIST, DIS_WALL_DESK, DIS_WALL_DESK2 = 0.1, 0.35, 1.8
    MAX_ROT = np.pi / 8
    min_x, max_x = left + DESK_WALL_MIN_DIST, right - DESK_WALL_MIN_DIST
    min_y, max_y = bottom + DESK_WALL_MIN_DIST, top - DESK_WALL_MIN_DIST
    pickup_wall = rng.choice(4)

    def rot_range(margin):
        if margin >= desk_length / 2:
            return MAX_ROT
        bound = np.arcsin(max(margin, 0) / (desk_length / 2))
        return min(bound, MAX_ROT)

    if pickup_wall == 0:
        cx = rng.uniform(min_x, min_x + DIS_WALL_DESK)
        cy = rng.uniform(min_y + DIS_WALL_DESK2, max_y - DIS_WALL_DESK2)
        r = rot_range(cx - min_x)
        theta = rng.uniform(-r, r)
    elif pickup_wall == 1:
        cx = rng.uniform(min_x + DIS_WALL_DESK2, max_x - DIS_WALL_DESK2)
        cy = rng.uniform(min_y, min_y + DIS_WALL_DESK)
        r = rot_range(cy - min_y)
        theta = rng.uniform(-r, r) + np.pi / 2
    elif pickup_wall == 2:
        cx = rng.uniform(max_x - DIS_WALL_DESK, max_x)
        cy = rng.uniform(min_y + DIS_WALL_DESK2, max_y - DIS_WALL_DESK2)
        r = rot_range(max_x - cx)
        theta = rng.uniform(-r, r) + np.pi
    else:
        cx = rng.uniform(min_x + DIS_WALL_DESK2, max_x - DIS_WALL_DESK2)
        cy = rng.uniform(max_y - DIS_WALL_DESK, max_y)
        r = rot_range(max_y - cy)
        theta = rng.uniform(-r, r) - np.pi / 2
    return cx, cy, theta, int(pickup_wall)


def get_random_mic_positions_three_desks(n_mics, left, right, bottom, top,
                                         rng, dimensions=3):
    """Three co-centered desk sizes for one scene (reference: :151-336): the
    same wall placement, center and rotation render a large, a middle and a
    small desk's robot expansion, enabling desk-size ablations on otherwise
    identical scenes.

    Returns (positions_by_size {name: (n_mics, dims)},
             desk_dimensions_by_size {name: [length, width]}, pickup_wall)."""
    for _ in range(200):
        sizes = {name: (rng.uniform(*lr), rng.uniform(*wr))
                 for name, lr, wr in THREE_DESK_SIZES}
        local = {name: _desk_expansion(n_mics, dl, dw, rng)
                 for name, (dl, dw) in sizes.items()}
        # placement rotation bound follows the LARGE desk (reference :262)
        cx, cy, theta, pickup_wall = _place_on_wall(sizes["large"][0], left,
                                                    right, bottom, top, rng)
        rot = np.array([[np.cos(theta), np.sin(theta)],
                        [-np.sin(theta), np.cos(theta)]])
        placed = {name: m @ rot + np.array([cx, cy])
                  for name, m in local.items()}
        if all(is_valid_mic_array(m, left, right, bottom, top)
               for m in placed.values()):
            if dimensions == 3:
                heights = MIC_HEIGHT * np.ones((n_mics, 1))
                placed = {name: np.concatenate([m, heights], axis=1)
                          for name, m in placed.items()}
            return placed, {name: list(sz) for name, sz in sizes.items()}, \
                pickup_wall
    raise RuntimeError("could not place a valid three-desk mic array")


def colocated_array(center, n_mics, rng, dimensions=3,
                    diameter=ECHO_DOT_DIAMETER):
    """Circular (Echo-Dot-style) array at `center` (reference: :477-492)."""
    radius = diameter / 2
    phi0 = rng.uniform(0, 2 * np.pi)
    ang = phi0 + 2 * np.pi * np.arange(n_mics) / n_mics
    xy = np.stack([center[0] + radius * np.cos(ang),
                   center[1] + radius * np.sin(ang)], axis=1)
    if dimensions == 3:
        xy = np.concatenate([xy, MIC_HEIGHT * np.ones((n_mics, 1))], axis=1)
    return xy


def calculate_sample_offset(mic_positions, source_pos, sr):
    d = np.linalg.norm(source_pos - mic_positions, axis=1)
    return (d[1:] - d[0]) / SPEED_OF_SOUND * sr


def get_random_speaker_positions(n_voices, mic_positions, pickup_wall, left,
                                 right, up, down, rng, sr=FS, dimensions=3):
    """(reference: :512-578)"""
    mn_x, mn_y = mic_positions[:, 0].min(), mic_positions[:, 1].min()
    mx_x, mx_y = mic_positions[:, 0].max(), mic_positions[:, 1].max()
    KEEPOUT = 0.25
    h = (mx_y - mn_y) + 2 * KEEPOUT
    w = (mx_x - mn_x) + 2 * KEEPOUT
    mn_x -= KEEPOUT
    mn_y -= KEEPOUT
    mic_center = mic_positions[0]

    if pickup_wall == 0:
        xs = [max(mic_center[0] + KEEPOUT, left + WALL_KEEPOUT),
              min(mic_center[0] + SPK_RANGE_H, right - WALL_KEEPOUT)]
        ys = [max(mic_center[1] - SPK_RANGE_W, down + WALL_KEEPOUT),
              min(mic_center[1] + SPK_RANGE_W, up - WALL_KEEPOUT)]
    elif pickup_wall == 1:
        xs = [max(mic_center[0] - SPK_RANGE_W, left + WALL_KEEPOUT),
              min(mic_center[0] + SPK_RANGE_W, right - WALL_KEEPOUT)]
        ys = [max(mic_center[1] + KEEPOUT, down + WALL_KEEPOUT),
              min(mic_center[1] + SPK_RANGE_H, up - WALL_KEEPOUT)]
    elif pickup_wall == 2:
        xs = [max(mic_center[0] - SPK_RANGE_H, left + WALL_KEEPOUT),
              min(mic_center[0] - KEEPOUT, right - WALL_KEEPOUT)]
        ys = [max(mic_center[1] - SPK_RANGE_W, down + WALL_KEEPOUT),
              min(mic_center[1] + SPK_RANGE_W, up - WALL_KEEPOUT)]
    else:
        xs = [max(mic_center[0] - SPK_RANGE_W, left + WALL_KEEPOUT),
              min(mic_center[0] + SPK_RANGE_W, right - WALL_KEEPOUT)]
        ys = [max(mic_center[1] - SPK_RANGE_H, down + WALL_KEEPOUT),
              min(mic_center[1] - KEEPOUT, up - WALL_KEEPOUT)]

    roi = [xs[0] - 0.1, xs[1] + 0.1, ys[0] - 0.1, ys[1] + 0.1,
           MIN_SPEAKER_HEIGHT - 0.1,
           MIN_SPEAKER_HEIGHT + MAX_SPEAKER_HEIGHT + 0.1]

    voices, offsets = [], []
    for _ in range(n_voices):
        for _attempt in range(500):
            pos = np.array([rng.uniform(*xs), rng.uniform(*ys)])
            # desk keepout box
            if (mn_x <= pos[0] <= mn_x + w) and (mn_y <= pos[1] <= mn_y + h):
                continue
            if dimensions == 3:
                z = (rng.random_sample() * MAX_SPEAKER_HEIGHT
                     + MIN_SPEAKER_HEIGHT)
                pos = np.concatenate([pos, [z]])
            if all(np.linalg.norm(np.asarray(v) - pos) >= MIN_SPEAKER_DIST
                   for v in voices):
                break
        voices.append(pos)
        offsets.append(calculate_sample_offset(mic_positions, pos, sr))
    return voices, offsets, roi


def get_voices(voices_list, n_voices, duration, sr, rng):
    """Pick speakers and trim/pad clips to `duration` (reference: :71-127)."""
    total = int(round(duration * sr))
    pad = int(round(sr * 0.2))
    chosen = rng.choice(voices_list, n_voices, replace=False)
    out = []
    for vdir in chosen:
        for _ in range(50):
            files = glob.glob(os.path.join(vdir, "*.wav"))
            voice, _sr = read_wav(rng.choice(files))
            voice = voice[0]
            # trim silence (18 dB below peak RMS)
            from ..utils.metrics import _nonsilent_intervals

            iv = _nonsilent_intervals(voice, 18, None, 2048, 512)
            if len(iv) == 0:
                continue
            begin, end = iv[0][0], iv[-1][1]
            if voice[begin:end].std() > 2e-4 and (end - begin) > sr * 0.5:
                break
        begin = max(begin - pad, 0)
        end = min(end + pad, len(voice))
        voice = voice[begin:end]
        # Scale speaker peak into the FG_VOL range.  The reference defines
        # FG_VOL_MIN/MAX ("Speaker signal peak value",
        # generate_dataset.py:18-20) but never applies them; without scaling,
        # quiet corpora yield mic signals below the pipeline's absolute power
        # thresholds (constants.py SPOT_POWER_THRESHOLD*), so we implement
        # the documented intent.
        peak = np.max(np.abs(voice))
        if peak > 1e-6:
            voice = voice * (rng.uniform(2 * FG_VOL_MIN, 2 * FG_VOL_MAX)
                             / peak)
        if len(voice) < total:
            voice = np.pad(voice, (0, total - len(voice)))
        elif len(voice) > total:
            b = rng.choice(len(voice) - total)
            voice = voice[b: b + total]
        out.append((voice, os.path.basename(vdir.rstrip("/"))))
    return out


def generate_data_scenario(mic_positions, voice_positions, voices_data,
                           room_dimensions, absorption, max_order, sr,
                           device=None):
    total = voices_data[0][0].shape[-1]
    room = ShoeBox(room_dimensions, fs=sr, max_order=max_order,
                   absorption=absorption, device=device)
    room.add_microphone_array(mic_positions.T)
    for pos, (sig, _) in zip(voice_positions, voices_data):
        room.add_source(pos, sig)
    premix = room.simulate(return_premix=True)
    gt = np.zeros((len(voice_positions), mic_positions.shape[0], total))
    gt[:, :, :] = premix[:, :, :total] if premix.shape[-1] >= total else \
        np.pad(premix, ((0, 0), (0, 0), (0, total - premix.shape[-1])))
    mix = gt.sum(axis=0)
    return mix, gt


def save_scenario(out_dir, input_signals, gt_signals, mic_positions,
                  voice_positions, voice_offsets, voices_data,
                  room_dimensions, desk_dimensions, pickup_wall, roi,
                  absorption, sr, rt60=None):
    n_voices = len(voice_positions)
    n_mics = mic_positions.shape[0]
    os.makedirs(out_dir, exist_ok=True)

    for mic_idx in range(n_mics):
        if mic_idx == 0:
            for v in range(n_voices):
                write_wav(os.path.join(out_dir, f"mic00_voice{v:02d}.wav"),
                          gt_signals[v][0], sr)
        write_wav(os.path.join(out_dir, f"mic{mic_idx:02d}_mixed.wav"),
                  input_signals[mic_idx], sr)

    metadata = {}
    for v in range(n_voices):
        metadata[f"voice{v:02d}"] = {
            "position": list(map(float, voice_positions[v])),
            "shifts": np.round(voice_offsets[v]).astype(np.int32).tolist(),
            "speaker_id": voices_data[v][1],
        }
    for m in range(n_mics):
        metadata[f"mic{m:02d}"] = {"position": list(map(float,
                                                        mic_positions[m]))}
    if rt60 is not None:
        metadata["rt60"] = rt60
    metadata["Room_dimensions"] = list(map(float, room_dimensions))
    metadata["Desk_size"] = desk_dimensions
    metadata["Pick_wall"] = int(pickup_wall)
    metadata["ROI"] = list(map(float, roi))
    metadata["absorption"] = float(absorption)
    metadata["real"] = False
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(metadata, f, indent=4)


def generate_sample(voices_list, args, subdir, idx, rng):
    out_dir = os.path.join(args.output_path, subdir, f"{idx:05d}")
    Path(out_dir).mkdir(parents=True, exist_ok=True)

    n_voices = rng.randint(args.n_voices_min, args.n_voices_max + 1)
    voices_data = get_voices(voices_list, n_voices, args.duration, args.sr,
                             rng)

    room_length = rng.uniform(ROOM_LENGTH_MIN, ROOM_LENGTH_MAX)
    room_width = rng.uniform(ROOM_WIDTH_MIN, ROOM_WIDTH_MAX)
    room_dimensions = [room_length, room_width]
    if args.dimensions == 3:
        room_dimensions.append(rng.uniform(CEIL_MIN, CEIL_MAX))
    absorption = rng.uniform(MIN_ABSORPTION, MAX_ABSORPTION)

    mic_positions, desk_dimensions, pickup_wall = \
        get_random_mic_positions_desk(args.n_mics, 0, room_length, 0,
                                      room_width, rng, args.dimensions)
    voice_positions, voice_offsets, roi = get_random_speaker_positions(
        n_voices, mic_positions, pickup_wall, 0, room_length, room_width, 0,
        rng, sr=args.sr, dimensions=args.dimensions,
    )
    mic_positions = np.asarray(mic_positions)
    voice_positions = np.asarray(voice_positions)

    rt60 = None
    if args.sample_rt60:
        rt60 = rng.uniform(0.08, 0.7)
        while True:
            try:
                absorption, max_order = inverse_sabine(rt60, room_dimensions)
                break
            except ValueError:
                rt60 += 0.02
        max_order = min(max_order, args.max_order_cap)
    else:
        max_order = args.max_order

    mix, gt = generate_data_scenario(mic_positions, voice_positions,
                                     voices_data, room_dimensions,
                                     absorption, max_order, args.sr,
                                     device=args.device)
    save_scenario(out_dir, mix, gt, mic_positions, voice_positions,
                  voice_offsets, voices_data, room_dimensions,
                  desk_dimensions, pickup_wall, roi, absorption, args.sr,
                  rt60=rt60)

    if args.generate_colocated:
        co_dir = os.path.join(args.output_path.rstrip("/") + "_colocated",
                              subdir, f"{idx:05d}")
        co_pos = colocated_array(mic_positions.mean(axis=0), args.n_mics,
                                 rng, args.dimensions)
        mix, gt = generate_data_scenario(co_pos, voice_positions, voices_data,
                                         room_dimensions, absorption,
                                         max_order, args.sr,
                                         device=args.device)
        co_off = [calculate_sample_offset(co_pos, v, args.sr)
                  for v in voice_positions]
        save_scenario(co_dir, mix, gt, co_pos, voice_positions, co_off,
                      voices_data, room_dimensions, desk_dimensions,
                      pickup_wall, roi, absorption, args.sr, rt60=rt60)


def generate_sample_three_desks(voices_list, args, subdir, idx, rng):
    """One scene rendered three times with co-centered large/middle/small
    desks (reference generate_sample_size, generate_dataset.py:826-929): the
    same room, absorption, speakers and voices, differing only in the robot
    expansion extent.  Outputs land under `<out>/<size>/<subdir>/<idx>` so
    each desk size is a complete train/test/val dataset of its own."""
    n_voices = rng.randint(args.n_voices_min, args.n_voices_max + 1)
    voices_data = get_voices(voices_list, n_voices, args.duration, args.sr,
                             rng)

    room_length = rng.uniform(ROOM_LENGTH_MIN, ROOM_LENGTH_MAX)
    room_width = rng.uniform(ROOM_WIDTH_MIN, ROOM_WIDTH_MAX)
    room_dimensions = [room_length, room_width]
    if args.dimensions == 3:
        room_dimensions.append(rng.uniform(CEIL_MIN, CEIL_MAX))
    absorption = rng.uniform(MIN_ABSORPTION, MAX_ABSORPTION)

    placed, desk_dims, pickup_wall = get_random_mic_positions_three_desks(
        args.n_mics, 0, room_length, 0, room_width, rng, args.dimensions)
    voice_positions, _, roi = get_random_speaker_positions(
        n_voices, placed["large"], pickup_wall, 0, room_length, room_width,
        0, rng, sr=args.sr, dimensions=args.dimensions)
    voice_positions = np.asarray(voice_positions)

    for name, mic_positions in placed.items():
        out_dir = os.path.join(args.output_path, name, subdir, f"{idx:05d}")
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        offsets = [calculate_sample_offset(mic_positions, v, args.sr)
                   for v in voice_positions]
        mix, gt = generate_data_scenario(mic_positions, voice_positions,
                                         voices_data, room_dimensions,
                                         absorption, args.max_order, args.sr,
                                         device=args.device)
        save_scenario(out_dir, mix, gt, mic_positions, voice_positions,
                      offsets, voices_data, room_dimensions, desk_dims[name],
                      pickup_wall, roi, absorption, args.sr)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("input_voice_dir", type=str,
                        help="VCTK-style root: one directory per speaker")
    parser.add_argument("output_path", type=str)
    parser.add_argument("--n_mics", type=int, default=7)
    parser.add_argument("--n_voices_min", type=int, default=2)
    parser.add_argument("--n_voices_max", type=int, default=5)
    parser.add_argument("--n_outputs_train", type=int, default=8000)
    parser.add_argument("--n_outputs_test", type=int, default=1000)
    parser.add_argument("--n_outputs_val", type=int, default=500)
    parser.add_argument("--sr", type=int, default=FS)
    parser.add_argument("--duration", type=float, default=3.0)
    parser.add_argument("--dimensions", type=int, default=3)
    parser.add_argument("--max_order", type=int, default=10)
    parser.add_argument("--max_order_cap", type=int, default=150)
    parser.add_argument("--sample_rt60", action="store_true")
    parser.add_argument("--generate_colocated", action="store_true")
    parser.add_argument("--generate_three_desks", action="store_true",
                        help="render each scene with three co-centered desk "
                             "sizes under <out>/{large,middle,small}/")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="device of the room render (default cuda)")
    parser.add_argument("--skip_existing", action="store_true",
                        help="resume an interrupted run: skip indices whose "
                             "metadata.json already exists (skipped scenes "
                             "consume no RNG draws, so use a fresh --seed to "
                             "avoid regenerating earlier scenes' content)")
    args = parser.parse_args()

    rng = np.random.RandomState(args.seed)
    split_file = os.path.join(os.path.dirname(args.input_voice_dir.rstrip("/")),
                              "vctk_split.json")
    if os.path.exists(split_file):
        with open(split_file) as f:
            split = json.load(f)
    else:
        speakers = sorted(os.listdir(args.input_voice_dir))
        n = len(speakers)
        split = {"train": speakers[: int(0.7 * n)],
                 "test": speakers[int(0.7 * n): int(0.9 * n)],
                 "val": speakers[int(0.9 * n):]}

    for subdir, count in [("train", args.n_outputs_train),
                          ("test", args.n_outputs_test),
                          ("val", args.n_outputs_val)]:
        voices_list = [os.path.join(args.input_voice_dir, s)
                       for s in split[subdir]]
        voices_list = [v for v in voices_list if os.path.isdir(v)]
        if count > 0 and len(voices_list) < args.n_voices_max:
            print(f"[WARNING] split '{subdir}' has only {len(voices_list)} "
                  f"speakers (< n_voices_max={args.n_voices_max}); skipping")
            continue
        sample_fn = (generate_sample_three_desks if args.generate_three_desks
                     else generate_sample)
        for idx in range(count):
            done_marker = os.path.join(args.output_path, subdir,
                                       f"{idx:05d}", "metadata.json")
            if args.skip_existing and os.path.exists(done_marker):
                continue
            sample_fn(voices_list, args, subdir, idx, rng)
            print(f"[{subdir}] generated sample {idx}", flush=True)


if __name__ == "__main__":
    main()
