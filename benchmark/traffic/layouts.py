# Frozen copy of the layout sampling of
# acousticswarms_speech_tpu_torch/data/generate_dataset.py at commit 300ffdc:
# the benchmark's traffic imports nothing of the port.
"""Table layouts as the dataset generator draws them: a desk against a wall,
robots expanded from its centre to its edges, and talkers in the
wall-dependent region of interest with a desk keepout and a minimum
spacing.  Every draw comes from an explicit `np.random.RandomState`."""
from __future__ import annotations

import numpy as np

FS = 48000
SPEED_OF_SOUND = 343.0
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


def is_valid_mic_array(array, left, right, bottom, top, threshold=0.06):
    return bool(np.all(
        (array[:, 0] > left + threshold) & (array[:, 0] < right - threshold)
        & (array[:, 1] > bottom + threshold) & (array[:, 1] < top - threshold)
    ))


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
