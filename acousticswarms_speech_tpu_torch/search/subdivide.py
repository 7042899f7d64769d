"""Search-space subdivision: width-4 patches -> balanced width-2 patches.

Host NumPy, copied from the JAX package's `search/subdivide.py` for the PyTorch port
(the port imports nothing of that package).

Counterpart of reference sep/helpers/local_utils_3d.py:212-388
(`search_area`, `binary_area_divide_width`, `binary_search_baseline`).
The recursion is over tens of small patches with host-side numpy predicates;
the expensive part (the spotforming sweep) runs on device via
search/spotform.py.
"""
from __future__ import annotations

import numpy as np

from ..constants import (
    MAX_BIG_PATCH,
    MIN_AREA,
    MIN_WIDTH,
    MIN_WIDTH_REQUIRED,
    SPOT_POWER_THRESHOLD1,
    USE_RELATIVE_SPOT_POWER,
)
from ..dsp.patch import Patch
from ..utils.shift import sample_offsets_for
from . import power_trace


def search_area(patch_list: list[Patch], mic_positions: np.ndarray,
                upper_bound_pairwise: np.ndarray | None) -> list[Patch]:
    """Recursively subdivide patches until width <= 2*MIN_WIDTH_REQUIRED and
    area <= MIN_AREA (reference: local_utils_3d.py:212-246)."""
    finish_patched: list[Patch] = []

    points0 = patch_list[0].area_points  # (3, N)
    samples = sample_offsets_for(points0.T, mic_positions, sr=48000).T  # (M-1, N)
    samples_lists = [samples]

    while True:
        next_patches: list[Patch] = []
        next_samples: list[np.ndarray] = []
        for i, patch in enumerate(patch_list):
            pts_samples = samples_lists[i]
            if_continue, nxt_patch, nxt_sample = binary_area_divide_width(
                patch, pts_samples, mic_positions, upper_bound_pairwise
            )
            if if_continue:
                next_patches.extend(nxt_patch)
                next_samples.extend(nxt_sample)
            else:
                finish_patched.append(nxt_patch)
        if len(next_patches) == 0:
            break
        patch_list = next_patches
        samples_lists = next_samples
    return finish_patched


def binary_area_divide_width(patch: Patch, samples0: np.ndarray,
                             mic_positions: np.ndarray,
                             upper_bound_pairwise: np.ndarray | None):
    """One split step: halve the patch along the pair that best balances
    member-point counts (reference: local_utils_3d.py:248-335)."""
    if upper_bound_pairwise is not None:
        patch.check_out(upper_bound_pairwise)

    candidates_area = patch.area_points
    candidates = patch.sample_offset
    widths = patch.width_list
    num_points = patch.area_size()
    num_pair = candidates.shape[0]

    if (np.amax(widths) / 2 <= MIN_WIDTH_REQUIRED) and num_points <= MIN_AREA:
        return False, patch, samples0

    min_difference = 2500000
    min_patch = None
    min_sample = None
    remain_wide = False
    found_any_nonempty = False

    for i in range(num_pair):
        if widths[i] / 2 < MIN_WIDTH:
            continue
        two_patches = []
        two_samples = []
        half0 = np.copy(candidates)
        half0[i] -= widths[i] / 4
        half1 = np.copy(candidates)
        half1[i] += widths[i] / 4
        half_width = np.copy(widths)
        half_width[i] /= 2

        patch0 = Patch(half0, half_width, None)
        patch1 = Patch(half1, half_width, None)

        area0 = patch0.hyperbola_sample(samples0) == 1
        size0 = int(np.sum(area0))
        if size0 > 0:
            patch0.area_points = candidates_area[:, area0]
            two_patches.append(patch0)
            two_samples.append(samples0[:, area0])
        area1 = patch1.hyperbola_sample(samples0) == 1
        size1 = int(np.sum(area1))
        if size1 > 0:
            patch1.area_points = candidates_area[:, area1]
            two_patches.append(patch1)
            two_samples.append(samples0[:, area1])
        if two_patches:
            found_any_nonempty = True

        # Prefer splits that still leave width > MIN_WIDTH_REQUIRED (i.e.,
        # split the widest pairs first), then balance point counts.
        if half_width[i] > MIN_WIDTH_REQUIRED:
            if not remain_wide:
                min_difference = abs(size0 - size1)
                min_patch = two_patches
                min_sample = two_samples
                remain_wide = True
            elif abs(size0 - size1) < min_difference:
                min_difference = abs(size0 - size1)
                min_patch = two_patches
                min_sample = two_samples
        else:
            if not remain_wide and abs(size0 - size1) < min_difference:
                min_difference = abs(size0 - size1)
                min_patch = two_patches
                min_sample = two_samples

    if min_patch is None or not found_any_nonempty or len(min_patch) == 0:
        return False, patch, samples0
    return True, min_patch, min_sample


def binary_search_baseline(mix_data: np.ndarray, spot_model, patch_list,
                           mic_positions: np.ndarray, sweep=None):
    """Coarse-stage filter: spotform every width-4 patch with the relaxed
    window, keep the (<= MAX_BIG_PATCH) patches whose distance-compensated
    windowed power clears SPOT_POWER_THRESHOLD1
    (reference: local_utils_3d.py:339-388).

    Device note: only the two power scalars per candidate leave the device —
    the coarse stage never transfers waveforms (the reference copies every
    spotformed waveform to host, JointModel/network.py:99)."""
    if sweep is None:
        sweep = spot_model.sweep(mix_data, patch_list, strict=0)
    powers = list(sweep.powers)
    powers_win = list(sweep.powers_win)
    powers_with_dis = []
    for i in range(len(patch_list)):
        center = patch_list[i].center_pos()
        d = np.linalg.norm(center - mic_positions[0]) if center is not None and \
            center.shape[0] == 3 else 4.0
        powers_with_dis.append(powers_win[i] * (d + 1))

    sort_idx = np.argsort(-np.array(powers_win))
    max_power_with_dis = max(powers_with_dis)
    if power_trace.ENABLED:
        power_trace.record(
            "coarse",
            offsets=[np.asarray(p.sample_offset).tolist()
                     for p in patch_list],
            powers_win=[float(x) for x in powers_win],
            powers_with_dis=[float(x) for x in powers_with_dis])
    if USE_RELATIVE_SPOT_POWER:
        relative_threshold = min(0.4 * max_power_with_dis, SPOT_POWER_THRESHOLD1)
    else:
        relative_threshold = SPOT_POWER_THRESHOLD1

    valid_patch = []
    n_passing = 0
    for i in sort_idx:
        if powers_with_dis[i] < relative_threshold:
            continue
        n_passing += 1
        if len(valid_patch) >= MAX_BIG_PATCH:
            continue
        valid_patch.append(patch_list[i])
    if power_trace.ENABLED:
        power_trace.record("coarse_keep", n_passing=n_passing,
                           n_kept=len(valid_patch),
                           cap=MAX_BIG_PATCH,
                           n_truncated=n_passing - len(valid_patch))
    if n_passing > len(valid_patch):
        print(f"[coarse] MAX_BIG_PATCH={MAX_BIG_PATCH} truncated "
              f"{n_passing - len(valid_patch)} of {n_passing} passing "
              f"patches")
    return valid_patch, powers_with_dis, relative_threshold * 1.2
