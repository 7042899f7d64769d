"""Search-space subdivision: width-4 patches -> balanced width-2 patches.

Host NumPy, from the JAX package's `search/subdivide.py` for the PyTorch port
(the port imports nothing of that package).

Counterpart of reference sep/helpers/local_utils_3d.py:212-388
(`search_area`, `binary_area_divide_width`, `binary_search_baseline`).
A candidate of ~20k member points splits in ~60 steps, each on whole
arrays: every pair's two halves come from one comparison on that pair's row
(the candidate's own box is tested on every pair and point once), so a
candidate costs tens of milliseconds on the host.  The expensive part (the
spotforming sweep) runs on device via search/spotform.py.
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

# The reference's starting "most balanced" difference: a split is taken
# only below it.
_MAX_DIFFERENCE = 2500000


def search_area(patch_list: list[Patch], mic_positions: np.ndarray,
                upper_bound_pairwise: np.ndarray | None) -> list[Patch]:
    """Recursively subdivide patches until width <= 2*MIN_WIDTH_REQUIRED and
    area <= MIN_AREA (reference: local_utils_3d.py:212-246).  The leaves
    come out breadth first, in list order within a level.  The first
    patch's own samples (`Patch.area_samples`, which the 1 cm
    materialization computes from the geometry's mic positions) take
    precedence over `mic_positions`, which give the samples only where the
    patch has none."""
    finish_patched: list[Patch] = []

    samples = patch_list[0].area_samples  # (M-1, N), the 1 cm field's
    if samples is None:
        points0 = patch_list[0].area_points  # (3, N)
        samples = sample_offsets_for(points0.T, mic_positions, sr=48000).T
    samples_lists = [samples]
    # A half's points lie inside its box on every pair, so below the root
    # only the split pair's row is tested (unless check_out moves the box).
    boxed = [False]

    while True:
        next_patches: list[Patch] = []
        next_samples: list[np.ndarray] = []
        for i, patch in enumerate(patch_list):
            if_continue, nxt_patch, nxt_sample = binary_area_divide_width(
                patch, samples_lists[i], mic_positions, upper_bound_pairwise,
                boxed=boxed[i])
            if if_continue:
                next_patches.extend(nxt_patch)
                next_samples.extend(nxt_sample)
            else:
                finish_patched.append(nxt_patch)
        if len(next_patches) == 0:
            break
        patch_list = next_patches
        samples_lists = next_samples
        boxed = [True] * len(patch_list)
    return finish_patched


def binary_area_divide_width(patch: Patch, samples0: np.ndarray,
                             mic_positions: np.ndarray,
                             upper_bound_pairwise: np.ndarray | None,
                             boxed: bool = False):
    """One split step: halve the patch along the pair that best balances
    member-point counts (reference: local_utils_3d.py:248-335).

    All pairs at once: the parent's box is tested on every pair, and a
    pair's halves differ from it only in that pair's row.  `boxed` says
    every point of `samples0` lies inside the patch's box, as a half's do,
    which spares that test while check_out leaves the box as it is.  The
    widest pairs go first (half width > MIN_WIDTH_REQUIRED), then the most
    balanced split, the lowest pair on a tie; empty halves are dropped."""
    if upper_bound_pairwise is not None:
        boxed = not patch.check_out(upper_bound_pairwise) and boxed

    candidates_area = patch.area_points
    candidates = patch.sample_offset
    widths = patch.width_list
    num_points = patch.area_size()

    if (np.amax(widths) / 2 <= MIN_WIDTH_REQUIRED) and num_points <= MIN_AREA:
        return False, patch, samples0

    pairs = np.flatnonzero(~(widths / 2 < MIN_WIDTH))
    if pairs.shape[0] == 0:
        return False, patch, samples0

    # Each split pair's two halves (2, K), with the same expressions as a
    # half's Patch box, tested on that pair's row only.
    split_width = widths[pairs]
    half_width = split_width / 2
    halves = np.stack((candidates[pairs] - split_width / 4,
                       candidates[pairs] + split_width / 4))
    rows = samples0[pairs]  # (K, N)
    area = (rows >= (halves - half_width / 2 - 1e-3)[:, :, None]) \
        & (rows <= (halves + half_width / 2 + 1e-3)[:, :, None])
    if not boxed:
        # Points inside the parent's box on every pair but the split one.
        lo = candidates - widths / 2 - 1e-3
        hi = candidates + widths / 2 + 1e-3
        outside = ~((samples0 >= lo[:, None]) & (samples0 <= hi[:, None]))
        area &= (outside.sum(axis=0) - outside[pairs]) == 0
    sizes = area.sum(axis=2)  # (2, K)
    difference = np.abs(sizes[0] - sizes[1])

    wide = np.flatnonzero(half_width > MIN_WIDTH_REQUIRED)
    if wide.shape[0] > 0:
        k = wide[np.argmin(difference[wide])]
    else:
        k = int(np.argmin(difference))
        if not difference[k] < _MAX_DIFFERENCE:
            return False, patch, samples0

    i = pairs[k]
    two_patches = []
    two_samples = []
    for h in range(2):
        if sizes[h, k] > 0:
            offset = np.copy(candidates)
            offset[i] = halves[h, k]
            width = np.copy(widths)
            width[i] = half_width[k]
            two_patches.append(Patch(offset, width,
                                     candidates_area[:, area[h, k]]))
            two_samples.append(samples0[:, area[h, k]])
    if not two_patches:
        return False, patch, samples0
    return True, two_patches, two_samples


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
