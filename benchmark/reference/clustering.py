# Frozen copy of acousticswarms_speech_tpu_torch/search/clustering.py at commit 300ffdc,
# part of the benchmark's plain reference: it imports nothing of the port.
"""Fine-stage power clustering and final non-max suppression.

Host NumPy, copied from the JAX package's `search/clustering.py` for the PyTorch port
(the port imports nothing of that package).

Counterpart of the clustering logic in reference sep/Mic_Array.py:
- `check_sisnr_win` (:18-28), `weight_mean_pos` (:32-47),
  `find_merge_center` (:50-81)
- the per-big-patch power threshold + SI-SDR greedy clustering inside
  `Spotform_Small_Patch_Parallel` (:285-395) — implemented in
  pipeline/mic_array.py which calls these helpers
- `Clustering_new` (:399-500): power-sorted NMS across big patches using
  full and segment-wise SI-SDR plus 2D distance.
"""
from __future__ import annotations

import numpy as np

from .constants import FS, SPEED_OF_SOUND
from .patch import Patch
from .metrics import si_sdr, split_wav, split_wise_sisdr


# Final-NMS thresholds (the port's defaults).
NMS_SISDR_THRESHOLD = 2
NMS_WIN_THRESHOLD = -2
NMS_WIN_THRESHOLD2 = -7
NMS_DIS_THRESHOLD = 0.45
NMS_MAX_OUT = 8
NMS_TDOA_GATE = 0
NMS_TDOA_ELECT = True
NMS_SPLIT_DEV = 3
NMS_SPLIT_DIS = 1.2
NMS_SPLIT_POW = 0.25
NMS_SPLIT_MAX = 5


def check_sisnr_win(sisnr_list, threshold: float = -2, threshold2: float = -7) -> bool:
    """Window-wise SI-SDR similarity test (Mic_Array.py:18-28): similar iff
    some window is above `threshold` and no window is below `threshold2`."""
    same_flag = False
    same_flag2 = True
    for value in sisnr_list:
        if value > threshold:
            same_flag = True
        if value < threshold2:
            same_flag2 = False
    return same_flag and same_flag2


def weight_mean_pos(patch_list, powers, id_lists):
    """Power-weighted mean of positions/offsets of clustered patches,
    ignoring members below 0.75x the cluster head's power
    (Mic_Array.py:32-47)."""
    total_pos = np.zeros(3)
    total_power = 0.0
    max_power = powers[id_lists[0]]
    total_offsets = np.zeros_like(patch_list[0].sample_offset, dtype=np.float64)
    for _id in id_lists:
        if powers[_id] < max_power * 0.75:
            continue
        total_pos += powers[_id] * patch_list[_id].center_pos()
        total_offsets += powers[_id] * patch_list[_id].sample_offset
        total_power += powers[_id]
    return total_pos / total_power, total_offsets / total_power


def find_merge_center(merged_offsets, init_area, mic_positions, big_patch_center):
    """Build the merged cluster-center patch: a width-3 hypercube at the
    weighted offsets intersected with the big patch's area; widen up to +3 if
    empty, falling back to the big patch center (Mic_Array.py:50-81)."""
    num_pair = mic_positions.shape[0] - 1
    begin_width = 3
    patch_center = Patch(merged_offsets,
                         [begin_width] * num_pair, None)

    area = patch_center.hyperbola_general_area(
        init_area[0, :], init_area[1, :], init_area[2, :], mic_positions,
        SPEED_OF_SOUND, FS,
    ) == 1
    if np.sum(area) == 0:
        find_center = False
        for factor in range(4):
            patch_center.width_list = np.array(
                [begin_width + factor] * num_pair, dtype=np.float64
            )
            area = patch_center.hyperbola_general_area(
                init_area[0, :], init_area[1, :], init_area[2, :],
                mic_positions, SPEED_OF_SOUND, FS,
            ) == 1
            if np.sum(area) > 0:
                patch_center.area_points = init_area[:, area]
                find_center = True
                break
        if not find_center:
            patch_center.peak_pos = big_patch_center
    else:
        patch_center.area_points = init_area[:, area]
    return patch_center


def clustering_nms(output_pair, sample_gt=None, verbose: bool = False,
                   pair_sisdr=None):
    """Final NMS over all fine-stage clusters (Mic_Array.Clustering_new,
    :399-500).

    output_pair entries: (patch_center, audio, power, id_str, offsets_dict,
    big_label).  Returns (audio_final, patch_final, wrong_spotforming).

    `pair_sisdr`: optional (N, N) matrix of full-signal SI-SDR between
    output_pair entries (in output_pair order) — supplied from the sweep's
    device-computed matrix so the host skips N^2 passes over the waveforms.
    """
    SI_SDR_THRESHOLD = NMS_SISDR_THRESHOLD
    order = sorted(range(len(output_pair)), key=lambda i: -output_pair[i][2])
    candidates = [output_pair[i] for i in order]

    if NMS_TDOA_GATE > 0:
        # Opt-in consistency gate: an off-position leak must not become a
        # cluster head (it would absorb the true head and win on power).
        kept = []
        for k, cand in enumerate(candidates):
            dev = cand[-2].get("tdoa_dev")
            if dev is not None and dev > NMS_TDOA_GATE:
                continue
            kept.append(k)
        order = [order[k] for k in kept]
        candidates = [candidates[k] for k in kept]
    clusters: dict[int, list[int]] = {}
    wrong_spotforming = []

    for _id in range(len(candidates)):
        unique = True
        belong_cluster = -1
        sisnr_seg = []

        big_label = candidates[_id][-1]
        center1 = candidates[_id][0].center_pos()
        audio1 = candidates[_id][1]
        power1 = candidates[_id][2]

        seg_win = split_wav(audio1)
        if len(seg_win) == 0:
            continue

        for cluster_id in clusters:
            head = clusters[cluster_id][0]
            audio2 = candidates[head][1]
            center2 = candidates[head][0].center_pos()

            if pair_sisdr is not None:
                similarity = pair_sisdr[order[_id], order[head]]
            else:
                similarity = si_sdr(audio1, audio2)
            sisdr_list = split_wise_sisdr(audio1, audio2, seg_win)
            sisnr_seg.append(sisdr_list)
            dis = np.linalg.norm(center1[:2] - center2[:2])
            check_valid = check_sisnr_win(
                sisdr_list, NMS_WIN_THRESHOLD, NMS_WIN_THRESHOLD2)

            if similarity > SI_SDR_THRESHOLD or check_valid or dis < NMS_DIS_THRESHOLD:
                clusters[head].append(_id)
                unique = False
                belong_cluster = cluster_id
                break

        if len(sisnr_seg) != 0:
            seg_max = np.amax(np.array(sisnr_seg), axis=0)
            if check_sisnr_win(seg_max, threshold=NMS_WIN_THRESHOLD + 1,
                               threshold2=NMS_WIN_THRESHOLD2 + 2):
                unique = False

        if unique:
            clusters[_id] = [_id]
        elif big_label >= 0 and sample_gt is not None and belong_cluster >= 0:
            head = clusters[belong_cluster][0]
            cluster_label = candidates[head][-1]
            power2 = candidates[head][2]
            offset1 = candidates[head][-2]["audio_offset"]
            delta_offset = (offset1 - sample_gt[:, big_label]).astype(int)
            if cluster_label == -1:
                wrong_spotforming.append(
                    (big_label, cluster_label, delta_offset, power1 / power2)
                )

    n_truncated = max(0, len(clusters) - NMS_MAX_OUT)
    if n_truncated:
        print(f"[nms] output cap NMS_MAX_OUT={NMS_MAX_OUT} truncated "
              f"{n_truncated} of {len(clusters)} clusters")
    patch_final = []
    audio_final = []
    # candidates are power-sorted, so insertion order is power order;
    # NMS_MAX_OUT keeps the strongest heads.
    emitted = []
    for cluster_id in list(clusters)[:NMS_MAX_OUT]:
        head = clusters[cluster_id][0]
        if NMS_TDOA_ELECT and len(clusters[cluster_id]) > 1:
            scored = [(m, candidates[m][-2].get("tdoa_dev"))
                      for m in clusters[cluster_id]]
            if all(dev is not None for _, dev in scored):
                elected = min(scored, key=lambda t: t[1])[0]
                head = elected
        emitted.append(head)
    if NMS_SPLIT_DEV > 0:
        # Consistency split (see NMS_SPLIT_DEV above; offline counterpart
        # scripts/replay_nms.py --split — keep semantics in lockstep):
        # extra heads globally deviation-ascending, each at least
        # NMS_SPLIT_DIS from every already-emitted head.
        head_pow = {m: candidates[ms[0]][2]
                    for ms in clusters.values() for m in ms}
        extras = sorted(
            ((m, candidates[m][-2].get("tdoa_dev")) for m in head_pow
             if m not in emitted
             and candidates[m][-2].get("tdoa_dev") is not None
             and candidates[m][-2]["tdoa_dev"] <= NMS_SPLIT_DEV
             and candidates[m][2] >= NMS_SPLIT_POW * head_pow[m]),
            key=lambda t: t[1])
        cap = min(NMS_MAX_OUT,
                  NMS_SPLIT_MAX if NMS_SPLIT_MAX > 0 else NMS_MAX_OUT)
        for m, dev in extras:
            if len(emitted) >= cap:
                break
            pos = np.asarray(candidates[m][0].center_pos())[:2]
            if all(np.linalg.norm(
                    pos - np.asarray(candidates[e][0].center_pos())[:2])
                    >= NMS_SPLIT_DIS for e in emitted):
                emitted.append(m)
    for head in emitted:
        patch_final.append(candidates[head])
        audio_final.append(candidates[head][1])
    return audio_final, patch_final, wrong_spotforming
