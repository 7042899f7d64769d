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

from ..constants import FS, SPEED_OF_SOUND
from ..dsp.patch import Patch
from ..utils.metrics import si_sdr, split_wav, split_wise_sisdr
from . import power_trace


import os

# Final-NMS merge thresholds (reference constants: Mic_Array.py:18-28,:442).
# They encode the trained net's off-target leakage profile, so like the
# spot-power thresholds they are env-tunable: a sharper net wants stricter
# merge rules (see scripts/analyze_probe.py and PERF.md round-3 notes).
# Default raised from the reference's -1: the round-3 net extracts
# dominant-speaker-leaked audio at most candidate locations, and at -1 the
# full-SI-SDR rule (plus the windowed rule) merged every head into ONE
# cluster per scene (recall 0.54 -> 0.27; see PERF.md round-3 NMS notes and
# scripts/analyze_probe.py).  At 2, estimated replay on the probe traces
# yields ~3.7 heads/scene vs 3.35 GT speakers/scene.
NMS_SISDR_THRESHOLD = float(os.environ.get("NMS_SISDR_THRESHOLD", "2"))
NMS_WIN_THRESHOLD = float(os.environ.get("NMS_WIN_THRESHOLD", "-2"))
NMS_WIN_THRESHOLD2 = float(os.environ.get("NMS_WIN_THRESHOLD2", "-7"))
NMS_DIS_THRESHOLD = float(os.environ.get("NMS_DIS_THRESHOLD", "0.45"))
# Power-ranked cap on final clusters (no reference counterpart needed: the
# reference net never emitted more than a handful).  Guards the separation
# stage's speaker-bucket size and precision when merge rules are loosened.
# Default 8, strictly above the eval sets' max GT speaker count (6): a cap
# at exactly the max count lets one strong false-positive head evict a true
# speaker (ADVICE r3).  Truncation is recorded in the nms_summary trace and
# printed, so a capped scene is visible in results.
NMS_MAX_OUT = int(os.environ.get("NMS_MAX_OUT", "8"))
# TDoA-consistency gate (search/consistency.py): drop candidates whose
# extracted audio's measured cross-correlation lags deviate from the claimed
# position's offsets by more than this many samples BEFORE the greedy merge
# loop, so off-position dominant-speaker leaks cannot absorb true heads.
# DEFAULT 0 = OFF, by labeled-replay finding (round 5, PERF.md): on the
# r6_probe2 traces the deviation distributions of GT-labeled vs negative
# candidates computed from *extracted* audio overlap heavily (GT p50/p90 =
# 3/59 vs neg 6/50), and every gate in [3, 48] REDUCED GT-surviving heads
# (6 -> 5).  The clean GT-audio separation (<=1 vs >=3) does not transfer
# to net extractions at current net quality; the gate cannot deliver the
# recall target and stays off.  For scale: GT labels use a 4.9-sample
# window (data/generate_srp_sample.py).
NMS_TDOA_GATE = float(os.environ.get("NMS_TDOA_GATE", "0"))
# Consistency-based head election: after the greedy merge, report each
# cluster through its most position-consistent member (lowest TDoA
# deviation) instead of its highest-power one.  Rationale: when a true head
# is absorbed by an off-position leak, the cluster still contains the true
# head — electing by consistency fixes the cluster's reported position and
# audio even though the merge itself was unavoidable (the audio is
# near-identical).  Power stays the tiebreaker via insertion order.
# DEFAULT ON since round 5: exact-semantics offline replay on the r6_probe2
# labeled traces (scripts/replay_nms.py --elect, post-ADVICE-r4 fix) nearly
# doubles GT-carrying heads (6/19 -> 11/19 of 39 GT) at identical
# heads/scene; confirmed live on the traced probe before the default flip.
NMS_TDOA_ELECT = os.environ.get("NMS_TDOA_ELECT", "1") == "1"
# Consistency split (round 5): a cluster that absorbed members which are
# BOTH position-consistent (TDoA deviation <= NMS_SPLIT_DEV — their audio
# really correlates at their claimed position) AND at least NMS_SPLIT_DIS
# meters (2D) from every emitted head is hiding a second genuine speaker
# behind the dominant-speaker leakage that merged them; emit those members
# as extra heads (globally deviation-ascending) up to NMS_SPLIT_MAX total
# heads.  NMS_SPLIT_POW drops extras quieter than that fraction of their
# cluster head's power.  NMS_SPLIT_DEV=0 disables.
#
# Default ON since round 5 — live 12-scene A/B (.results_r8_split, dev 3 /
# dis 0.8 / no cap): recall 0.436 -> 0.615 at precision 0.895 -> 0.615.
# Defaults refined from the labeled-trace sweep (replay_nms --split):
# dis 1.2 + pow 0.25 keep 14/15 of the proxy's GT gain while cutting
# extra-head volume ~30% (labeled-head ratio 0.39 -> 0.50), and the
# 5-head cap keeps the separation stage in its trained <=5-speaker bucket
# (max_speakers=5; S>5 pads to 10 and separation quality collapses).
NMS_SPLIT_DEV = float(os.environ.get("NMS_SPLIT_DEV", "3"))
NMS_SPLIT_DIS = float(os.environ.get("NMS_SPLIT_DIS", "1.2"))
NMS_SPLIT_POW = float(os.environ.get("NMS_SPLIT_POW", "0.25"))
NMS_SPLIT_MAX = int(os.environ.get("NMS_SPLIT_MAX", "5"))


def effective_nms_config() -> dict:
    """The NMS thresholds actually in effect (env overrides applied at import
    time) — recorded into eval results folders for provenance (ADVICE r3:
    a stray env var must not silently change reported precision/recall)."""
    return {
        "NMS_SISDR_THRESHOLD": NMS_SISDR_THRESHOLD,
        "NMS_WIN_THRESHOLD": NMS_WIN_THRESHOLD,
        "NMS_WIN_THRESHOLD2": NMS_WIN_THRESHOLD2,
        "NMS_DIS_THRESHOLD": NMS_DIS_THRESHOLD,
        "NMS_MAX_OUT": NMS_MAX_OUT,
        "NMS_TDOA_GATE": NMS_TDOA_GATE,
        "NMS_TDOA_ELECT": NMS_TDOA_ELECT,
        "NMS_SPLIT_DEV": NMS_SPLIT_DEV,
        "NMS_SPLIT_DIS": NMS_SPLIT_DIS,
        "NMS_SPLIT_POW": NMS_SPLIT_POW,
        "NMS_SPLIT_MAX": NMS_SPLIT_MAX,
    }


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
                if power_trace.ENABLED:
                    power_trace.record(
                        "tdoa_gate_drop", label=int(cand[-1]),
                        dev=float(dev), power=float(cand[2]))
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
            if power_trace.ENABLED:
                # Every tested (candidate, head) pair with its windowed
                # SI-SDR list: scripts/replay_nms.py re-runs the greedy NMS
                # offline under different thresholds (exact for pairs the
                # live pass tested; the full-signal matrix in nms_summary
                # covers the rest).
                power_trace.record(
                    "nms_pair", i=int(_id), head=int(head),
                    sisdr=float(similarity),
                    dis=float(np.linalg.norm(center1[:2] - center2[:2])),
                    sisdr_win=[float(x) for x in sisdr_list])

            dis = np.linalg.norm(center1[:2] - center2[:2])
            check_valid = check_sisnr_win(
                sisdr_list, NMS_WIN_THRESHOLD, NMS_WIN_THRESHOLD2)

            if similarity > SI_SDR_THRESHOLD or check_valid or dis < NMS_DIS_THRESHOLD:
                if power_trace.ENABLED:
                    power_trace.record(
                        "nms_merge", label=int(big_label),
                        head_label=int(candidates[head][-1]),
                        by=("sisdr" if similarity > SI_SDR_THRESHOLD
                            else ("win" if check_valid else "dis")),
                        sisdr=float(similarity), dis=float(dis))
                clusters[head].append(_id)
                unique = False
                belong_cluster = cluster_id
                break

        if len(sisnr_seg) != 0:
            seg_max = np.amax(np.array(sisnr_seg), axis=0)
            if check_sisnr_win(seg_max, threshold=NMS_WIN_THRESHOLD + 1,
                               threshold2=NMS_WIN_THRESHOLD2 + 2):
                if unique and power_trace.ENABLED:
                    power_trace.record("nms_segmax_drop",
                                       label=int(big_label))
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
    if power_trace.ENABLED:
        sub_mat = None
        if pair_sisdr is not None:
            # Full-signal SI-SDR matrix in candidate (power-sorted) order —
            # with powers/centers below this makes the sisdr+dis merge rules
            # exactly replayable offline (scripts/replay_nms.py).
            sub_mat = [[float(pair_sisdr[order[a], order[b]])
                        for b in range(len(candidates))]
                       for a in range(len(candidates))]
        power_trace.record(
            "nms_summary", n_in=len(candidates), n_out=len(clusters),
            n_truncated=n_truncated,
            in_labels=[int(c[-1]) for c in candidates],
            out_labels=[int(candidates[clusters[c][0]][-1])
                        for c in clusters],
            pair_sisdr=sub_mat,
            powers=[float(c[2]) for c in candidates],
            centers=[np.asarray(c[0].center_pos()).tolist()
                     for c in candidates],
            has_segments=[len(split_wav(c[1])) > 0 for c in candidates],
            tdoa_dev=[c[-2].get("tdoa_dev") for c in candidates])
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
                if elected != head and power_trace.ENABLED:
                    power_trace.record(
                        "tdoa_elect", head_label=int(candidates[head][-1]),
                        elected_label=int(candidates[elected][-1]),
                        head_dev=float(scored[0][1]),
                        elected_dev=float(dict(scored)[elected]))
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
                if power_trace.ENABLED:
                    power_trace.record(
                        "tdoa_split", label=int(candidates[m][-1]),
                        dev=float(dev))
                emitted.append(m)
    for head in emitted:
        patch_final.append(candidates[head])
        audio_final.append(candidates[head][1])
    return audio_final, patch_final, wrong_spotforming
