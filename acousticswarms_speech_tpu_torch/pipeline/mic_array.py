"""Localization-by-separation engine: the 4-stage TDoA search.

Port of the JAX package's `pipeline/mic_array.py`.  The SRP map and the
sweeps run on the port's device; the search logic is the same host NumPy.

Rebuild of reference sep/Mic_Array.py (class `Mic_Array`):
stage 0: SRP-PHAT pruning -> candidate width-8..4 hypercubes
stage 1: coarse spotforming over width-4 patches (relaxed window)
stage 2: subdivision to width-2 patches + one combined strict spotform sweep,
         per-big-patch power threshold and SI-SDR greedy clustering
stage 3: global NMS (Clustering_new)

The public API mirrors the reference's method names so existing workflows
translate directly; snake_case methods are the primary API with reference-
style aliases provided.
"""
from __future__ import annotations

import numpy as np

from ..constants import (
    FREQ_BINS,
    FS,
    INIT_WIDTH,
    N_FFT,
    SPEED_OF_SOUND,
    SPOT_POWER_THRESHOLD2,
    USE_RELATIVE_SPOT_POWER,
)
from ..device import resolve_device
from ..dsp.geometry import build_geometry
from ..dsp.music import music_map_window
from ..dsp.patch import Patch
from ..dsp.tops import tops_map_window
from ..search import power_trace
from ..search.clustering import (
    NMS_TDOA_ELECT,
    NMS_TDOA_GATE,
    clustering_nms,
    find_merge_center,
    weight_mean_pos,
)
from ..search.consistency import head_deviations
from ..search.spotform import to_numpy
from ..search.srp_pruning import SrpEngine
from ..search.subdivide import binary_search_baseline, search_area

# The classical baselines' maps, which replace the SRP map before pruning.
BASELINE_MAPS = {"MUSIC": music_map_window, "TOPS": tops_map_window}


class MicArray:
    """One microphone configuration's search engine."""

    def __init__(self, mic_positions: np.ndarray, spk_range=None,
                 grid_size: float = 0.05, prune_method: str = "SRP",
                 min_trigger_power: float = 0.5, cache_dir: str | None = None,
                 threshold=(0.15, 0.015, 0.05), device=None):
        self.device = resolve_device(device)
        self.prune_method = prune_method
        self.min_trigger_power = min_trigger_power
        self.range_spk = spk_range
        self.mic_positions = np.asarray(mic_positions, dtype=np.float64)
        self.num_mic = self.mic_positions.shape[0]

        # Physical TDoA upper bound per pair (+8 cm slack)
        # (reference: Mic_Array.py:113-115)
        self.upper_bound_pairwise = (
            np.linalg.norm(self.mic_positions[1:] - self.mic_positions[0], axis=1)
            + 0.08
        ) / SPEED_OF_SOUND * FS

        self.geom = build_geometry(self.mic_positions, spk_range,
                                   grid_size=grid_size, cache_dir=cache_dir)
        self.srp = SrpEngine(self.geom, threshold=threshold, width=INIT_WIDTH,
                             freq_bins=FREQ_BINS, fs=FS, n_fft=N_FFT,
                             device=self.device)

        self.original_times = 0
        self.spotforming_times = 0
        self.big_spotforming_times = 0

    # ----- stage 0 -------------------------------------------------------
    def apply_srp_phat(self, mix_data: np.ndarray):
        """SRP-PHAT map + adaptive peak pruning -> candidate patches
        (reference: Mic_Array.py:152-194)."""
        self.spotforming_times = 0
        self.original_times = 0
        if self.prune_method == "SRP":
            self.srp.compute_map(mix_data)  # a device tensor is consumed as-is
        elif self.prune_method in BASELINE_MAPS:
            self.srp.srp_map = BASELINE_MAPS[self.prune_method](
                mix_data, self.geom, FREQ_BINS, N_FFT, device=self.device
            ).astype(np.float32)
            self.srp.max_power = float(self.srp.srp_map.max())
            self.srp.min_power = float(self.srp.srp_map.min())
        else:
            raise ValueError(f"unknown prune method {self.prune_method}")

        patch_list = self.srp.local_source_adaptive()
        simple_pos = np.zeros((3, 3))
        return patch_list, simple_pos

    # ----- stage 1 -------------------------------------------------------
    def spotform_big_patch(self, mix_data: np.ndarray, patch_list, spot_model,
                           sweep=None):
        """Coarse spotforming filter (reference: Mic_Array.py:196-222).
        `sweep` may carry the coarse sweep of `patch_list`, already queued,
        so that host work can run beside the device."""
        self.big_spotforming_times = len(patch_list)
        candidate_finished, powers_with_dis, relative_threshold = \
            binary_search_baseline(mix_data, spot_model, patch_list,
                                   self.mic_positions, sweep=sweep)
        self.relative_threshold = relative_threshold
        return candidate_finished

    def subdivide_patch(self, patch) -> list[Patch]:
        """Width-4 -> width-2 subdivision of one candidate (host-side; can
        run while a device sweep is in flight)."""
        return search_area([patch], self.mic_positions,
                           self.upper_bound_pairwise)

    # ----- stage 2 -------------------------------------------------------
    def spotform_small_patch_parallel(self, mix_data: np.ndarray,
                                      candidate_finished, spot_model,
                                      sample_gt=None, subdivided=None,
                                      full_mix=None):
        """Subdivide every big patch, run ONE combined strict spotforming
        sweep, then per-big-patch threshold + SI-SDR clustering
        (reference: Mic_Array.py:225-395).

        `subdivided`: optional dict id(patch) -> its subdivision, computed
        beside the coarse sweep; the other patches are subdivided here.

        `full_mix`: when the selection sweep ran on a cropped mixture
        (JointPipeline.sweep_crop_seconds), the full-length mixture — the
        few cluster heads are re-spotformed on it so NMS decisions and the
        output localization audio stay full-T."""
        if sample_gt is None:
            # Trace-only GT labels: eval scripts that enable
            # ACOUSTIC_TRACE_POWERS set `trace_sample_gt` on the processor
            # (callers like JointPipeline don't thread GT through the
            # production path).  Labels feed trace records exclusively —
            # no selection decision reads them.
            sample_gt = getattr(self, "trace_sample_gt", None)
        width_list0 = [2 for _ in range(self.num_mic - 1)]
        output_pair = []

        total_patch: list[Patch] = []
        patches_indexes = [0]
        init_area_total = []
        big_patch_center_total = []
        self.spotforming_times = 0

        if USE_RELATIVE_SPOT_POWER:
            spot_power_threshold = min(SPOT_POWER_THRESHOLD2,
                                       self.relative_threshold)
        else:
            spot_power_threshold = SPOT_POWER_THRESHOLD2

        # 2.1: subdivide and collect all small patches across big patches
        for i in range(len(candidate_finished)):
            key = id(candidate_finished[i])
            if subdivided is not None and key in subdivided:
                patch_processed = list(subdivided[key])
            else:
                patch_processed = self.subdivide_patch(candidate_finished[i])
            init_area_total.append(candidate_finished[i].area_points)

            patch_center0 = Patch(candidate_finished[i].sample_offset,
                                  width_list0, None,
                                  candidate_finished[i].peak_pos)
            big_patch_center_total.append(patch_center0.center_pos())
            patch_processed.append(patch_center0)

            self.spotforming_times += len(patch_processed)
            total_patch.extend(patch_processed)
            patches_indexes.append(self.spotforming_times)

        # One combined strict sweep over ALL small patches; waveforms stay on
        # device.  Selection uses power scalars; the greedy SI-SDR clustering
        # uses the on-device pairwise SI-SDR matrix — no waveform transfer.
        sweep = spot_model.sweep(mix_data, total_patch, strict=1,
                                 with_similarity=True)
        sim = sweep.sisdr_mat
        T = mix_data.shape[1]
        min_trigger_power2 = self.min_trigger_power / (3 * 48000) * T
        head_indices: list[int] = []  # global candidate ids needing audio
        pending: list[tuple] = []

        # 2.2: per-big-patch processing
        for i in range(len(patches_indexes) - 1):
            big_offset = candidate_finished[i].sample_offset
            big_label = -1
            if sample_gt is not None:
                for k in range(sample_gt.shape[1]):
                    if np.amax(np.abs(big_offset - sample_gt[:, k])) < 3.5:
                        big_label = k
                        break

            lo, hi = patches_indexes[i], patches_indexes[i + 1]
            patch_processed = total_patch[lo:hi]
            init_area = init_area_total[i]
            big_patch_center = big_patch_center_total[i]
            powers = sweep.powers[lo:hi]
            powers2 = sweep.powers_win[lo:hi]

            center = candidate_finished[i].center_pos()
            d = (np.linalg.norm(center - self.mic_positions[0])
                 if center is not None and center.shape[0] == 3 else 4.0)
            if power_trace.ENABLED:
                # sub_offsets/sub_powers_win let offline replays measure
                # retention at the small-patch level: a GT speaker on a big
                # patch's boundary (stride-4 SRP bucket off) still has a
                # subdivided width-2 patch near its true offsets, which the
                # big_offset-only record cannot show
                # (scripts/analyze_retention.py, round-4 finding).
                power_trace.record(
                    "fine",
                    big_offset=np.asarray(big_offset).tolist(),
                    max_power_win=float(np.amax(powers2)),
                    dis=float(d),
                    sub_offsets=[np.asarray(p.sample_offset).tolist()
                                 for p in patch_processed],
                    sub_powers_win=[float(x) for x in powers2])
            if np.amax(powers2) < spot_power_threshold / (1 + d):
                continue

            # Candidates that can participate in clustering
            passing = set()
            n_pass_p2 = 0
            for j in range(len(patch_processed)):
                d_id = np.linalg.norm(patch_processed[j].center_pos()
                                      - self.mic_positions[0])
                if powers2[j] >= spot_power_threshold / (1 + d_id):
                    n_pass_p2 += 1
                    if powers[j] >= min_trigger_power2:
                        passing.add(j)
            if power_trace.ENABLED:
                power_trace.record(
                    "fine_pass",
                    big_label=big_label,
                    n_sub=len(patch_processed),
                    n_pass_p2=n_pass_p2,
                    n_pass_trigger=len(passing),
                    max_power_full=float(np.amax(powers)),
                    min_trigger_power2=float(min_trigger_power2))
            if not passing:
                continue

            # SI-SDR greedy clustering within the big patch, decided from
            # the device-computed pairwise matrix (reference computes each
            # si_sdr on host waveforms, Mic_Array.py:353)
            sort_idx = np.argsort(-np.asarray(powers))
            SI_SDR_THRESHOLD = -4
            clusters: dict[int, list[int]] = {}
            for _id in sort_idx:
                if _id not in passing:
                    continue
                unique = True
                for cluster_id in clusters:
                    head = clusters[cluster_id][0]
                    if sim[lo + _id, lo + head] > SI_SDR_THRESHOLD:
                        clusters[head].append(_id)
                        unique = False
                        break
                if unique:
                    clusters[_id] = [_id]
            if power_trace.ENABLED:
                power_trace.record("fine_clusters", big_label=big_label,
                                   n_clusters=len(clusters))
            if len(clusters) <= 0:
                continue

            # merge cluster members into a center patch; audio fetched later
            for cluster_id in clusters:
                position, offsets = weight_mean_pos(patch_processed, powers,
                                                    clusters[cluster_id])
                patch_center = find_merge_center(offsets, init_area,
                                                 self.mic_positions,
                                                 big_patch_center)
                save_offsets = {
                    "audio_offset": patch_processed[cluster_id].sample_offset,
                    "localization_offset": offsets,
                }
                head_indices.append(lo + cluster_id)
                pending.append((patch_center, float(powers[cluster_id]),
                                f"{i}_{cluster_id}", save_offsets, big_label))

        # One batched transfer for all cluster heads' waveforms; keep the
        # head-pair SI-SDR submatrix for the NMS stage (free — already on
        # host from the sweep fetch).
        if full_mix is not None and head_indices:
            # Cropped-selection mode: one extra strict sweep over just the
            # heads (<= MAX_BIG_PATCH-ish, a single 32-bucket dispatch) on
            # the FULL mixture — NMS and output audio must be full-T, and
            # the head-pair SI-SDR matrix is recomputed there too.
            head_sweep = spot_model.sweep(
                full_mix, [total_patch[g] for g in head_indices], strict=1,
                with_similarity=True)
            audio_local = head_sweep.gather(range(len(head_indices)))
            audio = {g: audio_local[k] for k, g in enumerate(head_indices)}
            self._last_head_sim = head_sweep.sisdr_mat
            self.spotforming_times += len(head_indices)
        else:
            audio = sweep.gather(head_indices)
            self._last_head_sim = (
                sim[np.ix_(head_indices, head_indices)] if head_indices
                else None
            )
        # TDoA-consistency scores for the NMS stage (search/consistency.py):
        # computed only when tracing or when the opt-in gate is on — the
        # production default path pays nothing.
        if head_indices and (power_trace.ENABLED or NMS_TDOA_GATE > 0
                             or NMS_TDOA_ELECT):
            ref_mix = full_mix if full_mix is not None else mix_data
            devs = head_deviations(
                [audio[g] for g in head_indices], to_numpy(ref_mix),
                [p[3]["audio_offset"] for p in pending])
            for (_, _, _, save_offsets, _), dev in zip(pending, devs):
                save_offsets["tdoa_dev"] = dev
        for gidx, (patch_center, power, tag, save_offsets, big_label) in zip(
            head_indices, pending
        ):
            output_pair.append((patch_center, audio[gidx], power, tag,
                                save_offsets, big_label))
        return output_pair

    # ----- stage 3 -------------------------------------------------------
    def clustering_new(self, output_pair, simple_pos=None, sample_gt=None):
        """Final NMS (reference: Mic_Array.py:399-500).  Returns
        (audio_final, patch_final, total spotforming count, wrong list)."""
        pair_sisdr = getattr(self, "_last_head_sim", None)
        if pair_sisdr is not None and pair_sisdr.shape[0] != len(output_pair):
            pair_sisdr = None  # caller passed a different pair list
        audio_final, patch_final, wrong = clustering_nms(output_pair,
                                                         sample_gt=sample_gt,
                                                         pair_sisdr=pair_sisdr)
        return (audio_final, patch_final,
                self.big_spotforming_times + self.spotforming_times, wrong)

    # Reference-style aliases (public API compatibility, BASELINE.json)
    Apply_SRP_PHAT = apply_srp_phat
    Spotform_Big_Patch = spotform_big_patch
    Spotform_Small_Patch_Parallel = spotform_small_patch_parallel
    Clustering_new = clustering_new
