"""SRP-PHAT pruning engine: map -> adaptive peaks -> candidate patches.

Port of the JAX package's `search/srp_pruning.py`: the map runs on the
port's device (ops/srp.py), the peak and patch logic is the same host NumPy.

Counterpart of the inference-time half of
reference sep/Traditional_SP/SRP_Prunning.py (the setup half lives in
dsp/geometry.py; the map computation in ops/srp.py):

- `find_valid_peaks`: adaptive dual-threshold 5x5x2 local-maxima detection
  over the 3D power map (reference: find_valid_peak_new, :500-544), fully
  vectorized.
- `local_source_adaptive`: greedy, power-ordered clustering of SRP peaks
  into width-8 TDoA hypercubes with occupancy shrink against already
  accepted patches (reference: :547-643).  This is inherently sequential
  over tens of peaks, so it stays host-side and consumes device-computed
  predicates.
"""
from __future__ import annotations

import numpy as np

from ..constants import FREQ_BINS, FS, INIT_WIDTH, N_FFT
from ..dsp.geometry import TdoaGeometry
from ..dsp.patch import (Patch, hyperbola_area_init_lazy,
                         hyperbola_area_sample)
from ..ops.srp import SrpMapComputer, srp_window_size

ERR_TOLERANCE = 0.2  # reference: SRP_Prunning.py:17


class SrpEngine:
    """Holds the geometry, steering tables and thresholds for one array."""

    def __init__(
        self,
        geom: TdoaGeometry,
        threshold=(0.15, 0.015, 0.05),
        width: int = INIT_WIDTH,
        freq_bins=FREQ_BINS,
        fs: int = FS,
        n_fft: int = N_FFT,
        device="cuda",
    ):
        self.geom = geom
        self.threshold = threshold
        self.width = width
        self.computer = SrpMapComputer(geom.grids, geom.mic_pos, freq_bins,
                                       fs, n_fft, device=device)
        self.srp_map = np.zeros(geom.num_clusters, dtype=np.float32)
        self.max_power = 0.0
        self.min_power = 0.0

    def compute_map(self, signal: np.ndarray, window: int | None = None) -> np.ndarray:
        """Run the on-device SRP map and fill host-side state."""
        if window is None:
            window = srp_window_size(signal.shape[1])
        self.srp_map = self.computer(signal, window).cpu().numpy()
        self.max_power = float(self.srp_map.max())
        self.min_power = float(self.srp_map.min())
        return self.srp_map

    @property
    def power_map(self) -> np.ndarray:
        """3D power map: map value of each cell's cluster (0 for invalid),
        replacing fill_powermap (SRP_Prunning.py:347-364)."""
        idx = self.geom.cluster_index
        pm = np.where(idx >= 0, self.srp_map[np.maximum(idx, 0)], 0.0)
        return pm

    def find_valid_peaks(self, ratio: float = 4.0) -> list[int]:
        """Adaptive dual-threshold local maxima -> unique cluster ids
        (reference: find_valid_peak_new, SRP_Prunning.py:500-544)."""
        t0, t_lo, t_hi = self.threshold
        threshold = float(np.clip(t0 * self.max_power, t_lo, t_hi))
        threshold2 = threshold * ratio

        power = self.power_map
        NX, NY, NZ = power.shape
        center = power[2:-2, 2:-2, 1:-1]

        dis = self.geom.dis_matrix[2:-2, 2:-2]
        thrds = threshold * (0.9 + 1.0 / dis)[:, :, None]
        thrds2 = threshold2 * (1.0 + 1.0 / dis)[:, :, None]

        is_local_max = np.ones_like(center, dtype=bool)
        for dx in range(-2, 3):
            for dy in range(-2, 3):
                for dz in range(-1, 1):
                    if dx == 0 and dy == 0 and dz == 0:
                        continue
                    shifted = power[2 + dx : NX - 2 + dx,
                                    2 + dy : NY - 2 + dy,
                                    1 + dz : NZ - 1 + dz]
                    is_local_max &= center >= shifted

        cond2 = is_local_max & (center > thrds) & (center <= thrds2)
        cond1 = center > thrds2
        maxima = cond1 | cond2

        idx3 = np.transpose(np.nonzero(maxima))
        cluster_idx = self.geom.cluster_index
        peaks: list[int] = []
        seen = set()
        for ix, iy, iz in idx3:
            cid = int(cluster_idx[ix + 2, iy + 2, iz + 1])
            if cid < 0 or cid in seen:
                continue
            seen.add(cid)
            peaks.append(cid)
        return peaks

    def local_source_adaptive(self) -> list[Patch]:
        """Greedy peak -> patch clustering with occupancy shrink
        (reference: SRP_Prunning.py:547-643)."""
        geom = self.geom
        peak_index = self.find_valid_peaks()
        peaks = self.srp_map[peak_index]
        peaks_pos = geom.grids[peak_index]
        peaks_sample = geom.cluster_offsets[peak_index].astype(np.float64)
        order = np.argsort(-peaks)
        visited = np.zeros_like(peaks)

        num_pair = geom.num_mic - 1
        begin_width = self.width
        patch_candidate: list[Patch] = []
        peak_candidate = []

        for _id in order:
            if visited[_id] >= 1:
                continue
            candidate = peaks_pos[_id]
            sample_offsets = peaks_sample[_id]
            peak_candidate.append(candidate)

            occupy = np.ones((num_pair, begin_width))
            strict_bound = 0

            for p in patch_candidate:
                delta_offsets = p.sample_offset - sample_offsets
                range_low = -begin_width / 2
                range_high = begin_width / 2
                range_low1 = delta_offsets - p.width_list / 2 + strict_bound
                range_high1 = delta_offsets + p.width_list / 2 - strict_bound

                delta1 = int(round((range_low1 - range_high).max()))
                delta2 = int(round((range_high1 - range_low).min()))
                if delta1 >= 0 or delta2 <= 0:
                    continue
                elif delta1 < 0:
                    if begin_width + delta1 < 0:
                        occupy[:, :] = 0
                    else:
                        occupy[:, begin_width + delta1 :] = 0
                elif delta2 > 0:
                    if delta2 > begin_width:
                        occupy[:, :] = 0
                    else:
                        occupy[:, 0:delta2] = 0

            width_list_new = []
            sample_offset_new = []
            all_discard = False
            for i in range(num_pair):
                index_1 = np.where(occupy[i])[0]
                if index_1.shape[0] == 0:
                    all_discard = True
                    break
                width_list_new.append(index_1.shape[0])
                new_offset = int(round(
                    sample_offsets[i]
                    + (index_1[0] + index_1[-1] - begin_width + 1) / 2
                ))
                sample_offset_new.append(new_offset)
            if all_discard:
                continue

            # Mark peaks covered by this patch as visited
            included = hyperbola_area_sample(
                peaks_sample, sample_offsets,
                begin_width - 2 * strict_bound + ERR_TOLERANCE,
            )
            visited += included

            width_list_new = np.array(width_list_new, dtype=np.float64)
            sample_offset_new = np.array(sample_offset_new, dtype=np.float64)
            # Lazy: the 5 cm screen decides survival now; the ~0.1 s/patch
            # 1 cm materialization resolves on first area_points access,
            # which happens during subdivision while the coarse sweep runs.
            init_area = hyperbola_area_init_lazy(
                geom, sample_offset_new, width_list_new[0] + ERR_TOLERANCE
            )
            if init_area is None:
                continue
            patch_candidate.append(
                Patch(sample_offset_new, width_list_new, init_area, candidate)
            )

        self.peak_candidate = np.array(peak_candidate)
        return patch_candidate
