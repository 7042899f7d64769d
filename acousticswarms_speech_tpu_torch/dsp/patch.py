"""TDoA hypercube ("Patch") geometry.

Host NumPy, copied from the JAX package's `dsp/patch.py` for the PyTorch port
(the port imports nothing of that package).

Counterpart of reference sep/Traditional_SP/Patch_3D.py.  A patch is an
axis-aligned box in (M-1)-dimensional TDoA space: a center `sample_offset`,
per-pair `width_list`, and the member 3D grid points (`area_points`, stored
as a (3, N) array like the reference).  Predicates are vectorized numpy; the
candidate *sweep* over patches happens on device (see search/spotform.py)
where patches are rows of a fixed-size offsets tensor.
"""
from __future__ import annotations

import numpy as np

from ..constants import FS, SPEED_OF_SOUND


class Patch:
    def __init__(self, sample_offset, width_list, area_points, peak_pos=None):
        self.sample_offset = np.asarray(sample_offset, dtype=np.float64)
        self.width_list = np.array(width_list, dtype=np.float64, copy=True)
        self.area_points = area_points  # (3, N), None, or zero-arg callable
        self.num_pair = self.sample_offset.shape[0]
        self.peak_pos = peak_pos

    @property
    def area_points(self):
        """Member 3D points (3, N).  May be a deferred thunk
        (hyperbola_area_init_lazy) resolved on first access — the pipeline
        creates patches during SRP pruning but only touches their points
        during subdivision, which runs while the coarse sweep occupies the
        device, so the ~0.1 s/patch 1 cm materialization overlaps compute."""
        if callable(self._area_points):
            self._area_points = self._area_points()
        return self._area_points

    @area_points.setter
    def area_points(self, value):
        self._area_points = value

    def area_size(self) -> int:
        if self.area_points is None or self.area_points.shape[1] == 0:
            return 0
        return self.area_points.shape[1]

    def center_pos(self):
        if self.peak_pos is not None:
            return self.peak_pos
        if self.area_points is None or self.area_points.shape[1] == 0:
            return None
        return np.mean(self.area_points, axis=1)

    def hyperbola_general_area(self, X, Y, Z, mic_position, sound_speed=SPEED_OF_SOUND,
                               fs=FS) -> np.ndarray:
        """Membership of arbitrary 3D points, computed from geometry
        (Patch_3D.py:28-38)."""
        pts = np.stack([X, Y, Z], axis=-1)
        d = np.linalg.norm(pts[..., None, :] - mic_position[None, :, :], axis=-1)
        off = (d[..., 1:] - d[..., :1]) / sound_speed * fs  # (..., M-1)
        lo = self.sample_offset - self.width_list / 2 - 1e-3
        hi = self.sample_offset + self.width_list / 2 + 1e-3
        z = np.all((off >= lo) & (off <= hi), axis=-1)
        return z.astype(int)

    def hyperbola_sample(self, offset: np.ndarray) -> np.ndarray:
        """Membership of precomputed TDoA samples; offset: (M-1, N)
        (Patch_3D.py:40-47)."""
        lo = self.sample_offset[:, None] - self.width_list[:, None] / 2 - 1e-3
        hi = self.sample_offset[:, None] + self.width_list[:, None] / 2 + 1e-3
        z = np.all((offset >= lo) & (offset <= hi), axis=0)
        return z.astype(int)

    def check_gt(self, sample_offsets_gt: np.ndarray) -> bool:
        """True iff any GT speaker TDoA column lies inside (within width/2+1)
        (Patch_3D.py:50-66)."""
        delta = np.abs(sample_offsets_gt - self.sample_offset[:, None])
        return bool(np.any(np.all(delta <= self.width_list[:, None] / 2 + 1, axis=0)))

    def check_out(self, upper_bound_pairwise: np.ndarray) -> None:
        """Shrink the patch toward physical TDoA bounds (Patch_3D.py:69-87)."""
        for i in range(self.num_pair):
            upper_bound = upper_bound_pairwise[i]
            while not (abs(self.sample_offset[i]) <= upper_bound
                       or self.width_list[i] <= 4):
                resolution = self.width_list[i]
                if self.sample_offset[i] > upper_bound:
                    self.sample_offset[i] -= resolution / 4
                elif self.sample_offset[i] < -upper_bound:
                    self.sample_offset[i] += resolution / 4
                self.width_list[i] = resolution / 2

    def check_ready_spotforming(self, min_tolerance: float):
        for i in range(self.num_pair):
            if self.width_list[i] > min_tolerance:
                return False, i
        return True, -1

    # Reference-style alias (Patch_3D.py:89)
    check_ready_Spotforming = check_ready_spotforming


def hyperbola_area_sample(sample_list: np.ndarray, sample_offsets: np.ndarray,
                          width: float) -> np.ndarray:
    """L-inf box membership with a scalar width for all pairs; sample_list is
    (N, M-1) (reference: SRP_Prunning.py:30-39)."""
    lo = sample_offsets - width / 2
    hi = sample_offsets + width / 2
    z = np.all((sample_list >= lo) & (sample_list <= hi), axis=-1)
    return z.astype(int)


def hyperbola_area_init_lazy(geom, sample_offsets: np.ndarray, width: float):
    """Screen a patch on the coarse 5 cm grid now; defer the 1 cm member-point
    materialization to a thunk (reference: SRP_Prunning.py:41-61).

    Returns None when the 5 cm pass is empty (the patch would be discarded),
    else a zero-arg callable producing the (3, N) member points.  The split
    lets SRP pruning finish ~0.1 s/patch sooner per patch; the thunk resolves
    during subdivision, overlapped with the coarse device sweep.

    Note the reference uses a scalar width (the first pair's width + err
    tolerance) for all pairs; we keep that contract."""
    lo = sample_offsets - width / 2
    hi = sample_offsets + width / 2

    in5 = np.all((geom.off5 >= lo) & (geom.off5 <= hi), axis=-1)
    pts5 = geom.pos5[in5]
    if pts5.shape[0] == 0:
        return None

    def materialize():
        ar = geom.axis_range
        x_min = max(ar[0][0], pts5[:, 0].min() - 0.05)
        x_max = min(ar[0][1], pts5[:, 0].max() + 0.05)
        y_min = max(ar[1][0], pts5[:, 1].min() - 0.05)
        y_max = min(ar[1][1], pts5[:, 1].max() + 0.05)
        xi0 = int(np.floor((x_min - ar[0][0]) / 0.01))
        xi1 = int(np.ceil((x_max - ar[0][0]) / 0.01))
        yi0 = int(np.floor((y_min - ar[1][0]) / 0.01))
        yi1 = int(np.ceil((y_max - ar[1][0]) / 0.01))

        # 1 cm grid inside the bounding box only: the reference precomputes
        # the whole-room 1 cm TDoA field up front (SRP_Prunning.py:156-170,
        # ~10 s and tens of MB per room); computing the cropped block on
        # demand gives the same points at a fraction of the setup cost.
        pos1, off1 = geom.fine_block(xi0, xi1, yi0, yi1)
        in1 = np.all((off1 >= lo) & (off1 <= hi), axis=-1)
        pts = pos1[in1]
        if pts.shape[0] == 0:
            # Lattice-edge corner case: the 5 cm members sit exactly on the
            # half-open fine-block boundary.  They are genuine member points
            # (the 5 cm lattice is a subset of the 1 cm lattice), so use them.
            return pts5.T.copy()
        return pts.T

    return materialize


def hyperbola_area_init(geom, sample_offsets: np.ndarray, width: float):
    """Eager variant of hyperbola_area_init_lazy: (3, N) points or None."""
    thunk = hyperbola_area_init_lazy(geom, sample_offsets, width)
    return None if thunk is None else thunk()
