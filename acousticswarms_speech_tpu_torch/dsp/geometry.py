"""3D-grid <-> TDoA-space mapping, fully vectorized.

Host NumPy, copied from the JAX package's `dsp/geometry.py` for the PyTorch port
(the port imports nothing of that package).

Redesign of the reference's setup stage
(reference sep/Traditional_SP/SRP_Prunning.py:101-344):

- `Map_3D_TDoA`'s pure-Python triple loop over (Lx, Ly, Lz) grid cells
  (SRP_Prunning.py:315-331) becomes one broadcast distance computation.
- The BFS grid clustering (`search_cluster`, SRP_Prunning.py:277-313 — group
  26-connected cells with identical resolution-rounded TDoA vectors) becomes
  a sparse-graph connected-components pass (scipy.csgraph), with labels
  renumbered in C-scan order of their first member cell to preserve the
  reference's cluster ordering.
- The result is cached to disk keyed by a geometry hash, replacing the
  pickle cache (SRP_Prunning.py:184-217).

Everything here is one-time per array geometry and explicitly excluded from
inference time by the reference's own measurement protocol (README.md:144).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from ..constants import FS, SPEED_OF_SOUND


@dataclasses.dataclass
class TdoaGeometry:
    """Precomputed search-space geometry for one microphone configuration."""

    mic_pos: np.ndarray          # (M, 3)
    range_spk: np.ndarray        # [xmin, xmax, ymin, ymax, zmin, zmax]
    grid_size: float
    grid_size_z: float
    sample_resolution: int

    x_grids: np.ndarray          # (Lx,)
    y_grids: np.ndarray          # (Ly,)
    z_grids: np.ndarray          # (Lz,)
    valid: np.ndarray            # (Lx, Ly, Lz) bool
    cluster_index: np.ndarray    # (Lx, Ly, Lz) int32; -1 for invalid cells
    cluster_offsets: np.ndarray  # (G, M-1) int32 resolution-rounded TDoAs
    grids: np.ndarray            # (G, 3) cluster centroid positions
    dis_matrix: np.ndarray       # (Lx, Ly) distance of each xy cell to array center
    array_border: np.ndarray     # [minx, miny, maxx, maxy] keepout box

    # Coarse 5 cm grid used to bound patch membership areas
    # (SRP_Prunning.py:148-155); the fine 1 cm grid's members of a box are
    # computed on demand per bounding box via `fine_members` (the reference
    # precomputes the whole room, SRP_Prunning.py:156-170).
    pos5: np.ndarray             # (Ny5, Nx5, Nz, 3)
    off5: np.ndarray             # (Ny5, Nx5, Nz, M-1) float32

    @property
    def num_mic(self) -> int:
        return self.mic_pos.shape[0]

    @property
    def num_clusters(self) -> int:
        return self.grids.shape[0]

    @property
    def axis_range(self):
        r = self.range_spk
        return [[r[0], r[1]], [r[2], r[3]], [r[4], r[5]]]

    def fine_members(self, xi0: int, xi1: int, yi0: int, yi1: int,
                     lo: np.ndarray, hi: np.ndarray):
        """The points of the room's 1 cm grid in the index window
        [yi0:yi1, xi0:xi1] whose float32 TDoA offsets lie in [lo, hi] on
        every pair, in the window's C order over its 'xy' meshgrid
        (Ny, Nx, Nz): (N, 3) float32 positions and their float64 offsets
        (M-1, N), which equal `utils.shift.sample_offsets_for` of the
        positions.  The float32 offsets are those of `_tdoa_field` over the
        window's positions (the whole-room grid the reference precomputes,
        cropped), to the bit.

        The distances come from per-axis float64 squares (M, Nx), (M, Ny),
        (M, Nz) of the float32 coordinates, summed as (dx² + dy²) + dz²,
        the order of `np.linalg.norm` over the last axis, so no
        (..., M, 3) differences are formed.  Pair by pair: the first pair's
        offsets cover the window, each later pair's only the points that
        passed the pairs before it."""
        r = self.range_spk
        x = (r[0] + 0.01 * np.arange(xi0, xi1)).astype(np.float32)
        y = (r[2] + 0.01 * np.arange(yi0, yi1)).astype(np.float32)
        z = np.arange(r[4], r[5], 0.1).astype(np.float32)
        dx2, dy2, dz2 = (np.square(a.astype(np.float64)[None, :]
                                   - self.mic_pos[:, k, None])
                         for k, a in enumerate((x, y, z)))
        # bounds as 1-element float64 arrays: the float32 offsets compare
        # in float64 under any NumPy's promotion rules (NumPy 1 casts a
        # float64 scalar to float32 there)
        lo = np.asarray(lo, dtype=np.float64)[:, None]
        hi = np.asarray(hi, dtype=np.float64)[:, None]

        def window_distance(m):  # (Ny * Nx * Nz,)
            d = (dx2[m][None, :] + dy2[m][:, None])[..., None] + dz2[m]
            return np.sqrt(d, out=d).ravel()

        def passes(off, j):
            f32 = off.astype(np.float32)
            return (f32 >= lo[j]) & (f32 <= hi[j])

        d0 = window_distance(0)
        off = (window_distance(1) - d0) / SPEED_OF_SOUND * FS
        cells = np.flatnonzero(passes(off, 0))
        offs = [off[cells]]
        d0 = d0[cells]
        iy, ix, iz = np.unravel_index(cells, (y.shape[0], x.shape[0],
                                              z.shape[0]))
        for j in range(1, lo.shape[0]):
            dj = np.sqrt((dx2[j + 1][ix] + dy2[j + 1][iy]) + dz2[j + 1][iz])
            off = (dj - d0) / SPEED_OF_SOUND * FS
            keep = np.flatnonzero(passes(off, j))
            offs = [o[keep] for o in offs] + [off[keep]]
            d0, iy, ix, iz = d0[keep], iy[keep], ix[keep], iz[keep]
        pts = np.stack((x[ix], y[iy], z[iz]), axis=1)
        return pts, np.stack(offs)

    def fine_block(self, xi0: int, xi1: int, yi0: int, yi1: int):
        """1 cm-grid positions (Ny, Nx, Nz, 3) and float32 TDoA offsets
        (Ny, Nx, Nz, M-1) of the whole index window [yi0:yi1, xi0:xi1]:
        `fine_members` with open bounds."""
        edge = np.full(self.num_mic - 1, np.inf)
        pts, off = self.fine_members(xi0, xi1, yi0, yi1, -edge, edge)
        shape = (yi1 - yi0, xi1 - xi0, -1)
        return (pts.reshape(*shape, 3),
                off.T.astype(np.float32).reshape(*shape, off.shape[0]))


def _tdoa_field(pos: np.ndarray, mic_pos: np.ndarray, fs: int = FS,
                c: float = SPEED_OF_SOUND) -> np.ndarray:
    """TDoA (samples) of each position vs the reference mic.

    pos: (..., 3); mic_pos: (M, 3).  Returns (..., M-1)."""
    d = np.linalg.norm(pos[..., None, :] - mic_pos[None, :], axis=-1)
    return (d[..., 1:] - d[..., :1]) / c * fs


def _fine_grid(range_spk, step_xy: float, mic_pos: np.ndarray):
    xx = np.arange(range_spk[0], range_spk[1], step_xy)
    yy = np.arange(range_spk[2], range_spk[3], step_xy)
    zz = np.arange(range_spk[4], range_spk[5], 0.1)
    X, Y, Z = np.meshgrid(xx, yy, zz)  # 'xy' indexing: (Ny, Nx, Nz)
    pos = np.stack((X, Y, Z), axis=3).astype(np.float32)
    off = _tdoa_field(pos.astype(np.float64), mic_pos).astype(np.float32)
    return pos, off


def geometry_hash(mic_pos: np.ndarray, range_spk, grid_size: float,
                  grid_size_z: float, sample_resolution: int) -> str:
    h = hashlib.sha256()
    h.update(np.asarray(mic_pos, dtype=np.float64).tobytes())
    h.update(np.asarray(range_spk, dtype=np.float64).tobytes())
    h.update(np.asarray([grid_size, grid_size_z, sample_resolution]).tobytes())
    return h.hexdigest()[:16]


def build_geometry(
    mic_pos: np.ndarray,
    range_spk,
    grid_size: float = 0.05,
    grid_size_z: float = 0.1,
    sample_resolution: int = 4,
    keepout: float = 0.2,
    cache_dir: str | None = None,
) -> TdoaGeometry:
    mic_pos = np.asarray(mic_pos, dtype=np.float64)
    if mic_pos.shape[1] == 2:
        mic_pos = np.concatenate([mic_pos, np.zeros((mic_pos.shape[0], 1))], axis=1)
    range_spk = np.asarray(range_spk, dtype=np.float64)

    cache_path = None
    if cache_dir is not None:
        key = geometry_hash(mic_pos, range_spk, grid_size, grid_size_z,
                            sample_resolution)
        cache_path = os.path.join(cache_dir, f"tdoa_geometry_{key}.npz")
        if os.path.exists(cache_path):
            try:
                return _load_cache(cache_path, mic_pos, range_spk, grid_size,
                                   grid_size_z, sample_resolution)
            except Exception:
                # corrupt/truncated cache (e.g. writer killed mid-save):
                # fall through and rebuild + overwrite
                pass

    x_grids = np.arange(range_spk[0], range_spk[1], grid_size)
    y_grids = np.arange(range_spk[2], range_spk[3], grid_size)
    z_grids = np.arange(range_spk[4], range_spk[5], grid_size_z)
    Lx, Ly, Lz = len(x_grids), len(y_grids), len(z_grids)

    # Keepout box around the array (SRP_Prunning.py:173-180).
    border = np.array([
        mic_pos[:, 0].min() - keepout,
        mic_pos[:, 1].min() - keepout,
        mic_pos[:, 0].max() + keepout,
        mic_pos[:, 1].max() + keepout,
    ])
    inside = (
        (x_grids[:, None] > border[0]) & (x_grids[:, None] < border[2])
        & (y_grids[None, :] > border[1]) & (y_grids[None, :] < border[3])
    )
    valid = np.broadcast_to(~inside[:, :, None], (Lx, Ly, Lz)).copy()

    # All cell positions and rounded TDoA vectors at once.
    pos = np.stack(np.meshgrid(x_grids, y_grids, z_grids, indexing="ij"), axis=3)
    off = _tdoa_field(pos, mic_pos)
    off_round = (np.round(off / sample_resolution) * sample_resolution).astype(np.int32)

    cluster_index = _label_clusters(valid, off_round)
    G = cluster_index.max() + 1

    # Per-cluster rounded offsets and centroid positions.
    flat_idx = cluster_index.ravel()
    member = flat_idx >= 0
    flat_members = flat_idx[member]
    cluster_offsets = np.zeros((G, off_round.shape[-1]), dtype=np.int32)
    cluster_offsets[flat_members] = off_round.reshape(-1, off_round.shape[-1])[member]
    counts = np.bincount(flat_members, minlength=G).astype(np.float64)
    grids = np.zeros((G, 3))
    for a in range(3):
        grids[:, a] = (
            np.bincount(flat_members, weights=pos[..., a].ravel()[member], minlength=G)
            / counts
        )

    mic_center = mic_pos.mean(0)
    dis_matrix = (
        np.linalg.norm(
            np.stack(np.meshgrid(x_grids, y_grids, indexing="ij"), axis=-1)
            - mic_center[:2],
            axis=-1,
        )
        + 1e-8
    )

    pos5, off5 = _fine_grid(range_spk, 0.05, mic_pos)

    geom = TdoaGeometry(
        mic_pos=mic_pos, range_spk=range_spk, grid_size=grid_size,
        grid_size_z=grid_size_z, sample_resolution=sample_resolution,
        x_grids=x_grids, y_grids=y_grids, z_grids=z_grids, valid=valid,
        cluster_index=cluster_index.astype(np.int32),
        cluster_offsets=cluster_offsets, grids=grids, dis_matrix=dis_matrix,
        array_border=border, pos5=pos5, off5=off5,
    )

    if cache_path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        tmp_path = cache_path + f".tmp{os.getpid()}.npz"
        np.savez_compressed(
            tmp_path,
            x_grids=x_grids, y_grids=y_grids, z_grids=z_grids, valid=valid,
            cluster_index=geom.cluster_index, cluster_offsets=cluster_offsets,
            grids=grids, dis_matrix=dis_matrix, array_border=border,
            pos5=pos5, off5=off5,
        )
        # atomic publish: a killed writer never leaves a truncated cache
        os.replace(tmp_path, cache_path)
    return geom


def _load_cache(path, mic_pos, range_spk, grid_size, grid_size_z,
                sample_resolution) -> TdoaGeometry:
    z = np.load(path)
    return TdoaGeometry(
        mic_pos=mic_pos, range_spk=range_spk, grid_size=grid_size,
        grid_size_z=grid_size_z, sample_resolution=sample_resolution,
        x_grids=z["x_grids"], y_grids=z["y_grids"], z_grids=z["z_grids"],
        valid=z["valid"], cluster_index=z["cluster_index"],
        cluster_offsets=z["cluster_offsets"], grids=z["grids"],
        dis_matrix=z["dis_matrix"], array_border=z["array_border"],
        pos5=z["pos5"], off5=z["off5"],
    )


def _label_clusters(valid: np.ndarray, off_round: np.ndarray) -> np.ndarray:
    """Connected components (26-neighborhood) of equal-TDoA valid cells.

    Returns an (Lx, Ly, Lz) int array of cluster ids (-1 for invalid cells),
    numbered by first appearance in C-scan order — the same ordering the
    reference's sequential BFS produces."""
    Lx, Ly, Lz = valid.shape
    n = Lx * Ly * Lz
    lin = np.arange(n).reshape(Lx, Ly, Lz)

    rows = []
    cols = []
    # 13 unique neighbor directions of the 26-neighborhood.
    directions = [
        (dx, dy, dz)
        for dx in (-1, 0, 1)
        for dy in (-1, 0, 1)
        for dz in (-1, 0, 1)
        if (dx, dy, dz) > (0, 0, 0)
    ]
    for dx, dy, dz in directions:
        sl_a = (
            slice(max(0, -dx), Lx - max(0, dx)),
            slice(max(0, -dy), Ly - max(0, dy)),
            slice(max(0, -dz), Lz - max(0, dz)),
        )
        sl_b = (
            slice(max(0, dx), Lx - max(0, -dx)),
            slice(max(0, dy), Ly - max(0, -dy)),
            slice(max(0, dz), Lz - max(0, -dz)),
        )
        both_valid = valid[sl_a] & valid[sl_b]
        same = np.all(off_round[sl_a] == off_round[sl_b], axis=-1) & both_valid
        rows.append(lin[sl_a][same])
        cols.append(lin[sl_b][same])

    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    graph = coo_matrix(
        (np.ones(len(rows), dtype=np.int8), (rows, cols)), shape=(n, n)
    )
    n_comp, labels = connected_components(graph, directed=False)

    labels = labels.reshape(Lx, Ly, Lz)
    out = np.full((Lx, Ly, Lz), -1, dtype=np.int64)

    # Renumber components by first C-scan appearance among valid cells.
    flat_labels = labels.ravel()
    flat_valid = valid.ravel()
    valid_labels = flat_labels[flat_valid]
    vals, first_idx = np.unique(valid_labels, return_index=True)
    rank = np.empty(len(vals), dtype=np.int64)
    rank[np.argsort(first_idx)] = np.arange(len(vals))
    order = np.full(n_comp, -1, dtype=np.int64)
    order[vals] = rank
    out.ravel()[flat_valid] = order[valid_labels]
    return out
