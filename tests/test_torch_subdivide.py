"""The port's subdivision of one candidate against the JAX package's, on the
CPU, leaf for leaf: the 1 cm member points (built from per-axis terms, with
their float64 TDoA kept for the split recursion) and the array-at-a-time
split recursion, on the release table array and on a 10-mic geometry; and
the 1 cm member points and their TDoA against the whole-grid formula."""
import copy
import dataclasses

import numpy as np
import pytest

from acousticswarms_speech_tpu.dsp.geometry import (
    build_geometry as jax_build_geometry,
)
from acousticswarms_speech_tpu.dsp.patch import Patch as JaxPatch
from acousticswarms_speech_tpu.dsp.patch import (
    hyperbola_area_init as jax_hyperbola_area_init,
)
from acousticswarms_speech_tpu.search.subdivide import (
    search_area as jax_search_area,
)
from acousticswarms_speech_tpu_torch.constants import FS, MIN_AREA
from acousticswarms_speech_tpu_torch.dsp import geometry
from acousticswarms_speech_tpu_torch.dsp.patch import (
    Patch,
    hyperbola_area_init_lazy,
)
from acousticswarms_speech_tpu_torch.pipeline.mic_array import MicArray
from acousticswarms_speech_tpu_torch.scripts import bench
from acousticswarms_speech_tpu_torch.search import subdivide
from acousticswarms_speech_tpu_torch.utils.shift import sample_offsets_for

import test_many_mics

ARRAYS = {
    "release7": (bench.MIC_POS, bench.ROI),
    "mics10": (test_many_mics.MIC, test_many_mics.ROI),
}


@pytest.fixture(scope="module")
def arrays(tmp_path_factory):
    """Per array: the port's MicArray and the JAX package's geometry, on one
    geometry cache (the 5 cm and 1 cm grids do not depend on grid_size)."""
    out = {}
    for name, (mic, roi) in ARRAYS.items():
        cache = str(tmp_path_factory.mktemp(name))
        jax_geom = jax_build_geometry(mic, roi, grid_size=0.2, cache_dir=cache)
        arr = MicArray(mic, spk_range=roi, grid_size=0.2, cache_dir=cache,
                       device="cpu")
        out[name] = arr, jax_geom
    return out


def _source_offsets(arr, src):
    return np.round(sample_offsets_for(src, arr.mic_positions, FS)[0])


def _case(kind, arr, jax_geom):
    """(port geometry, JAX geometry, patch offsets, per-pair widths, offsets
    and scalar width of the member-point box) of one kind of candidate."""
    geom = arr.geom
    P = arr.num_mic - 1
    roi = np.asarray(arr.range_spk)

    def at(fx, fy):  # a source at fractions of the ROI's x and y, 0.35 m up
        return _source_offsets(arr, np.array([
            roi[0] + fx * (roi[1] - roi[0]), roi[2] + fy * (roi[3] - roi[2]),
            0.35]))

    if kind == "typical":  # a stage-0 candidate: width 8, its 8.2 box
        o = at(0.15, 0.85)
        return geom, jax_geom, o, [8.0] * P, o, 8.2
    if kind == "shrunk":  # occupancy-shrunk widths, as pruning leaves them
        o = at(0.8, 0.75)
        w = [8.0, 6.0, 7.0, 5.0, 8.0, 6.0, 8.0, 7.0, 5.0][:P]
        return geom, jax_geom, o, w, o, w[0] + 0.2
    if kind == "beyond_bound":
        # the pair with the largest TDoA in the room, offset past its
        # physical bound: check_out halves it back inside
        j = int(np.argmax(geom.off5.reshape(-1, P).max(axis=0)
                          - arr.upper_bound_pairwise))
        cell = np.argmax(geom.off5[..., j])
        o = np.round(geom.off5.reshape(-1, P)[cell].astype(np.float64))
        po = o.copy()
        po[j] = arr.upper_bound_pairwise[j] + 1.0
        w = [8.0] * P
        w[j] = 64.0
        return geom, jax_geom, po, w, o, 8.2
    if kind == "sparse":  # under MIN_AREA points: halves left empty
        cell = tuple(n // 2 for n in geom.off5.shape[:3])
        box_o = geom.off5[cell].astype(np.float64)
        return geom, jax_geom, np.round(box_o), [8.0] * P, box_o, 0.7
    if kind == "crowded_width4":  # > MIN_AREA points, no pair can split
        o = at(0.5, 0.85)
        return geom, jax_geom, o, [4.0] * P, o, 4.2
    if kind == "tight_bound":  # width 16, each bound 1 past its offset:
        # check_out moves the outer halves, and points fall outside them
        o = at(0.15, 0.85)
        return geom, jax_geom, o, [16.0] * P, o, 16.2
    assert kind == "lattice_edge"
    # One 5 cm cell moved half a centimetre off the 1 cm lattice, as a
    # lattice whose 5 cm and 1 cm coordinates round apart would place it:
    # a zero-width box holds it on the 5 cm grid and no 1 cm point.
    iy, ix, iz = (s // 3 for s in geom.off5.shape[:3])
    pos5, off5 = geom.pos5.copy(), geom.off5.copy()
    pos5[iy, ix, iz, 0] += np.float32(0.005)
    off5[iy, ix, iz] = geometry._tdoa_field(
        pos5[iy, ix, iz].astype(np.float64), geom.mic_pos).astype(np.float32)
    o = off5[iy, ix, iz].astype(np.float64)
    return (dataclasses.replace(geom, pos5=pos5, off5=off5),
            dataclasses.replace(jax_geom, pos5=pos5.copy(), off5=off5.copy()),
            np.round(o), [8.0] * P, o, 0.0)


CASES = [(a, k) for a in ARRAYS
         for k in ("typical", "shrunk", "beyond_bound", "sparse",
                   "crowded_width4")] + [("mics10", "lattice_edge"),
                                         ("release7", "tight_bound")]


@pytest.mark.parametrize("array,kind", CASES,
                         ids=[f"{a}-{k}" for a, k in CASES])
def test_subdivide_patch_matches_jax(arrays, monkeypatch, array, kind):
    """MicArray.subdivide_patch (member points and recursion) against the JAX
    package's hyperbola_area_init + search_area: the same leaves in the
    same order, with equal offsets, widths, points and float32 centres, and
    the candidate shrunk alike."""
    arr, jax_geom = arrays[array]
    geom, jgeom, o, w, box_o, box_w = _case(kind, arr, jax_geom)
    if kind == "tight_bound":
        arr = copy.copy(arr)
        arr.upper_bound_pairwise = np.abs(o) + 1

    thunk = hyperbola_area_init_lazy(geom, box_o, box_w)
    assert thunk is not None
    patch = Patch(o.copy(), w, thunk)
    jax_patch = JaxPatch(o.copy(), w,
                         jax_hyperbola_area_init(jgeom, box_o, box_w))
    n = patch.area_size()
    np.testing.assert_array_equal(patch.area_points, jax_patch.area_points)

    moved, halves = [], []
    check_out = Patch.check_out
    divide = subdivide.binary_area_divide_width

    def record_check_out(self, upper):
        moved.append(check_out(self, upper))
        return moved[-1]

    def record_divide(*args, **kwargs):
        out = divide(*args, **kwargs)
        if out[0]:
            halves.append(len(out[1]))
        return out

    monkeypatch.setattr(Patch, "check_out", record_check_out)
    monkeypatch.setattr(subdivide, "binary_area_divide_width", record_divide)
    leaves = arr.subdivide_patch(patch)
    jax_leaves = jax_search_area([jax_patch], arr.mic_positions,
                                 arr.upper_bound_pairwise)

    assert len(leaves) == len(jax_leaves) >= 1
    for leaf, jax_leaf in zip(leaves, jax_leaves):
        np.testing.assert_array_equal(leaf.sample_offset,
                                      jax_leaf.sample_offset)
        np.testing.assert_array_equal(leaf.width_list, jax_leaf.width_list)
        np.testing.assert_array_equal(leaf.area_points, jax_leaf.area_points)
        np.testing.assert_array_equal(leaf.center_pos(),
                                      jax_leaf.center_pos())
    np.testing.assert_array_equal(patch.sample_offset, jax_patch.sample_offset)
    np.testing.assert_array_equal(patch.width_list, jax_patch.width_list)

    # each case reaches the path it is named for
    if kind in ("typical", "shrunk"):
        assert len(leaves) > 1 and n > MIN_AREA
    elif kind == "beyond_bound":
        assert moved[0] and len(leaves) > 1
    elif kind == "sparse":
        assert 0 < n <= MIN_AREA and 1 in halves
    elif kind == "crowded_width4":
        assert n > MIN_AREA and leaves == [patch]
    elif kind == "tight_bound":
        assert any(moved[1:]) and len(leaves) > 1
    else:
        assert patch.area_samples is None and n == 1


BLOCKS = ["corner_lo_lo", "corner_lo_hi", "corner_hi_lo", "corner_hi_hi",
          "whole_roi"]


@pytest.mark.parametrize("block", BLOCKS)
def test_fine_block_field(arrays, block):
    """`fine_members` over a 1 cm window equals the whole-grid formula:
    with open bounds its points are the window's grid in C order and its
    samples, after the float32 cast, `_tdoa_field` of them (and the JAX
    package's `fine_block` on the corners), as `fine_block` gives them on
    the window's grid; with a box, its points are the
    grid's points whose formula offsets lie inside it, and its float64
    samples equal `sample_offsets_for` of the points."""
    arr, jax_geom = arrays["release7"]
    geom = arr.geom
    r = geom.range_spk
    P = arr.num_mic - 1
    nx = int(round((r[1] - r[0]) / 0.01))
    ny = int(round((r[3] - r[2]) / 0.01))
    size = 60
    xi0, yi0 = {"corner_lo_lo": (0, 0), "corner_lo_hi": (0, ny - size),
                "corner_hi_lo": (nx - size, 0),
                "corner_hi_hi": (nx - size, ny - size),
                "whole_roi": (0, 0)}[block]
    xi1, yi1 = (nx, ny) if block == "whole_roi" else (xi0 + size, yi0 + size)

    xx = r[0] + 0.01 * np.arange(xi0, xi1)
    yy = r[2] + 0.01 * np.arange(yi0, yi1)
    zz = np.arange(r[4], r[5], 0.1)
    pos = np.stack(np.meshgrid(xx, yy, zz), axis=3).astype(np.float32)
    off = np.concatenate([  # rows at a time: the formula's (..., M, 3)
        # differences of the whole room take gigabytes
        geometry._tdoa_field(pos[k:k + 64].astype(np.float64),
                             geom.mic_pos).astype(np.float32)
        for k in range(0, pos.shape[0], 64)])
    if block != "whole_roi":
        jax_pos, jax_off = jax_geom.fine_block(xi0, xi1, yi0, yi1)
        np.testing.assert_array_equal(pos, jax_pos)
        np.testing.assert_array_equal(off, jax_off)

    def members(lo, hi):
        points, samples = geom.fine_members(xi0, xi1, yi0, yi1, lo, hi)
        assert points.dtype == np.float32 and samples.dtype == np.float64
        np.testing.assert_array_equal(
            samples, sample_offsets_for(points, geom.mic_pos, FS).T)
        np.testing.assert_array_equal(
            samples, sample_offsets_for(points, arr.mic_positions, FS).T)
        return points, samples

    # the whole window: every point, every pair's field
    points, samples = members(np.full(P, -np.inf), np.full(P, np.inf))
    np.testing.assert_array_equal(points, pos.reshape(-1, 3))
    np.testing.assert_array_equal(samples.astype(np.float32),
                                  off.reshape(-1, P).T)
    block_pos, block_off = geom.fine_block(xi0, xi1, yi0, yi1)
    np.testing.assert_array_equal(block_pos, pos)
    np.testing.assert_array_equal(block_off, off)

    # the box of the source at the window's centre, 8.2 samples wide
    centre = pos[pos.shape[0] // 2, pos.shape[1] // 2, 2].astype(np.float64)
    o = np.round(sample_offsets_for(centre, geom.mic_pos, FS)[0])
    lo, hi = o - 4.1, o + 4.1
    points, samples = members(lo, hi)
    inside = np.all((off >= lo) & (off <= hi), axis=-1)
    assert 0 < points.shape[0] < inside.size
    np.testing.assert_array_equal(points, pos[inside])
    np.testing.assert_array_equal(samples.astype(np.float32), off[inside].T)

    # bounds are compared in float64: a lower bound just above a grid
    # value leaves that point out, though it rounds to it in float32
    v = off[off.shape[0] // 2, off.shape[1] // 2, 2, 0]
    lo = np.array(lo)
    lo[0] = np.nextafter(np.float64(v), np.inf)
    points, _ = members(lo, hi)
    inside = np.all((off >= lo) & (off <= hi), axis=-1)
    assert not inside[off.shape[0] // 2, off.shape[1] // 2, 2]
    assert np.float32(lo[0]) == v
    np.testing.assert_array_equal(points, pos[inside])
