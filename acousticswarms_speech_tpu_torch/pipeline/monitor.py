"""Debug monitor and visualization layer (JAX package: pipeline/monitor.py,
copied as host NumPy and matplotlib).

The monitor carries ground truth (positions + TDoA offsets) so every
pipeline stage can be labeled against it; the plots show the SRP layers,
candidate patches, spotforming powers and the final result, and are
written to an output directory.

matplotlib is imported lazily, with the Agg backend, so that headless and
pipeline use never pays for it.
"""
from __future__ import annotations

import os

import numpy as np


class MicArrayMonitor:
    """Carries GT context for stage-by-stage debugging
    (reference: Mic_Array_Monitor, Mic_Array.py:84-90)."""

    def __init__(self, mic_positions, voice_positions, sample_offsets_gt,
                 output_dir):
        self.output_dir = output_dir
        self.voice_positions = np.asarray(voice_positions)
        self.mic_positions = np.asarray(mic_positions)
        self.sample_offsets_gt = np.asarray(sample_offsets_gt)
        os.makedirs(os.path.join(output_dir, "debug"), exist_ok=True)

    def label_patches(self, patch_list) -> list[bool]:
        """GT containment per candidate patch (Patch.check_gt)."""
        return [p.check_gt(self.sample_offsets_gt) for p in patch_list]


def visualize_srp_layers(engine, voice_positions=None, out_dir=None,
                         name="SRP"):
    """Per-height-layer SRP power maps (reference: SRP_Prunning.
    visualize_each_layer, :648-691; middle z layer)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    geom = engine.geom
    power = engine.power_map
    r = geom.range_spk
    extent = (r[0], r[1], r[2], r[3])
    i = len(geom.z_grids) // 2
    fig, ax = plt.subplots()
    ax.set_aspect("equal")
    img = power[:, :, i].T[::-1, :]
    ax.imshow(img, vmin=engine.min_power, vmax=engine.max_power,
              extent=extent)
    ax.scatter(geom.mic_pos[:, 0], geom.mic_pos[:, 1], c="red", s=12)
    if voice_positions is not None:
        vp = np.asarray(voice_positions)
        ax.scatter(vp[:, 0], vp[:, 1], c="black", marker="x")
    ax.set_title(f"height = {geom.z_grids[i]:.2f}")
    if out_dir is not None:
        fig.savefig(os.path.join(out_dir,
                                 f"{name}_h{geom.z_grids[i]:.2f}.png"))
    plt.close(fig)
    return fig


def visualize_patches(patch_list, mic_positions, voice_positions, range_spk,
                      out_path=None):
    """Scatter the member points of candidate patches over the room
    (reference: local_utils_3d.visualize, :43-76)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.set(xlim=(range_spk[0], range_spk[1]), ylim=(range_spk[2], range_spk[3]))
    ax.set_aspect("equal")
    cmap = plt.get_cmap("tab20")
    for k, p in enumerate(patch_list):
        if p.area_points is None or p.area_points.shape[1] == 0:
            continue
        pts = p.area_points
        ax.scatter(pts[0], pts[1], s=2, color=cmap(k % 20), alpha=0.4)
        c = p.center_pos()
        if c is not None:
            ax.scatter([c[0]], [c[1]], s=25, color=cmap(k % 20), marker="s")
    ax.scatter(mic_positions[:, 0], mic_positions[:, 1], c="red", s=12)
    if voice_positions is not None:
        vp = np.asarray(voice_positions)
        ax.scatter(vp[:, 0], vp[:, 1], c="black", marker="x")
    if out_path is not None:
        fig.savefig(out_path)
    plt.close(fig)
    return fig


def visualize_spot_powers(mic_positions, voice_positions, range_spk,
                          center_list, power_list, out_path=None):
    """Candidate centers colored by normalized spotforming power
    (reference: local_utils_3d.visualize_small_patch, :20-41)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.set(xlim=(range_spk[0], range_spk[1]), ylim=(range_spk[2], range_spk[3]))
    ax.set_aspect("equal")
    power_list = np.asarray(power_list, dtype=np.float64)
    rng = power_list.max() - power_list.min()
    norm = (power_list - power_list.min()) / (rng if rng > 0 else 1) + 1e-1
    centers = np.asarray(center_list)
    sc = ax.scatter(centers[:, 0], centers[:, 1], s=10, c=norm, vmin=-1,
                    vmax=1, cmap="RdYlGn", edgecolors="none")
    ax.scatter(mic_positions[:, 0], mic_positions[:, 1], c="red", s=12)
    if voice_positions is not None:
        vp = np.asarray(voice_positions)
        ax.scatter(vp[:, 0], vp[:, 1], c="black", marker="x")
    fig.colorbar(sc)
    if out_path is not None:
        fig.savefig(out_path)
    plt.close(fig)
    return fig


def visualize_result(mic_positions, voice_positions, patch_final,
                     range_spk, out_path=None):
    """Final localization result vs GT (reference: local_utils_3d.
    visualize_result)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.set(xlim=(range_spk[0], range_spk[1]), ylim=(range_spk[2], range_spk[3]))
    ax.set_aspect("equal")
    ax.scatter(mic_positions[:, 0], mic_positions[:, 1], c="red", s=12,
               label="mics")
    if voice_positions is not None:
        vp = np.asarray(voice_positions)
        ax.scatter(vp[:, 0], vp[:, 1], c="black", marker="x", s=60,
                   label="GT speakers")
    centers = [pf[0].center_pos() for pf in patch_final]
    centers = np.asarray([c for c in centers if c is not None])
    if len(centers):
        ax.scatter(centers[:, 0], centers[:, 1], c="blue", marker="^", s=60,
                   label="estimates")
    ax.legend()
    if out_path is not None:
        fig.savefig(out_path)
    plt.close(fig)
    return fig
