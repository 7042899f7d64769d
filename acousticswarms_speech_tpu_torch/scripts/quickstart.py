"""Quickstart: simulate a room, then localize its speakers (JAX:
examples/quickstart.py).

Self-contained: no dataset and no weights.  It renders a 2-speaker scene
with the port's image-source simulator and runs the localization-by-
separation search with the classical delay-and-sum spotformer, then prints
the positions it found beside the true ones.

    python -m acousticswarms_speech_tpu_torch.scripts.quickstart [--device cpu]

For neural spotforming and separation, build the pipeline with
`JointPipeline.from_release(spot_dir, sep_dir)` instead.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..constants import FS
from ..data.roomsim import ShoeBox
from ..pipeline.joint import JointPipeline
from ..search.spotform import DelayAndSumExecutor

MIC_POS = np.array([
    [3.0, 1.0, 0.02], [3.5, 1.3, 0.02], [3.5, 0.7, 0.02], [3.7, 1.0, 0.02],
    [3.3, 1.5, 0.02], [3.3, 0.5, 0.02], [3.6, 1.15, 0.02],
])
SOURCES = [np.array([4.8, 2.4, 0.4]), np.array([2.2, 3.4, 0.3])]
ROI = [1.0, 6.0, 0.2, 5.0, 0.1, 0.62]


def make_scene(duration_s: float = 1.5, seed: int = 0,
               device=None) -> np.ndarray:
    """(7, T) mixture of two enveloped noise sources in a 7 x 6 x 2.3 m
    room, the room rendered on `device`."""
    rng = np.random.default_rng(seed)
    T = int(duration_s * FS)
    room = ShoeBox([7.0, 6.0, 2.3], fs=FS, max_order=4, absorption=0.7,
                   device=device)
    room.add_microphone_array(MIC_POS.T)
    for p in SOURCES:
        x = rng.normal(size=T) * 0.3
        env = np.clip(np.sin(2 * np.pi * rng.uniform(1, 3)
                             * np.arange(T) / FS + rng.uniform(0, 6)), 0, None)
        room.add_source(p, x * env)
    return room.simulate(return_premix=True).sum(axis=0)[:, :T]


def localize(mix: np.ndarray, device=None, cache_dir: str | None = None):
    """(pipeline, patches) of the delay-and-sum search of `mix`."""
    pipe = JointPipeline(DelayAndSumExecutor(device=device), None,
                         device=device)
    pipe.setup(MIC_POS, ROI, cache_dir=cache_dir)
    patches, *_ = pipe.localize_by_separation(mix)
    return pipe, patches


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; raises without a "
                             "card unless 'cpu' is given)")
    args = parser.parse_args(argv)
    print("simulating scene ...")
    mix = make_scene(device=args.device)
    print("building search geometry and localizing ...")
    pipe, patches = localize(mix, args.device)
    t = pipe.times
    print(f"stage times (s): SRP {t[0]:.2f}, coarse {t[1]:.2f}, fine "
          f"{t[2]:.2f}, NMS {t[3]:.2f}")
    print(f"\nfound {len(patches)} speaker(s):")
    for k, pf in enumerate(patches):
        pos = pf[0].center_pos()
        d = min(np.linalg.norm(pos[:2] - s[:2]) for s in SOURCES)
        print(f"  #{k}: ({pos[0]:.2f}, {pos[1]:.2f})  "
              f"nearest GT speaker at {d:.2f} m")
    print("\nGT positions:",
          [[float(x) for x in np.round(s[:2], 2)] for s in SOURCES])


if __name__ == "__main__":
    main()
