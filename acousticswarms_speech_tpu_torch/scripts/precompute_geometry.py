"""Precompute the per-scene geometry caches of an evaluation dataset (JAX:
scripts/precompute_geometry.py).

The search geometry of a microphone configuration (grid -> TDoA clusters) is
deterministic host work.  Built ahead of time into each scene's directory,
it is what `pipeline/evaluate.py --cached_init` loads instead of building it
between the scene's device work.  The cache files are the JAX package's
(same name and content), so either package reads them.  Host NumPy only:
no tensor, no device.

    python -m acousticswarms_speech_tpu_torch.scripts.precompute_geometry \
        <dataset_dir> [--grid_size 0.05]
"""
from __future__ import annotations

import argparse
import json
import os
import time

from ..dsp.geometry import build_geometry
from ..pipeline.evaluate import preprocess_metadata


def precompute(dataset_dir: str, grid_size: float = 0.05) -> list[str]:
    """Build (or reuse) the cache of every scene directory of `dataset_dir`
    that has a metadata.json; returns the scene directories, in order."""
    dirs = sorted(d for d in os.listdir(dataset_dir)
                  if os.path.isdir(os.path.join(dataset_dir, d)))
    t0 = time.time()
    done = []
    for k, d in enumerate(dirs):
        scene = os.path.join(dataset_dir, d)
        meta_path = os.path.join(scene, "metadata.json")
        if not os.path.exists(meta_path):
            continue
        with open(meta_path) as f:
            metadata = json.load(f)
        _, mic_positions, _, _, _, speaker_range = preprocess_metadata(metadata)
        build_geometry(mic_positions, speaker_range, grid_size=grid_size,
                       cache_dir=scene)
        done.append(scene)
        if k % 25 == 0:
            print(f"[{k}/{len(dirs)}] {time.time() - t0:.0f}s", flush=True)
    print(f"done {len(dirs)} scenes in {time.time() - t0:.0f}s")
    return done


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("dataset_dir")
    parser.add_argument("--grid_size", type=float, default=0.05)
    args = parser.parse_args(argv)
    precompute(args.dataset_dir, args.grid_size)


if __name__ == "__main__":
    main()
