"""SRP hard-negative miner: label surviving SRP candidates against the
ground truth (JAX package: data/generate_srp_sample.py).

Runs the SRP-PHAT pruning stage of the port's `MicArray` on each training
scene (the map on the device of `device`, cuda unless named), labels each
candidate TDoA offset positive or negative against the GT shifts
(threshold 4.9 samples), and writes `challeng_sample.json`, which the
localization dataset's hard-negative sampling reads.

CLI:  python -m acousticswarms_speech_tpu_torch.data.generate_srp_sample \\
          <input_dir> [--sample_number N] [--debug_num I] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..constants import FS
from ..pipeline.evaluate import get_items, preprocess_metadata
from ..pipeline.mic_array import MicArray


def check_label(sample_list, sample_offsets_gt, threshold: float = 4.9):
    negatives, positives = [], []
    for sample in sample_list:
        inside = False
        for i in range(sample_offsets_gt.shape[1]):
            if np.amax(np.abs(sample_offsets_gt[:, i] - sample)) < threshold:
                inside = True
                break
        (positives if inside else negatives).append(
            np.asarray(sample).tolist()
        )
    return negatives, positives


def mine_sample(sample_dir: str, grid_size: float = 0.05,
                cache_geometry: bool = False, clip_seconds: float = 3.0,
                device=None):
    """Mine one scene directory; returns (negatives, positives).

    grid_size matches the production pipeline's search grid, so mined
    negatives come from the same SRP screen the trained net faces at
    inference."""
    metadata, mix, _ = get_items(sample_dir)
    (mics, mic_positions, sources, voice_positions, sample_offsets_gt,
     range_spk) = preprocess_metadata(metadata)

    T = int(clip_seconds * FS)
    mix = mix[:, :T]

    arr = MicArray(mic_positions, spk_range=range_spk, grid_size=grid_size,
                   cache_dir=sample_dir if cache_geometry else None,
                   device=device)
    patch_list, _ = arr.apply_srp_phat(mix)
    sample_list = [p.sample_offset for p in patch_list]
    negatives, positives = check_label(sample_list, sample_offsets_gt)

    # Atomic write: a killed miner must never leave a truncated JSON for
    # the fine-tune dataset's challenge sampling to trip over.
    out = os.path.join(sample_dir, "challeng_sample.json")
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"negative_sample": negatives,
                   "positive_sample": positives}, f, indent=4)
    os.replace(tmp, out)
    return negatives, positives


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("input_dir", type=str)
    parser.add_argument("--sample_number", type=int, default=1)
    parser.add_argument("--debug_num", type=int, default=-1)
    parser.add_argument("--cached_init", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="device of the SRP map (default cuda)")
    args = parser.parse_args()

    begin = max(args.debug_num, 0)
    for idx in range(begin, begin + args.sample_number):
        d = os.path.join(args.input_dir, f"{idx:05d}")
        if not os.path.exists(os.path.join(d, "metadata.json")):
            print(f"warning: no metadata in {d}")
            continue
        neg, pos = mine_sample(d, cache_geometry=args.cached_init,
                               device=args.device)
        print(f"Generated sample {idx}: {len(neg)} negatives, "
              f"{len(pos)} positives")


if __name__ == "__main__":
    main()
