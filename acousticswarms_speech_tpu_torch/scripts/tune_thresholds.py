"""Offline spot-power threshold tuner.

Reads the ``trace_*.json`` files produced by an eval run with
``ACOUSTIC_TRACE_POWERS=1`` (see search/power_trace.py) and replays the two
threshold decisions over a value grid:

- coarse (SPOT_POWER_THRESHOLD1, subdivide.binary_search_baseline): a GT
  speaker is retained if at least one candidate within the 4.9-sample match
  window (the miner's labeling rule, reference
  generate_SRP_sample.py:62-78) clears the threshold on the
  distance-compensated windowed power.
- fine (SPOT_POWER_THRESHOLD2, mic_array.spotform_small_patch_parallel): a
  big patch survives if max windowed power >= thr / (1 + d); GT label uses
  the production 3.5-sample window (mic_array stage-2).

For each grid value it prints mean GT retention and mean surviving
candidate count per scene — pick the knee: max pruning at (near-)full
retention.

Usage:
    python -m acousticswarms_speech_tpu_torch.scripts.tune_thresholds \
        <results_folder> [--grid thr ...]

A copy of the JAX package's scripts/tune_thresholds.py; it prints the
same text.  Host only: no tensor, no device.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def _label(offset, gt, window):
    """gt: (n_pairs, n_speakers). True if within `window` of any speaker."""
    off = np.asarray(offset, dtype=float)
    for k in range(gt.shape[1]):
        if np.amax(np.abs(gt[:, k] - off)) < window:
            return k
    return -1


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("results_folder")
    p.add_argument("--grid", type=float, nargs="*",
                   default=[0.002, 0.004, 0.006, 0.008, 0.012, 0.016,
                            0.024, 0.032, 0.048, 0.064])
    args = p.parse_args(argv)

    files = sorted(glob.glob(os.path.join(args.results_folder,
                                          "trace_*.json")))
    if not files:
        raise SystemExit(f"no trace_*.json in {args.results_folder} "
                         "(run eval with ACOUSTIC_TRACE_POWERS=1)")

    coarse = []   # per scene: (powers_with_dis[], labels[])
    fine = []     # per scene: (stat[], labels[])  stat = max_power_win*(1+d)
    for fp in files:
        with open(fp) as f:
            tr = json.load(f)
        gt = np.asarray(tr["sample_offsets_gt"], dtype=float)
        c_pow, c_lab, f_stat, f_lab = [], [], [], []
        for rec in tr["records"]:
            if rec["stage"] == "coarse":
                for off, pw in zip(rec["offsets"], rec["powers_with_dis"]):
                    c_pow.append(pw)
                    c_lab.append(_label(off, gt, 4.9))
            elif rec["stage"] == "fine":
                f_stat.append(rec["max_power_win"] * (1.0 + rec["dis"]))
                f_lab.append(_label(rec["big_offset"], gt, 3.5))
        if c_pow:
            coarse.append((np.asarray(c_pow), np.asarray(c_lab),
                           gt.shape[1]))
        if f_stat:
            fine.append((np.asarray(f_stat), np.asarray(f_lab), gt.shape[1]))

    for name, data in (("SPOT_POWER_THRESHOLD1 (coarse)", coarse),
                       ("SPOT_POWER_THRESHOLD2 (fine)", fine)):
        print(f"\n=== {name}: {len(data)} scenes ===")
        pos = np.concatenate([p[l >= 0] for p, l, _ in data if (l >= 0).any()])
        neg = np.concatenate([p[l < 0] for p, l, _ in data if (l < 0).any()])
        print(f"pos n={pos.size} p10/p50/p90 = "
              f"{np.percentile(pos, [10, 50, 90]).round(4).tolist()}")
        print(f"neg n={neg.size} p10/p50/p90 = "
              f"{np.percentile(neg, [10, 50, 90]).round(4).tolist()}")
        print(f"{'thr':>8} {'retention':>9} {'cand/scene':>10}")
        for thr in args.grid:
            kept_frac, counts = [], []
            for pw, lab, n_spk in data:
                passing = pw >= thr
                found = {int(k) for k in lab[passing] if k >= 0}
                kept_frac.append(len(found) / max(n_spk, 1))
                counts.append(int(passing.sum()))
            print(f"{thr:>8} {np.mean(kept_frac):>9.3f} "
                  f"{np.mean(counts):>10.1f}")


if __name__ == "__main__":
    main()
