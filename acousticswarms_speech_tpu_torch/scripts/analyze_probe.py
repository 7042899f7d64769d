"""Offline analysis of the instrumented fine/NMS trace records.

Reads trace_*.json from a probe eval run (ACOUSTIC_TRACE_POWERS=1) and
accounts, per scene, where GT speakers are lost between the fine power gate
and the final cluster list:

- fine gate:   big patches failing max(powers_win) >= thr/(1+d)
- trigger:     candidates passing the windowed-power gate but failing the
               absolute min_trigger_power full-power floor
- nms merge:   cluster heads absorbed into an earlier head (by rule)
- segmax drop: candidates dropped by the segment-max similarity rule
- silent drop: candidates in NMS whose audio produced no active segments
               (n_in - n_out - merges - segmax, the unaccounted remainder)

Usage:
    python -m acousticswarms_speech_tpu_torch.scripts.analyze_probe \
        <results_folder>

A copy of the JAX package's scripts/analyze_probe.py; it prints the same
text.  Host only: no tensor, no device.
"""
from __future__ import annotations

import glob
import json
import sys

import numpy as np


def main(folder):
    files = sorted(glob.glob(folder + "/trace_*.json"))
    if not files:
        raise SystemExit(f"no trace_*.json in {folder}")
    tot = dict(gt=0, fine_reached=0, fine_passed=0, labels_reached=set())
    merge_by = {}
    n_in = n_out = n_merge = n_segmax = 0
    lost_trigger = 0
    gt_in_nms = 0
    gt_out_nms = 0
    gt_merged_away = 0
    per_scene = []
    for fp in files:
        tr = json.load(open(fp))
        recs = tr["records"]
        n_spk = np.asarray(tr["sample_offsets_gt"]).shape[1]
        tot["gt"] += n_spk
        seen_pass = set()
        seen_cluster = set()
        for r in recs:
            if r["stage"] == "fine_pass":
                if r["n_pass_p2"] > 0 and r["n_pass_trigger"] == 0:
                    lost_trigger += 1
                if r["big_label"] >= 0 and r["n_pass_trigger"] > 0:
                    seen_pass.add(r["big_label"])
            elif r["stage"] == "fine_clusters":
                if r["big_label"] >= 0 and r["n_clusters"] > 0:
                    seen_cluster.add(r["big_label"])
            elif r["stage"] == "nms_merge":
                n_merge += 1
                key = (r["by"],
                       "cross" if (r["label"] >= 0 and r["head_label"] >= 0
                                   and r["label"] != r["head_label"])
                       else "same/neg")
                merge_by[key] = merge_by.get(key, 0) + 1
                if (r["label"] >= 0 and r["label"] != r["head_label"]):
                    gt_merged_away += 1
            elif r["stage"] == "nms_segmax_drop":
                n_segmax += 1
            elif r["stage"] == "nms_summary":
                n_in += r["n_in"]
                n_out += r["n_out"]
                in_l = set(x for x in r["in_labels"] if x >= 0)
                out_l = set(x for x in r["out_labels"] if x >= 0)
                gt_in_nms += len(in_l)
                gt_out_nms += len(out_l)
                per_scene.append((n_spk, len(in_l), len(out_l),
                                  r["n_in"], r["n_out"]))
        tot["fine_reached"] += len(seen_pass)
        tot["fine_passed"] += len(seen_cluster)
    n_scenes = len(files)
    print(f"{n_scenes} scenes, {tot['gt']} GT speakers "
          f"({tot['gt']/n_scenes:.2f}/scene)")
    print(f"GT with a candidate passing BOTH fine gates: "
          f"{tot['fine_reached']} ({tot['fine_reached']/tot['gt']:.2f})")
    print(f"GT producing >=1 within-patch cluster:      "
          f"{tot['fine_passed']} ({tot['fine_passed']/tot['gt']:.2f})")
    print(f"big patches lost to min_trigger_power floor: {lost_trigger}")
    print(f"NMS totals: in {n_in} -> out {n_out}  "
          f"(merged {n_merge}, segmax-dropped {n_segmax}, "
          f"unaccounted/silent {n_in - n_out - n_merge - n_segmax})")
    print(f"distinct GT labels entering NMS: {gt_in_nms} "
          f"({gt_in_nms/tot['gt']:.2f}) -> surviving as heads: {gt_out_nms} "
          f"({gt_out_nms/tot['gt']:.2f}); merges that absorbed a GT label "
          f"into a different/neg head: {gt_merged_away}")
    print("merge reasons:", dict(sorted(merge_by.items())))
    print("per-scene (gt, labels_in, labels_out, n_in, n_out):")
    for row in per_scene:
        print("  ", row)


if __name__ == "__main__":
    main(sys.argv[1])
