"""Offline NMS replay: re-run the final greedy clustering from probe traces
under different merge thresholds, WITHOUT touching the chip.

Consumes trace_*.json from an ACOUSTIC_TRACE_POWERS=1 eval run that carries
the round-4 `nms_summary` extensions (pair_sisdr matrix in candidate order,
powers, centers, has_segments) and the per-tested-pair `nms_pair` records
(windowed SI-SDR lists).

Replay fidelity:
- full-signal SI-SDR rule and distance rule: EXACT (matrix + centers).
- windowed rule: exact for pairs the live pass tested (`nms_pair`);
  untested pairs are assumed non-similar, so at thresholds looser than the
  live run the head count is a lower bound of over-merging.  Coverage is
  reported per sweep point.
- the segment-max drop rule is replayed from tested pairs only.

For each candidate threshold the script reports heads/scene, how many GT
labels survive as heads (recall proxy), and how many heads carry a GT label
(precision proxy).  Reference semantics: Mic_Array.py:425-468 with
SI_SDR_THRESHOLD=-1.

Usage:
    python -m acousticswarms_speech_tpu_torch.scripts.replay_nms \
        <results_folder> [thr ... | --devs | --gate [g ...] | --elect [thr]
        | --split]

A copy of the JAX package's scripts/replay_nms.py that reads the port's
search/clustering.py; it prints the same text.  Host only: no tensor, no
device.
"""
from __future__ import annotations

import glob
import json
import sys

import numpy as np

from ..search.clustering import (
    NMS_DIS_THRESHOLD, NMS_MAX_OUT, NMS_WIN_THRESHOLD, NMS_WIN_THRESHOLD2,
    check_sisnr_win,
)


def load_scenes(folder):
    scenes = []
    for fp in sorted(glob.glob(folder + "/trace_*.json")):
        tr = json.load(open(fp))
        recs = tr["records"]
        summary = next((r for r in recs if r["stage"] == "nms_summary"
                        and r.get("pair_sisdr") is not None), None)
        if summary is None:
            continue
        pairs = {(r["i"], r["head"]): r for r in recs
                 if r["stage"] == "nms_pair"}
        n_spk = np.asarray(tr["sample_offsets_gt"]).shape[1]
        scenes.append((fp, n_spk, summary, pairs))
    return scenes


def replay(summary, pairs, sisdr_thr, win_thr=NMS_WIN_THRESHOLD,
           win_thr2=NMS_WIN_THRESHOLD2, dis_thr=NMS_DIS_THRESHOLD,
           max_out=NMS_MAX_OUT, tdoa_gate=0.0, elect=False,
           split_dev=0.0, split_dis=0.0, split_pow=0.0, split_max=5):
    mat = np.asarray(summary["pair_sisdr"])
    centers = [np.asarray(c) for c in summary["centers"]]
    labels = summary["in_labels"]
    has_seg = summary["has_segments"]
    devs = summary.get("tdoa_dev") or [None] * len(labels)
    n = len(labels)
    heads = []          # insertion-ordered head indices
    members = {}        # head index -> cluster member indices (incl. head)
    tested = missing = 0
    for i in range(n):
        if not has_seg[i]:
            continue
        if (tdoa_gate > 0 and devs[i] is not None
                and devs[i] > tdoa_gate):
            continue
        merged = False
        seg_lists = []
        for head in heads:
            pr = pairs.get((i, head))
            if pr is not None:
                tested += 1
                win_ok = check_sisnr_win(pr["sisdr_win"], win_thr, win_thr2)
                seg_lists.append(pr["sisdr_win"])
            else:
                missing += 1
                win_ok = False
            dis = float(np.linalg.norm(centers[i][:2] - centers[head][:2]))
            if mat[i, head] > sisdr_thr or win_ok or dis < dis_thr:
                merged = True
                members[head].append(i)
                break
        if not merged and seg_lists:
            seg_max = np.amax(np.asarray(seg_lists), axis=0)
            if check_sisnr_win(seg_max, threshold=win_thr + 1,
                               threshold2=win_thr2 + 2):
                # segment-max drop: absorbed by the COMBINATION of existing
                # heads.  Online (clustering.py:231-241) such a candidate
                # joins NO cluster and is therefore never electable — mirror
                # that exactly so the elect A/B matches live semantics
                # (ADVICE r4).
                merged = True
        if not merged:
            heads.append(i)
            members[i] = [i]
    heads = heads[:max_out]
    electable = 0
    if elect:
        # Consistency-based head election (search/clustering.py
        # NMS_TDOA_ELECT): report each cluster through its lowest-deviation
        # member when every member carries a score.
        elected = []
        for h in heads:
            scored = [(m, devs[m]) for m in members[h]]
            if all(d is not None for _, d in scored):
                if len(scored) > 1:
                    electable += 1
                elected.append(min(scored, key=lambda t: t[1])[0])
            else:
                elected.append(h)
        heads = elected
    if split_dev > 0:
        # Consistency split: a cluster that absorbed members which are BOTH
        # position-consistent (low TDoA deviation — their audio really
        # correlates at their claimed position) AND spatially distinct from
        # every emitted head is hiding a second genuine speaker; emit those
        # members as extra heads (dev-ascending) up to max_out total.
        extras = []
        emitted = list(heads)
        powers = summary["powers"]
        head_pow = {m: powers[h] for h in members for m in members[h]}
        cands = sorted(
            ((m, devs[m]) for h in members for m in members[h]
             if m not in emitted and devs[m] is not None
             and devs[m] <= split_dev
             and powers[m] >= split_pow * head_pow[m]),
            key=lambda t: t[1])
        cap = min(max_out, split_max if split_max > 0 else max_out)
        for m, _ in cands:
            if len(emitted) >= cap:
                break
            if all(float(np.linalg.norm(centers[m][:2] - centers[e][:2]))
                   >= split_dis for e in emitted):
                extras.append(m)
                emitted.append(m)
        heads = (heads + extras)[:max_out]
    out_labels = set(labels[h] for h in heads if labels[h] >= 0)
    labeled_heads = sum(1 for h in heads if labels[h] >= 0)
    return len(heads), out_labels, labeled_heads, tested, missing, electable


def live_settings(config):
    """`replay`'s keyword arguments for the NMS settings a live run wrote
    into its config.json (pipeline/evaluate.py): at these the replay gives
    each scene the live head count, every windowed test from `nms_pair`."""
    return dict(
        sisdr_thr=config["NMS_SISDR_THRESHOLD"],
        win_thr=config["NMS_WIN_THRESHOLD"],
        win_thr2=config["NMS_WIN_THRESHOLD2"],
        dis_thr=config["NMS_DIS_THRESHOLD"], max_out=config["NMS_MAX_OUT"],
        tdoa_gate=config["NMS_TDOA_GATE"], elect=config["NMS_TDOA_ELECT"],
        split_dev=config["NMS_SPLIT_DEV"], split_dis=config["NMS_SPLIT_DIS"],
        split_pow=config["NMS_SPLIT_POW"], split_max=config["NMS_SPLIT_MAX"])


def main(folder, thrs):
    scenes = load_scenes(folder)
    if not scenes:
        raise SystemExit(
            f"no replayable nms_summary (with pair_sisdr) in {folder} — "
            "re-run the probe with the round-4 trace extensions")
    gt_total = sum(n for _, n, _, _ in scenes)
    print(f"{len(scenes)} scenes, {gt_total} GT speakers; win-rule pairs "
          "outside the live test set are assumed non-similar")
    print(f"{'thr':>6} {'heads/scene':>12} {'GT surviving':>13} "
          f"{'labeled heads':>14} {'pair coverage':>14}")
    for thr in thrs:
        h = lg = lh = t = m = 0
        for _, n_spk, summary, pairs in scenes:
            nh, out_labels, labeled, tested, missing, _ = replay(
                summary, pairs, thr)
            h += nh
            lg += len(out_labels)
            lh += labeled
            t += tested
            m += missing
        cov = t / max(1, t + m)
        print(f"{thr:>6.1f} {h / len(scenes):>12.2f} "
              f"{lg}/{gt_total} ({lg / gt_total:.2f}){'':>2} "
              f"{lh:>8}/{h:<5} {cov:>10.2f}")


def dev_stats(folder):
    """Labeled validation of the TDoA-consistency scores: deviation
    distribution of GT-labeled vs negative candidates entering the NMS.
    The gate is worth enabling iff the two distributions separate."""
    scenes = load_scenes(folder)
    gt_devs, neg_devs = [], []
    for _, _, summary, _ in scenes:
        devs = summary.get("tdoa_dev")
        if not devs:
            continue
        for lab, dev in zip(summary["in_labels"], devs):
            if dev is None:
                continue
            (gt_devs if lab >= 0 else neg_devs).append(dev)
    for name, arr in [("GT-labeled", gt_devs), ("negative", neg_devs)]:
        if not arr:
            print(f"{name}: no scored candidates")
            continue
        a = np.asarray(arr)
        print(f"{name}: n={len(a)} p10/p50/p90 = "
              f"{np.percentile(a, 10):.1f}/{np.percentile(a, 50):.1f}/"
              f"{np.percentile(a, 90):.1f} samples, "
              f"<=5: {np.mean(a <= 5):.2f}, <=10: {np.mean(a <= 10):.2f}")


def gate_sweep(folder, gates, sisdr_thr):
    scenes = load_scenes(folder)
    gt_total = sum(n for _, n, _, _ in scenes)
    print(f"gate sweep at sisdr_thr={sisdr_thr} "
          f"({len(scenes)} scenes, {gt_total} GT)")
    print(f"{'gate':>6} {'heads/scene':>12} {'GT surviving':>13} "
          f"{'labeled heads':>14}")
    for g in gates:
        h = lg = lh = 0
        for _, n_spk, summary, pairs in scenes:
            nh, out_labels, labeled, _, _, _ = replay(
                summary, pairs, sisdr_thr, tdoa_gate=g)
            h += nh
            lg += len(out_labels)
            lh += labeled
        print(f"{g:>6.1f} {h / len(scenes):>12.2f} "
              f"{lg}/{gt_total} ({lg / gt_total:.2f}){'':>2} "
              f"{lh:>8}/{h:<5}")


def elect_compare(folder, sisdr_thr):
    """A/B the consistency-based head election (NMS_TDOA_ELECT) offline:
    same greedy clustering, heads reported power-first vs lowest-dev member.
    Election cannot change heads/scene — only which member (and therefore
    which label/position/audio) represents each cluster."""
    scenes = load_scenes(folder)
    gt_total = sum(n for _, n, _, _ in scenes)
    print(f"elect A/B at sisdr_thr={sisdr_thr} "
          f"({len(scenes)} scenes, {gt_total} GT)")
    for name, el in [("power head", False), ("elected   ", True)]:
        h = lg = lh = ec = 0
        for _, n_spk, summary, pairs in scenes:
            nh, out_labels, labeled, _, _, electable = replay(
                summary, pairs, sisdr_thr, elect=el)
            h += nh
            lg += len(out_labels)
            lh += labeled
            ec += electable
        print(f"{name}: heads/scene {h / len(scenes):.2f}, GT surviving "
              f"{lg}/{gt_total} ({lg / gt_total:.2f}), labeled heads "
              f"{lh}/{h}")
        if el and ec == 0:
            print("WARNING: no cluster had >1 fully-scored members — "
                  "election never fired (traces predate tdoa_dev or "
                  "scoring was off); this A/B is a no-op.")


def split_sweep(folder, sisdr_thr):
    """Grid the consistency-split knobs (split_dev x split_dis) with
    election on: GT-surviving is the recall proxy, labeled-heads/heads the
    precision proxy (conservative — eval matches on distance + SI-SDR, not
    the 4.9-sample label window)."""
    scenes = load_scenes(folder)
    gt_total = sum(n for _, n, _, _ in scenes)
    print(f"split sweep at sisdr_thr={sisdr_thr}, elect on "
          f"({len(scenes)} scenes, {gt_total} GT)")
    print(f"{'dev':>5} {'dis':>5} {'heads/scene':>12} {'GT surviving':>14} "
          f"{'labeled heads':>14}")
    for dev in [0.0, 1.0, 2.0, 3.0, 5.0]:
        for dis, pw in ([(0.0, 0.0)] if dev == 0 else
                        [(0.8, 0.0), (0.8, 0.25), (0.8, 0.4), (0.8, 0.6),
                         (1.2, 0.25)]):
            h = lg = lh = 0
            for _, n_spk, summary, pairs in scenes:
                nh, out_labels, labeled, _, _, _ = replay(
                    summary, pairs, sisdr_thr, elect=True,
                    split_dev=dev, split_dis=dis, split_pow=pw)
                h += nh
                lg += len(out_labels)
                lh += labeled
            print(f"{dev:>5.1f} {dis:>5.2f} pow{pw:>4.2f} "
                  f"{h / len(scenes):>10.2f} "
                  f"{lg}/{gt_total} ({lg / gt_total:.2f}){'':>3} "
                  f"{lh:>8}/{h:<5}")


if __name__ == "__main__":
    folder = sys.argv[1]
    rest = sys.argv[2:]
    if rest and rest[0] == "--devs":
        dev_stats(folder)
    elif rest and rest[0] == "--gate":
        gates = [float(x) for x in rest[1:]] or [5, 8, 12, 24, 48]
        gate_sweep(folder, gates, sisdr_thr=2.0)
    elif rest and rest[0] == "--elect":
        elect_compare(folder, sisdr_thr=float(rest[1]) if len(rest) > 1
                      else 2.0)
    elif rest and rest[0] == "--split":
        split_sweep(folder, sisdr_thr=2.0)
    else:
        thrs = [float(x) for x in rest] or [
            -3, -2, -1, 0, 1, 2, 3, 4, 6]
        main(folder, thrs)
