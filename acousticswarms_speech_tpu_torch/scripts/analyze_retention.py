"""Root-cause the fine-stage GT retention ceiling (VERDICT r3 weak #3).

The threshold tuner (scripts/tune_thresholds.py) showed fine-stage GT
retention saturating at ~0.78 regardless of SPOT_POWER_THRESHOLD2 — 22% of
GT speakers never have a surviving big patch near their true offsets.  This
script attributes each lost speaker to its earliest failing stage, from the
``trace_*.json`` / ``result_*.json`` pairs of a traced eval run:

  srp_miss      no coarse candidate within the 4.9-sample match window at
                all (the SRP-PHAT pruner never proposed the speaker)
  coarse_power  a coarse candidate existed in-window but every one scored
                below the run's SPOT_POWER_THRESHOLD1 on the
                distance-compensated windowed power
  boundary      a surviving big patch sits 3.5-8 samples from GT (one
                stride-4 SRP bucket off): the 3.5-sample label window calls
                it lost, but fine subdivision may still recover the speaker
                (with sub_offsets in the trace, sub-patch retention below
                measures this directly)
  cap_drop      a coarse candidate passed the power gate but was dropped by
                the power-ranked MAX_BIG_PATCH cap (no fine record exists
                anywhere near GT and the scene hit the cap)
  drift_other   passed the gate, below the cap, yet no fine record near GT
  retained      a fine record within 3.5 samples exists (threshold-tunable)

Per cause it reports GT speaker covariates — 2D distance from the array
centroid, GT-signal RMS (loudness), and concurrent-speaker count — read
from the dataset dir when given, so "is it quiet/distant speakers?" is
answered with data instead of guesses.

Usage:
    python -m acousticswarms_speech_tpu_torch.scripts.analyze_retention \
        <results_folder> [--dataset DIR] [--coarse_thr 0.004]

`--coarse_thr` must match the SPOT_POWER_THRESHOLD1 the traced run used
(the trace is censored below it: big patches pruned there produced no fine
records).

A copy of the JAX package's scripts/analyze_retention.py that reads WAVs
through the port's utils/audio.py; it prints the same text.  Host only: no
tensor, no device.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

COARSE_WIN = 4.9   # miner's labeling rule (reference generate_SRP_sample.py:62-78)
FINE_WIN = 3.5     # production stage-2 window (pipeline/mic_array.py)


def _within(offsets, gt_col, window):
    """offsets: (N, n_pairs); gt_col: (n_pairs,). Chebyshev match per row."""
    if len(offsets) == 0:
        return np.zeros(0, dtype=bool)
    return np.amax(np.abs(np.asarray(offsets, dtype=float)
                          - np.asarray(gt_col, dtype=float)[None, :]),
                   axis=1) < window


def analyze(results_folder: str, dataset: str | None, coarse_thr: float):
    rows = []
    for fp in sorted(glob.glob(os.path.join(results_folder, "trace_*.json"))):
        scene = os.path.basename(fp)[len("trace_"):-len(".json")]
        with open(fp) as f:
            tr = json.load(f)
        res_path = os.path.join(results_folder, f"result_{scene}.json")
        res = json.load(open(res_path)) if os.path.exists(res_path) else None
        gt = np.asarray(tr["sample_offsets_gt"], dtype=float)  # (pairs, spk)
        coarse = next((r for r in tr["records"] if r["stage"] == "coarse"),
                      None)
        fines = [r for r in tr["records"] if r["stage"] == "fine"]
        c_off = np.asarray(coarse["offsets"], dtype=float) if coarse else \
            np.zeros((0, gt.shape[0]))
        c_pow = np.asarray(coarse["powers_with_dis"], dtype=float) if coarse \
            else np.zeros(0)
        f_off = (np.asarray([r["big_offset"] for r in fines], dtype=float)
                 if fines else np.zeros((0, gt.shape[0])))

        mic_pos = np.asarray(res["mic_pos"]) if res else None
        centroid = mic_pos.mean(axis=0) if mic_pos is not None else None

        keep = next((r for r in tr["records"]
                     if r.get("stage") == "coarse_keep"), None)
        cap_hit = (keep["n_truncated"] > 0) if keep else (len(fines) >= 30)
        # small-patch offsets, when the trace carries them (round 4+)
        sub_off = [o for r in fines for o in r.get("sub_offsets", [])]
        sub_off = np.asarray(sub_off, dtype=float) if sub_off else None

        for s in range(gt.shape[1]):
            in_c = _within(c_off, gt[:, s], COARSE_WIN)
            best_c = float(c_pow[in_c].max()) if in_c.any() else np.nan
            in_f = _within(f_off, gt[:, s], FINE_WIN)
            f_dist = (float(np.amax(np.abs(f_off - gt[:, s][None]), axis=1)
                            .min()) if len(f_off) else np.inf)
            sub_ok = (sub_off is not None
                      and _within(sub_off, gt[:, s], 2.5).any())
            if in_f.any():
                cause = "retained"
            elif not in_c.any():
                cause = "srp_miss"
            elif best_c < coarse_thr:
                cause = "coarse_power"
            elif 3.5 <= f_dist < 8.0:
                cause = "boundary"
            elif cap_hit:
                cause = "cap_drop"
            else:
                cause = "drift_other"

            dist = rms = np.nan
            n_spk = gt.shape[1]
            if res is not None and centroid is not None:
                pos = np.asarray(res["gt"][s]["pos"], dtype=float)
                dist = float(np.linalg.norm(pos[:2] - centroid[:2]))
            if dataset is not None:
                wav = os.path.join(dataset, scene, f"mic00_voice{s:02d}.wav")
                if os.path.exists(wav):
                    from ..utils.audio import read_audio_file
                    x = read_audio_file(wav)[0]
                    rms = float(np.sqrt(np.mean(x ** 2)))
            rows.append(dict(scene=scene, spk=s, cause=cause,
                             best_coarse_power=best_c, dist=dist, rms=rms,
                             n_spk=n_spk,
                             n_coarse_inwin=int(in_c.sum()),
                             n_fine_inwin=int(in_f.sum()),
                             sub_retained=bool(sub_ok),
                             has_sub=sub_off is not None))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("results_folder")
    p.add_argument("--dataset", default=None,
                   help="dataset dir with <scene>/mic00_voiceNN.wav for "
                        "loudness covariates")
    p.add_argument("--coarse_thr", type=float, default=0.004)
    args = p.parse_args(argv)

    rows = analyze(args.results_folder, args.dataset, args.coarse_thr)
    if not rows:
        raise SystemExit("no trace_*.json found")

    causes = ["retained", "srp_miss", "coarse_power", "boundary",
              "cap_drop", "drift_other"]
    n = len(rows)
    print(f"{n} GT speakers over "
          f"{len({r['scene'] for r in rows})} scenes "
          f"(coarse_thr={args.coarse_thr})\n")
    print(f"{'cause':>13} {'n':>4} {'frac':>6} {'dist p50':>9} "
          f"{'rms p50':>9} {'nspk mean':>9}")
    for c in causes:
        sub = [r for r in rows if r["cause"] == c]
        if not sub:
            print(f"{c:>13} {0:>4} {0.0:>6.3f}")
            continue
        d = np.asarray([r["dist"] for r in sub], dtype=float)
        e = np.asarray([r["rms"] for r in sub], dtype=float)
        k = np.asarray([r["n_spk"] for r in sub], dtype=float)
        print(f"{c:>13} {len(sub):>4} {len(sub) / n:>6.3f} "
              f"{np.nanmedian(d):>9.3f} {np.nanmedian(e):>9.4f} "
              f"{k.mean():>9.2f}")

    lost = [r for r in rows if r["cause"] != "retained"]
    print(f"\nretention (big-patch 3.5-sample window) = "
          f"{1 - len(lost) / n:.3f}")
    if any(r["has_sub"] for r in rows):
        sub_ret = sum(r["cause"] == "retained" or r["sub_retained"]
                      for r in rows) / n
        print(f"retention (small-patch 2.5-sample window, boundary-aware) = "
              f"{sub_ret:.3f}")
    print("\nlost speakers detail:")
    for r in sorted(lost, key=lambda r: (r["cause"], r["scene"])):
        print(f"  {r['scene']}/spk{r['spk']} {r['cause']:>13} "
              f"best_coarse={r['best_coarse_power']:.4f} "
              f"dist={r['dist']:.2f} rms={r['rms']:.4f} "
              f"n_coarse_inwin={r['n_coarse_inwin']}")


if __name__ == "__main__":
    main()
