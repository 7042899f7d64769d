"""Result aggregation: precision/recall, localization error percentiles,
SI-SDRi — overall and per speaker count (JAX: pipeline/analyze.py).

    python -m acousticswarms_speech_tpu_torch.pipeline.analyze <folder> [--bootstrap]

Host NumPy, copied from the JAX package for the PyTorch port (the port
imports nothing of that package).  Counterpart of reference
sep/analyze_result.py:22-117; reads the `result_*.json` files written by
evaluate.py (same schema as the reference).
"""
from __future__ import annotations

import argparse
import glob
import json

import numpy as np


def analyze(input_dir: str, verbose: bool = True) -> dict:
    dis_err_list = []
    sample_err_list = []  # TDoA shift error per TP (eval_model.py:224)
    false_negative = false_positive = true_positive = 0

    n_buckets = 5  # speaker counts 2..6
    fp_num = np.zeros(n_buckets)
    fn_num = np.zeros(n_buckets)
    tp_num = np.zeros(n_buckets)
    sisnri_numspk = [[] for _ in range(6)]
    loc_err_numspk = [[] for _ in range(6)]

    sisdr_improve, sisdr_in = [], []
    mireval_improve, mireval_in = [], []

    for result_path in sorted(glob.glob(input_dir + "/result*.json")):
        with open(result_path) as f:
            result = json.load(f)
        gt_data = result["gt"]
        pred_data = result["pred"]
        remain_data = result["false_positive"]

        bucket = min(max(len(gt_data) - 2, 0), n_buckets - 1)
        real_num = 0
        for pred in pred_data:
            real_num += 1
            sisdr_improve.append(pred["si_snri"])
            sisdr_in.append(pred["si_snr_in"])
            mireval_improve.append(pred["si_snri_mir"])
            mireval_in.append(pred["si_snr_in_mir"])
            dis_err_list.append(pred["dis_err"])
            if "sample_err" in pred:
                sample_err_list.append(pred["sample_err"])
            sisnri_numspk[bucket].append(pred["si_snri"])
            loc_err_numspk[bucket].append(pred["dis_err"])

        true_positive += real_num
        false_negative += len(gt_data) - real_num
        false_positive += len(remain_data)
        tp_num[bucket] += real_num
        fn_num[bucket] += len(gt_data) - real_num
        fp_num[bucket] += len(remain_data)

    out = {
        "tp": true_positive, "fp": false_positive, "fn": false_negative,
        "precision": true_positive / max(true_positive + false_positive, 1),
        "recall": true_positive / max(true_positive + false_negative, 1),
        "loc_err_mean": float(np.mean(dis_err_list)) if dis_err_list else None,
        "loc_err_median": float(np.percentile(dis_err_list, 50))
        if dis_err_list else None,
        "loc_err_90": float(np.percentile(dis_err_list, 90))
        if dis_err_list else None,
        "tdoa_sample_err_mean": float(np.mean(sample_err_list))
        if sample_err_list else None,
        "sisdri_mean": float(np.mean(sisdr_improve)) if sisdr_improve else None,
        "sisdri_mir_mean": float(np.mean(mireval_improve))
        if mireval_improve else None,
        "per_speaker_count": {},
    }
    for i in range(n_buckets):
        if len(sisnri_numspk[i]) <= 0:
            continue
        out["per_speaker_count"][i + 2] = {
            "precision": tp_num[i] / max(tp_num[i] + fp_num[i], 1),
            "recall": tp_num[i] / max(tp_num[i] + fn_num[i], 1),
            "loc_err_mean": float(np.mean(loc_err_numspk[i])),
            "loc_err_median": float(np.percentile(loc_err_numspk[i], 50)),
            "loc_err_90": float(np.percentile(loc_err_numspk[i], 90)),
            "sisdri_mean": float(np.mean(sisnri_numspk[i])),
        }

    if verbose:
        print(f"False positive = {false_positive}; False negative = "
              f"{false_negative}; True positive = {true_positive}")
        print(f"precision = {out['precision']:.4f} and "
              f"recall = {out['recall']:.4f}")
        for k, v in out["per_speaker_count"].items():
            print(f"speaker_num {k} precision = {v['precision']:.4f} "
                  f"recall = {v['recall']:.4f} loc_err={v['loc_err_mean']:.3f} "
                  f"sisnri={v['sisdri_mean']:.3f}")
        if dis_err_list:
            print("avg dis err:", out["loc_err_mean"])
            print("median dis err:", out["loc_err_median"])
            print("0.90 dis err:", out["loc_err_90"])
            print("avg si-snr i :", out["sisdri_mean"])
            print("avg mir_eval si-snr i:", out["sisdri_mir_mean"])
    return out


def bootstrap_ci(input_dir: str, n_boot: int = 2000, seed: int = 0,
                 alpha: float = 0.05) -> dict:
    """Scene-level bootstrap 95% CIs for the headline metrics.

    Resamples whole scenes (the independent unit — per-speaker metrics
    within a scene are correlated through the shared mixture/search), so the
    intervals honestly reflect eval-set size; VERDICT r2 flagged that point
    estimates off ~40 scenes can't resolve ±0.1 dB claims."""
    rng = np.random.default_rng(seed)
    scenes = []
    for result_path in sorted(glob.glob(input_dir + "/result*.json")):
        with open(result_path) as f:
            r = json.load(f)
        scenes.append({
            "tp": len(r["pred"]),
            "fn": len(r["gt"]) - len(r["pred"]),
            "fp": len(r["false_positive"]),
            "dis": [p["dis_err"] for p in r["pred"]],
            "sisdri": [p["si_snri"] for p in r["pred"]],
        })
    if not scenes:
        return {}

    stats = {"precision": [], "recall": [], "loc_err_median": [],
             "sisdri_mean": []}
    n = len(scenes)
    for _ in range(n_boot):
        pick = rng.integers(0, n, size=n)
        tp = sum(scenes[i]["tp"] for i in pick)
        fp = sum(scenes[i]["fp"] for i in pick)
        fn = sum(scenes[i]["fn"] for i in pick)
        dis = [d for i in pick for d in scenes[i]["dis"]]
        sis = [s for i in pick for s in scenes[i]["sisdri"]]
        stats["precision"].append(tp / max(tp + fp, 1))
        stats["recall"].append(tp / max(tp + fn, 1))
        if dis:
            stats["loc_err_median"].append(float(np.median(dis)))
        if sis:
            stats["sisdri_mean"].append(float(np.mean(sis)))
    lo, hi = 100 * alpha / 2, 100 * (1 - alpha / 2)
    return {k: [float(np.percentile(v, lo)), float(np.percentile(v, hi))]
            for k, v in stats.items() if v}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("input_dir", type=str)
    parser.add_argument("--bootstrap", action="store_true",
                        help="print scene-level bootstrap 95%% CIs")
    args = parser.parse_args(argv)
    analyze(args.input_dir)
    if args.bootstrap:
        ci = bootstrap_ci(args.input_dir)
        for k, (lo, hi) in ci.items():
            print(f"{k} 95% CI: [{lo:.4f}, {hi:.4f}]")


if __name__ == "__main__":
    main()
