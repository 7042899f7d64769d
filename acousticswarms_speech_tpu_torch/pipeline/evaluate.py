"""Evaluation entry point: run the joint pipeline over a dataset, match
predictions to ground truth, compute localization + separation metrics and
write reference-format `result_<id>.json` files (JAX: pipeline/evaluate.py).

    python -m acousticswarms_speech_tpu_torch.pipeline.evaluate <dataset>
        --spot_experiment_dir <exp> --sep_experiment_dir <exp>
        [--results_folder <out>] [--lanes N] [--degrade] [--device cpu]

Host NumPy around the port's `JointPipeline`, copied from the JAX package
(the port imports nothing of that package).  Counterpart of reference
sep/eval/eval_model.py and sep/eval/get_items.py.  The result JSON schema is
the reference's, so `analyze.py` (and the reference's analyze_result.py)
read it unchanged.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import threading

import numpy as np

from ..constants import FS, SPEED_OF_SOUND
from ..search import power_trace
from ..utils import (
    list_top_level_directories,
    read_audio_file,
    si_sdr,
)
from ..utils.bss_eval import bss_eval_sources


def find_best_permutation(wav_gt, wav_pred, pos_gt, pos_pred,
                          acceptable_range: float = 1,
                          accept_sisdr: float = -15):
    """Matching of predictions to GT by 2D distance + SI-SDR
    (reference: eval_model.py:18-59).

    The reference enumerates all n! permutations, which hangs for n > ~8
    (e.g. many false positives from an untrained model).  We keep the exact
    exhaustive search for small n and switch to an optimal Hungarian
    assignment above that: penalizing non-acceptable pairs with a large
    constant maximizes the inlier count first, then minimizes the total
    (hence mean) loss — the same objective."""
    num_gt = pos_gt.shape[0]
    num_pred = pos_pred.shape[0]
    n = max(num_gt, num_pred)
    if n == 0:
        return []

    neg_sisdr_matrix = np.ones((n, n)) * 10000
    dis_matrix = np.ones((n, n)) * 10000
    for i in range(num_gt):
        for j in range(num_pred):
            dis_matrix[i, j] = np.linalg.norm(pos_gt[i][:2] - pos_pred[j][:2])
            neg_sisdr_matrix[i, j] = -si_sdr(wav_pred[j], wav_gt[i])

    acceptable = (dis_matrix < acceptable_range) & \
        (neg_sisdr_matrix < -accept_sisdr)
    loss = neg_sisdr_matrix + dis_matrix

    if n <= 7:
        best_perm, best_inliers, best_err = None, -1, 10000
        for perm in itertools.permutations(range(n)):
            curr_inliers = 0
            loss_err = []
            paired = []
            for idx1, idx2 in enumerate(perm):
                if acceptable[idx1, idx2]:
                    curr_inliers += 1
                    loss_err.append(loss[idx1, idx2])
                    paired.append((idx2, idx1))  # (output id, gt id)
            curr_err = np.mean(loss_err) if loss_err else np.inf
            if (curr_inliers > best_inliers) or (
                curr_inliers == best_inliers and curr_err < best_err
            ):
                best_inliers, best_perm, best_err = curr_inliers, paired, curr_err
        return best_perm

    from scipy.optimize import linear_sum_assignment

    BIG = 1e6
    cost = np.where(acceptable, loss, BIG)
    rows, cols = linear_sum_assignment(cost)
    return [(int(j), int(i)) for i, j in zip(rows, cols)
            if acceptable[i, j]]


def preprocess_metadata(metadata):
    """(reference: eval_model.py:61-86; generalized to any mic count —
    the reference hardcodes 7)"""
    mics = sorted(k for k in metadata if k.startswith("mic"))
    mic_positions = np.array([metadata[k]["position"] for k in mics])
    sources = [k for k in metadata if k.startswith("voice")]
    voice_positions = np.array(
        [metadata[s]["position"][:3] for s in sources]
    )
    num_spk = len(sources)
    sample_offsets_gt = np.zeros((mic_positions.shape[0] - 1, num_spk))
    for j in range(num_spk):
        for i in range(1, mic_positions.shape[0]):
            dis_offset = (np.linalg.norm(voice_positions[j] - mic_positions[i])
                          - np.linalg.norm(voice_positions[j] - mic_positions[0]))
            sample_offsets_gt[i - 1, j] = int(
                round(dis_offset / SPEED_OF_SOUND * FS)
            )
    range_spk = list(metadata["ROI"])
    range_spk[-1] += 0.02
    return (mics, mic_positions, sources, voice_positions, sample_offsets_gt,
            range_spk)


def _estimate_noise_sample(x: np.ndarray, sr: int,
                           win_s: float = 0.5) -> np.ndarray:
    """Quietest `win_s` stretch of `x` (rolling RMS) — the noise floor of a
    real recording's reference-mic GT."""
    win = max(int(win_s * sr), 256)
    if x.shape[-1] <= win:
        return x
    e = np.convolve(x.astype(np.float64) ** 2, np.ones(win), mode="valid")
    start = int(np.argmin(e[:: win // 4]) * (win // 4))
    return x[start : start + win]


def generate_denoised_gt(curr_dir: str, sr: int) -> int:
    """Write `<mic0>_<voiceNN>_denoised.wav` next to each GT that lacks one
    (spectral gating against the recording's own quietest stretch).

    The reference consumes such files when present (get_items.py:10-44 via
    SpeakerSeparation/dataset.py:112-116) but ships them precomputed with its
    real-recording datasets; this generates them on the fly for real scenes.
    Returns the number of files written."""
    from ..utils import write_wav
    from ..utils.denoise import denoise

    with open(os.path.join(curr_dir, "metadata.json"), "rb") as f:
        metadata = json.load(f)
    mics = sorted(k for k in metadata if "mic" in k)
    voices = [k for k in metadata if "voice" in k]
    written = 0
    for voice in voices:
        out_path = os.path.join(curr_dir, f"{mics[0]}_{voice}_denoised.wav")
        if os.path.exists(out_path):
            continue
        gt = read_audio_file(
            os.path.join(curr_dir, f"{mics[0]}_{voice}.wav"))[0]
        noise = _estimate_noise_sample(gt, sr)
        write_wav(out_path, denoise(gt, noise, sr).astype(np.float32), sr)
        written += 1
    return written


def get_items(curr_dir: str, denoise_gt: bool = False,
              generate_denoised: bool = False, sr: int = FS):
    """(reference: get_items.py:10-44).  `generate_denoised` creates missing
    `*_denoised.wav` GT files on the fly (real recordings only — synthetic
    scenes have clean GT by construction)."""
    with open(os.path.join(curr_dir, "metadata.json"), "rb") as f:
        metadata = json.load(f)
    mics = [k for k in metadata if "mic" in k]
    mixture = np.concatenate([
        read_audio_file(os.path.join(curr_dir, f"{m}_mixed.wav")) for m in mics
    ])
    voices = [k for k in metadata if "voice" in k]
    if denoise_gt and generate_denoised and metadata.get("real", False):
        generate_denoised_gt(curr_dir, sr)
    gts = []
    for voice in voices:
        denoised = os.path.join(curr_dir, f"{mics[0]}_{voice}_denoised.wav")
        if denoise_gt and os.path.exists(denoised):
            gts.append(read_audio_file(denoised))
        else:
            gts.append(read_audio_file(
                os.path.join(curr_dir, f"{mics[0]}_{voice}.wav")))
    return metadata, mixture, np.concatenate(gts)


def degrade_mixture(mix: np.ndarray, seed: int, sr: int = FS,
                    white_noise_variance: float = 1e-3,
                    pink_noise_variance: float = 5e-3,
                    shift_jitter: int = 2, codec=None) -> np.ndarray:
    """Robot-condition proxy degradation for synthetic eval scenes.

    No real robot-on-table recordings exist in this environment, so this
    applies the robots' documented channel degradations (the same ones the
    reference trains against, sep/training/base_dataset.py:202-239) to the
    *mixture only* — GT stays clean, so metrics measure robustness:

    - Opus round-trip per mic channel (32 kbps, complexity 0 — the robot's
      streaming codec, sep/helpers/codec.py);
    - additive white + pink sensor noise at the training variances;
    - ±`shift_jitter` samples of per-mic timing error (inter-robot clock
      sync error; the reference mic stays fixed so true TDoAs shift).

    Deterministic per `seed` so clean/degraded runs pair up per scene.
    """
    rng = np.random.default_rng(seed)
    out = np.array(mix, dtype=np.float32, copy=True)
    if codec is not None:
        for i in range(out.shape[0]):
            out[i] = codec.apply(out[i])
    if shift_jitter > 0:
        for i in range(1, out.shape[0]):
            out[i] = np.roll(
                out[i], int(rng.integers(-shift_jitter, shift_jitter + 1)))
    from ..utils.pink_noise import powerlaw_psd_gaussian

    pink = pink_noise_variance * rng.random() * powerlaw_psd_gaussian(
        1, out.shape, random_state=int(rng.integers(2 ** 31)))
    white = white_noise_variance * rng.random() * rng.normal(size=out.shape)
    return (out + pink + white).astype(np.float32)


def compute_metrics(input_signal, est_signal, gt, permute: bool = False):
    """(reference: get_items.py:46-70) SDR via BSS-Eval + SI-SDR."""
    input_sdr, _, _, _ = bss_eval_sources(gt, input_signal,
                                          compute_permutation=False)
    output_sdr, sir, sar, perm = bss_eval_sources(gt, est_signal,
                                                  compute_permutation=permute)
    output_sdr = output_sdr[perm] if permute else output_sdr

    input_sisdr = [si_sdr(input_signal[i], gt[i]) for i in range(gt.shape[0])]
    output_sisdr = [si_sdr(est_signal[i], gt[i]) for i in range(gt.shape[0])]
    return list(input_sdr), list(output_sdr), input_sisdr, output_sisdr


def evaluate_dataset(model, dataset_dir: str, results_folder: str | None = None,
                     cache_geometry: bool = False, grid_size: float = 0.05,
                     sample_filter=None, shard_index: int = 0,
                     num_shards: int = 1, degrade: bool = False,
                     lanes: int = 1):
    """Run the pipeline over every sample dir; returns aggregate counters.

    `model` is a JointPipeline (pipeline/joint.py).

    The eval workload is embarrassingly parallel across mixtures:
    `shard_index`/`num_shards` split the sample list; per-sample result
    JSONs merge by concatenation and analyze.py aggregates them.

    `lanes>1` runs throughput mode on one card: N pipeline lanes sharing
    the networks and executors (pipeline/throughput.py) so scene k's host
    work (WAV IO, degradation codec, permutation matching, BSS-Eval
    metrics) overlaps scene k+1's device sweeps.  Per-scene outputs are
    identical to the serial loop (no cross-scene state) bit for bit when the
    networks are: on a card that needs
    `torch.backends.cudnn.deterministic = True`, since cuDNN's default
    algorithms may differ in the last bits from call to call.  Lanes are
    incompatible with power tracing, whose record buffer is
    process-global.

    `degrade=True` runs the robot-condition proxy (see `degrade_mixture`):
    the mixture is degraded with Opus + noise + timing jitter before the
    pipeline sees it, while GT and metrics stay clean-referenced.  Without
    libopus it raises."""
    all_tp, all_fn, all_fp = [], [], []
    if results_folder is not None:
        # Provenance: record the effective (env-overridable) threshold
        # configuration next to the result JSONs so a stray env var can
        # never silently change reported metrics (ADVICE r3).
        from .. import constants as C
        from ..search.clustering import effective_nms_config

        os.makedirs(results_folder, exist_ok=True)
        with open(os.path.join(results_folder, "config.json"), "w") as f:
            json.dump({
                "dataset": dataset_dir,
                "shard_index": shard_index,
                "num_shards": num_shards,
                "degrade": degrade,
                "grid_size": grid_size,
                "SPOT_POWER_THRESHOLD1": C.SPOT_POWER_THRESHOLD1,
                "SPOT_POWER_THRESHOLD2": C.SPOT_POWER_THRESHOLD2,
                "USE_RELATIVE_SPOT_POWER": C.USE_RELATIVE_SPOT_POWER,
                "SRP_THRESHOLD": C.SRP_THRESHOLD,
                "MAX_BIG_PATCH": C.MAX_BIG_PATCH,
                "SPOT_CROP_SECONDS": getattr(model, "sweep_crop_seconds",
                                             0.0),
                **effective_nms_config(),
            }, f, indent=4)
    codecs: dict = {}  # one Opus encoder per pipeline lane (stateful)
    codecs_lock = threading.Lock()

    def _lane_codec(model):
        if not degrade:
            return None
        with codecs_lock:
            if id(model) not in codecs:
                from ..constants import CHANNELS_PER_MIC, CODEC_FRAME_DURATION_S
                from ..utils.codec import OpusCodec

                codecs[id(model)] = OpusCodec(CHANNELS_PER_MIC, FS,
                                              CODEC_FRAME_DURATION_S)
            return codecs[id(model)]

    def _run_one(model, sample_no):
        codec = _lane_codec(model)
        curr = os.path.join(dataset_dir, sample_no)
        print(" ------------------- Running on sample", curr)
        save_data = {}

        metadata, mix, gt = get_items(curr, denoise_gt=True,
                                      generate_denoised=True)
        if degrade:
            import zlib

            mix = degrade_mixture(
                mix, seed=zlib.crc32(sample_no.encode()), codec=codec)
        (mics, mic_positions, sources, gt_speaker_positions,
         sample_offsets_gt, speaker_range) = preprocess_metadata(metadata)
        gt_num_speakers = gt_speaker_positions.shape[0]

        model.setup(mic_positions=mic_positions, speaker_range=speaker_range,
                    cache_dir=curr if cache_geometry else None,
                    grid_size=grid_size)
        if power_trace.ENABLED:
            # GT offsets for trace-record labeling only (fine/fine_pass/NMS
            # records carry big_label so offline replays can attribute
            # merges/drops to true speakers — scripts/analyze_probe.py).
            model.mic_processor.trace_sample_gt = sample_offsets_gt
        patches, audio_loc, audio, _, _, spot_times = model.forward(mix)

        if len(patches) == 0:
            est_positions = np.zeros((0, 3))
            est_offsets = []
            audio = np.zeros((0, mix.shape[1]))
            audio_loc = np.zeros((0, mix.shape[1]))
        else:
            est_positions = np.array([p[0].center_pos() for p in patches])
            est_offsets = [p[4]["localization_offset"] for p in patches]
            audio = np.asarray(audio)
            audio_loc = np.asarray(audio_loc)

        perm = find_best_permutation(gt, audio, gt_speaker_positions,
                                     est_positions, acceptable_range=1)

        save_data["mic_pos"] = mic_positions.tolist()
        save_data["speaker_pos"] = gt_speaker_positions.tolist()
        save_data["gt"] = []
        save_data["pred"] = []
        save_data["false_positive"] = []
        save_data["est_offsets"] = np.array(est_offsets).tolist()
        save_data["perm"] = perm
        save_data["spot_times"] = int(spot_times)
        save_data["stage_times"] = list(model.times)

        n_gt, n_out, n_match = gt.shape[0], audio.shape[0], len(perm)
        tp, fn, fp = n_match, n_gt - n_match, n_out - n_match
        all_tp.append(tp)
        all_fn.append(fn)
        all_fp.append(fp)

        if len(perm) > 0:
            perm_arr = np.array(perm)
            audio_m = audio[perm_arr[:, 0]]
            audio_loc_m = audio_loc[perm_arr[:, 0]]
            gt_m = gt[perm_arr[:, 1]]
            reference_signal = np.repeat(mix[0:1], audio_m.shape[0], axis=0)

            # SI-SDR of the localization-by-separation outputs
            input_sisdr_old = [si_sdr(reference_signal[i], gt_m[i])
                               for i in range(gt_m.shape[0])]
            output_sisdr_old = [si_sdr(audio_loc_m[i], gt_m[i])
                                for i in range(gt_m.shape[0])]
            input_sdr, output_sdr, input_sisdr, output_sisdr = \
                compute_metrics(reference_signal, audio_m, gt_m, permute=False)
            match_ids = perm_arr.tolist()
        else:
            input_sdr = output_sdr = input_sisdr = output_sisdr = []
            input_sisdr_old = output_sisdr_old = []
            match_ids = perm

        for s in range(gt_num_speakers):
            save_data["gt"].append({
                "sample": sample_offsets_gt[:, s].tolist(),
                "pos": gt_speaker_positions[s, :].tolist(),
            })

        check_idx = list(range(len(patches)))
        i = 0
        for out_id, s in match_ids:
            check_idx.remove(out_id)
            shift_pred = np.asarray(est_offsets[out_id])
            sample_gt = sample_offsets_gt[:, s]
            pos_pred = est_positions[out_id]
            pos_gt = gt_speaker_positions[s]

            spk_pred = {
                "voice_id": s,
                "shifts": shift_pred.tolist(),
                "pos": pos_pred.tolist(),
                "sample_err": float(np.mean(abs(shift_pred - sample_gt))),
                "dis_err": float(np.linalg.norm(pos_pred[:2] - pos_gt[:2])),
                "si_snr_in_mir": float(input_sdr[i]),
                "si_snri_mir": float(output_sdr[i] - input_sdr[i]),
                "si_snr_in": float(input_sisdr[i]),
                "si_snri": float(output_sisdr[i] - input_sisdr[i]),
                "si_snr_in_old": float(input_sisdr_old[i]),
                "si_snri_old": float(output_sisdr_old[i] - input_sisdr_old[i]),
            }
            save_data["pred"].append(spk_pred)
            i += 1

        for remain_id in check_idx:
            save_data["false_positive"].append({
                "pos": est_positions[remain_id].tolist(),
                "sample": np.asarray(
                    patches[remain_id][4]["audio_offset"]).tolist(),
            })

        if results_folder is not None:
            os.makedirs(results_folder, exist_ok=True)
            with open(os.path.join(results_folder,
                                   f"result_{sample_no}.json"), "w") as f:
                json.dump(save_data, f, indent=4)
            if power_trace.ENABLED:
                with open(os.path.join(results_folder,
                                       f"trace_{sample_no}.json"), "w") as f:
                    json.dump({
                        "sample_offsets_gt": sample_offsets_gt.tolist(),
                        "records": power_trace.drain(),
                    }, f)
        elif power_trace.ENABLED:
            # No results folder: still drain (and discard) per sample so the
            # module-global trace buffer — which holds full per-candidate
            # offset/power lists — cannot grow unbounded over a long eval
            # (ADVICE r3).
            power_trace.drain()

        print(f"False positive = {fp}; False negative = {fn}; "
              f"True positive = {tp}")

    selected = [s for k, s in
                enumerate(list_top_level_directories(dataset_dir))
                if k % num_shards == shard_index
                and (sample_filter is None or sample_filter(s))]
    if lanes > 1 and power_trace.ENABLED:
        print("[evaluate] power tracing is process-global; forcing lanes=1")
        lanes = 1
    if lanes > 1:
        from .throughput import PipelinedRunner

        runner = PipelinedRunner(model, n_lanes=lanes)
        _, tp_stats = runner.run(selected,
                                 work_fn=lambda lane, s, i: _run_one(lane, s))
        print(f"[evaluate] throughput mode: {tp_stats['n']} scenes in "
              f"{tp_stats['wall_s']:.1f}s = "
              f"{tp_stats['mixtures_per_sec']:.4f} mix/s, lane utilization "
              f"{[round(u, 2) for u in tp_stats['lane_utilization']]}")
    else:
        for sample_no in selected:
            _run_one(model, sample_no)

    tp, fp, fn = sum(all_tp), sum(all_fp), sum(all_fn)
    print(f"Overall tp: {tp}, fp: {fp}, fn: {fn}")
    if tp + fp > 0 and tp + fn > 0:
        print(f"Overall Precision: {tp / (tp + fp)} Recall: {tp / (tp + fn)}")
    return {"tp": tp, "fp": fp, "fn": fn}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset", type=str)
    parser.add_argument("--spot_experiment_dir", type=str, required=True)
    parser.add_argument("--sep_experiment_dir", type=str, required=True)
    parser.add_argument("--spot_batch_size", type=int, default=128,
                        help="accepted for the JAX package's command line; "
                             "the port sweeps in chunks of SPOT_MAP_CHUNK "
                             "candidates")
    parser.add_argument("--use_fp16", action="store_true",
                        help="run both networks in bfloat16")
    parser.add_argument("--cached_init", action="store_true")
    parser.add_argument("--results_folder", type=str, default=None)
    parser.add_argument("--shard_index", type=int, default=0)
    parser.add_argument("--shard_indices", type=str, default=None,
                        help="comma list of shard indices to run sequentially "
                             "in THIS process; overrides --shard_index")
    parser.add_argument("--num_shards", type=int, default=1)
    parser.add_argument("--degrade", action="store_true",
                        help="robot-condition proxy: Opus + noise + timing "
                             "jitter on the mixture (GT stays clean)")
    parser.add_argument("--degrade_shard_indices", type=str, default=None,
                        help="after the clean shards, rerun these shard "
                             "indices with --degrade semantics into "
                             "<results_folder>_degraded")
    parser.add_argument("--lanes", type=int, default=1,
                        help="throughput mode: N pipeline lanes share the "
                             "networks and overlap host metrics with device "
                             "sweeps (pipeline/throughput.py)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default cuda; raises without "
                             "a card unless 'cpu' is given)")
    args = parser.parse_args(argv)

    from .joint import JointPipeline

    model = JointPipeline.from_experiments(
        args.spot_experiment_dir, args.sep_experiment_dir,
        device=args.device, use_bf16=args.use_fp16,
    )
    shards = ([int(s) for s in args.shard_indices.split(",")]
              if args.shard_indices else [args.shard_index])
    for si in shards:
        evaluate_dataset(model, args.dataset,
                         results_folder=args.results_folder,
                         cache_geometry=args.cached_init,
                         shard_index=si, num_shards=args.num_shards,
                         degrade=args.degrade, lanes=args.lanes)
    if args.degrade_shard_indices:
        folder = ((args.results_folder or "results") + "_degraded")
        for si in [int(s) for s in args.degrade_shard_indices.split(",")]:
            evaluate_dataset(model, args.dataset, results_folder=folder,
                             cache_geometry=args.cached_init,
                             shard_index=si, num_shards=args.num_shards,
                             degrade=True, lanes=args.lanes)


if __name__ == "__main__":
    main()
