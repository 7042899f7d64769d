"""End-to-end benchmark of the port: mixtures per second of the 7-mic
localize-and-separate path on one card (JAX: bench.py).

Times `JointPipeline.forward` (SRP-PHAT map -> coarse spotforming -> fine
spotforming -> clustering -> separation) on a fixed synthetic 3 s,
5-talker, 7-mic scene with both full-width networks, by the JAX bench's
protocol: loading the scene and the networks, geometry set-up, a warm-up
forward (which builds the roll kernel when `kernel_build/` has no library
for it) and a second forward that must be faster on the card are left out; then `BENCH_REPEATS` timed forwards, and a
throughput pass of `BENCH_LANES` pipeline lanes over
`BENCH_THROUGHPUT_ITEMS` mixtures.

    python -m acousticswarms_speech_tpu_torch.scripts.bench [--device cuda]

Prints ONE JSON line on stdout (logs go to stderr).  `value` is the latency
rate, 1 / the median forward time; the lanes' rate stands under
`throughput_mixtures_per_sec` (the JAX bench reports the larger of the two
as `value`, which mixes two metrics).  `vs_baseline` is 1.0: the JAX
bench's baseline file holds TPU figures.  The line also names the card
(`device`: name and power limit from nvidia-smi), the precision
(`use_bf16`, `tf32`, which is always false) and the kernel build cache
(`compile_cache`: entries of `kernel_build/` at the start and added by the
run).  Any failure prints the traceback and a line with `"value": 0.0` and
`error`, and exits 1.

Environment: BENCH_REPEATS (7), BENCH_LANES (2), BENCH_THROUGHPUT_ITEMS
(max(BENCH_REPEATS, 6)), BENCH_BF16 (1: both networks in bfloat16),
BENCH_SPOT_EXP / BENCH_SEP_EXP (experiment directories; default the first
of experiments/ with checkpoints or release weights, else random weights
from seeds 0 and 1), BENCH_PROFILE_DIR (one more forward, untimed, traced
there), BENCH_PROBE_TIMEOUT_S / BENCH_PROBE_RETRIES / BENCH_PROBE_BACKOFF_S
(the card probe: 120 s, 3 tries, 60 s apart).

The device defaults to cuda: a probe in a child process checks the card
first, and without one the run ends with the error line.  The CPU is used
only when `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops.roll_kernel import BUILD_ROOT, roll_channels_batch_cuda

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURE = os.path.join(REPO, ".bench_fixture_v2.npz")
CACHE_DIR = os.path.join(REPO, ".bench_cache")
METRIC = "e2e_7mic_mixtures_per_sec_per_chip"

# The JAX bench's scene (bench.py), copied: mic and talker positions in a
# 7 x 6 x 2.3 m room, and the search range of the talkers.
MIC_POS = np.array([
    [3.0, 1.0, 0.02], [3.5, 1.3, 0.02], [3.5, 0.7, 0.02], [3.7, 1.0, 0.02],
    [3.3, 1.5, 0.02], [3.3, 0.5, 0.02], [3.6, 1.15, 0.02],
])
SRC_POS = [
    [4.8, 2.4, 0.4], [2.2, 3.4, 0.3], [5.4, 4.1, 0.5], [1.6, 1.9, 0.35],
    [3.1, 4.6, 0.45],
]
ROI = [1.0, 6.2, 0.2, 5.4, 0.1, 0.62]
DURATION_S = 3.0
REPEATS = int(os.environ.get("BENCH_REPEATS", "7"))


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def build_fixture() -> np.ndarray:
    """The 3 s, 5-talker, 7-mic reverberant speech scene (deterministic):
    formant-synthesized voices through the image-source room.  Read from
    FIXTURE when it exists; otherwise rendered on the CPU, so that the
    file does not depend on where it was made, and written there."""
    if os.path.exists(FIXTURE):
        return np.load(FIXTURE)["mix"]
    from ..constants import FS
    from ..data.roomsim import ShoeBox
    from ..data.voicegen import SpeakerProfile, synthesize_utterance

    T = int(DURATION_S * FS)
    room = ShoeBox([7.0, 6.0, 2.3], fs=FS, max_order=6, absorption=0.6,
                   device="cpu")
    room.add_microphone_array(MIC_POS.T)
    for k, p in enumerate(SRC_POS):
        prof = SpeakerProfile(np.random.default_rng(100 + k))
        x = synthesize_utterance(prof, DURATION_S,
                                 np.random.default_rng(200 + k), FS)
        peak = np.abs(x).max()
        room.add_source(p, x / max(peak, 1e-6) * 0.7)
    mix = room.simulate(return_premix=True).sum(axis=0)[:, :T]
    mix = mix.astype(np.float32)
    np.savez_compressed(FIXTURE, mix=mix)
    return mix


def cache_entries() -> int:
    """Entries of the kernel build cache (one directory per built source
    and flags)."""
    try:
        return len(os.listdir(BUILD_ROOT))
    except OSError:
        return 0


def cache_report(entries_at_start: int) -> dict:
    """The build cache's entries at the start, and those the run added
    (kernels built by this run: nvcc's roll kernel on a cold cache)."""
    return {"dir": BUILD_ROOT, "entries_at_start": entries_at_start,
            "entries_added": cache_entries() - entries_at_start}


def _emit_error_json(reason: str) -> None:
    """A parseable bench line for a run that failed."""
    print(json.dumps({
        "metric": METRIC,
        "value": 0.0,
        "unit": "mixtures/s",
        "vs_baseline": 0.0,
        "error": reason,
    }), flush=True)


def _probe_card_alive() -> bool:
    """Bounded probe of the card in a child process: torch must see a
    CUDA device.  A child killed at its timeout cannot hang the bench;
    retries with back-off ride out a card that is briefly busy or
    resetting."""
    tmo = int(os.environ.get("BENCH_PROBE_TIMEOUT_S", "120"))
    retries = int(os.environ.get("BENCH_PROBE_RETRIES", "3"))
    backoff = int(os.environ.get("BENCH_PROBE_BACKOFF_S", "60"))
    code = ("import sys, torch\n"
            "if not torch.cuda.is_available():\n"
            "    sys.exit('torch.cuda.is_available() is False')\n"
            "print(torch.cuda.device_count())\n")
    for attempt in range(retries):
        try:
            proc = subprocess.run(
                [sys.executable, "-c", code], timeout=tmo,
                capture_output=True, text=True, stdin=subprocess.DEVNULL,
            )
            if proc.returncode == 0:
                return True
            log(f"probe attempt {attempt + 1}/{retries} rc={proc.returncode}: "
                f"{proc.stderr.strip()[-200:]}")
        except subprocess.TimeoutExpired:
            log(f"probe attempt {attempt + 1}/{retries} timed out after "
                f"{tmo}s")
        if attempt < retries - 1:
            time.sleep(backoff)
    return False


def _has_weights(d: str) -> bool:
    return (os.path.isdir(os.path.join(d, "checkpoints"))
            or os.path.exists(os.path.join(d, "release",
                                           "params_f16.msgpack")))


def _first_with_ckpts(*names: str) -> str:
    for n in names:
        d = os.path.join(REPO, "experiments", n)
        if _has_weights(d):
            return d
    return os.path.join(REPO, "experiments", names[0])


def load_networks(device: torch.device):
    """(SpotNet, SepNet) at full width: the experiments' best weights
    (BENCH_SPOT_EXP / BENCH_SEP_EXP, else the first experiment with
    checkpoints or release weights), or random weights from seeds 0 and 1
    where there are none."""
    from ..models.factory import create_model, init_model
    from ..training.experiment import load_model_from_exp

    spot_exp = os.environ.get("BENCH_SPOT_EXP") or _first_with_ckpts(
        "speech_localization", "speech_localization_stage1",
        "dev_localization")
    if _has_weights(spot_exp):
        spot = load_model_from_exp(spot_exp, mode="best", device=device)
        log(f"spot weights: {spot_exp}")
    else:
        spot = init_model(create_model("SpeakerLocalization", {}), seed=0)
        spot = spot.to(device).eval()
        log("spot weights: random-init")
    sep_exp = os.environ.get("BENCH_SEP_EXP") or _first_with_ckpts(
        "speech_separation", "dev_separation")
    if _has_weights(sep_exp):
        sep = load_model_from_exp(sep_exp, mode="best", device=device)
        log(f"sep weights: {sep_exp}")
    else:
        sep = init_model(create_model("SpeakerSeparation",
                                      {"max_speakers": 5}), seed=1)
        sep = sep.to(device).eval()
        log("sep weights: random-init")
    return spot, sep


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _quartile_spread(x, axis=None):
    return np.percentile(x, 75, axis=axis) - np.percentile(x, 25, axis=axis)


def measure(pipe, mix, mic_pos, roi, *, repeats: int, lanes: int, items: int,
            cache_dir: str | None, profile_dir: str | None = None,
            t_start: float | None = None) -> dict:
    """Set up `pipe` for the array, warm it up, then time `repeats`
    forwards and, with `lanes` > 1, a throughput pass of `items` mixtures
    over that many `PipelinedRunner` lanes (after one warm-up run of
    `lanes` mixtures).  Returns the bench line's measured keys: `value` =
    `latency_mixtures_per_sec` = 1 / the median forward time, the
    throughput keys, per-stage medians and IQRs of `pipe.times`, the
    spread of the forward times, `setup_warmup_s` (from `t_start`, the
    run's start, default now, to the end of the warm-up forward), and the
    timed forwards' own numbers: `forward_s`,
    `roll_launches_per_forward` (the roll kernel's launches; 0 on the CPU,
    where the plain version runs), and the last forward's `clusters` and
    `spot_calls`."""
    from ..pipeline.throughput import PipelinedRunner

    device = torch.device(pipe.device)
    t_start = time.time() if t_start is None else t_start
    pipe.setup(mic_pos, roi, cache_dir=cache_dir)
    log(f"geometry ready at {time.time() - t_start:.1f}s "
        f"(G={pipe.mic_processor.geom.num_clusters})")
    # Warm-up: builds the roll kernel if it is not built, and sets up the
    # card's libraries; both are left out of the timing.
    pipe.forward(mix)
    _sync(device)
    setup_time = time.time() - t_start
    log(f"warmup done at {setup_time:.1f}s; stage times "
        f"{['%.2f' % t for t in pipe.times]}")

    # On the card the second forward must be faster than everything before
    # it; otherwise one-time work would leak into the timed forwards.  The
    # CPU builds and tunes nothing at first use, so its forwards cost the
    # same and the check has nothing to catch there.
    t0 = time.time()
    pipe.forward(mix)
    _sync(device)
    second = time.time() - t0
    if device.type == "cuda" and second >= setup_time:
        raise RuntimeError(f"warm-up miss: the second forward took "
                           f"{second:.2f}s, everything before it "
                           f"{setup_time:.2f}s")

    if profile_dir:
        pipe.forward(mix, profile_dir=profile_dir)
        log(f"profiler trace written to {profile_dir}")

    times, stage_times, launches = [], [], []
    for _ in range(repeats):
        n0 = roll_channels_batch_cuda.launches
        t0 = time.time()
        patches, _, _, _, _, spot_calls = pipe.forward(mix)
        _sync(device)
        times.append(time.time() - t0)
        launches.append(roll_channels_batch_cuda.launches - n0)
        stage_times.append(list(pipe.times))
    elapsed = float(np.median(times))
    value = 1.0 / elapsed
    st = np.asarray(stage_times)  # (repeats, 5)

    throughput = {}
    if lanes > 1:
        runner = PipelinedRunner(
            pipe, n_lanes=lanes,
            setup_fn=lambda lane: lane.setup(mic_pos, roi,
                                             cache_dir=cache_dir))
        runner.run([mix] * lanes)  # warm-up: every lane's first forward
        _, stats = runner.run([mix] * items)
        throughput = {
            "throughput_mixtures_per_sec": round(stats["mixtures_per_sec"], 4),
            "throughput_lanes": lanes,
            "lane_utilization": [round(u, 2)
                                 for u in stats["lane_utilization"]],
        }
    return {
        "value": round(value, 4),
        "latency_mixtures_per_sec": round(value, 4),
        **throughput,
        "stage_median_s": [round(float(x), 3) for x in np.median(st, axis=0)],
        "stage_iqr_s": [round(float(x), 3)
                        for x in _quartile_spread(st, axis=0)],
        "per_mixture_iqr_s": round(float(_quartile_spread(times))
                                   if len(times) > 1 else 0.0, 3),
        "setup_warmup_s": setup_time,
        "forward_s": times,
        "roll_launches_per_forward": launches,
        "clusters": len(patches),
        "spot_calls": int(spot_calls),
    }


def card_info(device: torch.device) -> dict:
    """The card's name and power limit (W) as nvidia-smi gives them; the
    CPU has neither."""
    if device.type != "cuda":
        return {"type": "cpu", "name": None, "power_limit_w": None}
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, stdin=subprocess.DEVNULL)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed ({smi.returncode}): "
                           f"{smi.stderr.strip()}")
    name, limit = smi.stdout.strip().splitlines()[0].rsplit(",", 1)
    return {"type": "cuda", "name": name.strip(),
            "power_limit_w": float(limit.strip().split()[0])}


def bench_line(res: dict, *, compile_cache: dict, device: dict,
               use_bf16: bool) -> dict:
    """The JSON line: the JAX bench's keys (but its A100 estimate) from
    `measure`'s result, then the card, the precision and the timed
    forwards' own numbers."""
    head = {"metric": METRIC, "value": res["value"], "unit": "mixtures/s",
            "vs_baseline": 1.0}
    return {**head, **{k: v for k, v in res.items() if k != "value"},
            "setup_warmup_s": round(res["setup_warmup_s"], 1),
            "compile_cache": compile_cache, "device": device,
            "use_bf16": use_bf16, "tf32": False}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; the CPU only when "
                        "'cpu' is given)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    want = torch.device(args.device or "cuda")
    if want.type == "cuda" and not _probe_card_alive():
        _emit_error_json("CUDA device unavailable: the torch.cuda probe "
                         "failed or hung after retries")
        sys.exit(1)
    device = resolve_device(want)
    cache_start = cache_entries()
    # Full float32 wherever float32 runs, as every number of the port so
    # far was taken.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ..pipeline.joint import JointPipeline

    t_start = time.time()
    mix = build_fixture()
    spot, sep = load_networks(device)
    use_bf16 = os.environ.get("BENCH_BF16", "1") == "1"
    pipe = JointPipeline(spot, sep, device=device, use_bf16=use_bf16)
    log(f"models built at {time.time() - t_start:.1f}s")

    lanes = int(os.environ.get("BENCH_LANES", "2"))
    items = int(os.environ.get("BENCH_THROUGHPUT_ITEMS",
                               str(max(REPEATS, 6))))
    res = measure(pipe, mix, MIC_POS, ROI, repeats=REPEATS, lanes=lanes,
                  items=items, cache_dir=CACHE_DIR,
                  profile_dir=os.environ.get("BENCH_PROFILE_DIR"),
                  t_start=t_start)
    line = bench_line(res, compile_cache=cache_report(cache_start),
                      device=card_info(device), use_bf16=use_bf16)
    print(json.dumps(line), flush=True)
    elapsed = float(np.median(res["forward_s"]))
    log(f"setup+warmup {line['setup_warmup_s']:.1f}s; per-mixture "
        f"{elapsed:.3f}s = {DURATION_S / elapsed:.2f}x realtime on the "
        f"{DURATION_S:.0f}s scene (median of {REPEATS}, IQR "
        f"{res['per_mixture_iqr_s']:.3f}s, all "
        f"{['%.2f' % t for t in res['forward_s']]}); stage medians "
        f"{res['stage_median_s']} IQR {res['stage_iqr_s']}; throughput "
        f"{res.get('throughput_mixtures_per_sec')} ({lanes} lanes, util "
        f"{res.get('lane_utilization')}); clusters {res['clusters']}; spot "
        f"calls {res['spot_calls']}; chunk {pipe.spot_model.chunk}; bf16 "
        f"{use_bf16}; crop {pipe.sweep_crop_seconds}s; roll kernel launches "
        f"per forward {res['roll_launches_per_forward']}")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # noqa: BLE001 (always leave a bench line)
        import traceback

        traceback.print_exc()
        _emit_error_json(f"{type(e).__name__}: {e}"[:300])
        sys.exit(1)
