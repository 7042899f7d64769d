#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printed with the seconds since start:
  device       the card's name, count and power limit;
  build        nvcc builds the roll kernel (csrc/roll.cu) and its register
               and spill report is printed;
  kernel check the roll kernel against its plain PyTorch version (exact
               equality: it is a copy) at M = 7, T in {72000, 144000},
               B in {32, 37, 512}, with edge and random shifts, timed with
               CUDA events beside the plain version, one torch.gather and
               the bytes bound;
  launch floor the forward's smallest roll launch and an empty kernel
               launched through the same ctypes path, timed paced by the
               host (as the kernel check times them) and queued behind a
               busy card (device time alone), with the wrapper's host
               time per call;
  main path    JointPipeline.forward of the port on the 3 s, 7-mic bench
               scene (.bench_fixture_v2.npz) with both release networks at
               full width in float32: a warm-up forward, then a timed one
               with the kernel's launch count reset just before it;
  reference    the card's SRP map, SpotNet and SepNet outputs against the
               same port code on the CPU, on the bench scene or a slice of it,
               and the roll kernel at every shape the main path gave it;
  evaluation   JointPipeline.from_experiments of both release experiments,
               evaluate_dataset over the 16 dev scenes (.devdata_v2/test):
               serially with cuDNN's default algorithms (as the evaluate
               CLI runs), then serially and with lanes=2 with cuDNN held
               to deterministic algorithms, where the lanes' result JSONs
               must equal the serial ones apart from stage times; analyze
               reads all three, every output is finite, and the roll
               kernel is held against its plain version on the inputs of
               every launch of the first pass;
  training     train() of each release description at full width for one
               epoch of 3 steps on the dev scenes, warm-started from the
               release weights; losses finite, and the written checkpoint
               reads back through load_model_from_exp equal to the trained
               parameters.

The last line is {"ok": true, "device": {...}}; the line before it holds the
kernel table as JSON.  Any fault prints a traceback and exits 1 without
those lines; so does a machine without CUDA.  A watchdog ends a run that
hangs.  The script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import faulthandler
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import traceback

WATCHDOG_S = 1100
REPO = os.path.dirname(os.path.abspath(__file__))
DEV_SET = os.path.join(REPO, ".devdata_v2", "test")
OUT_DIR = os.path.join(REPO, "chip_smoke_out")  # gitignored
FIXTURE = os.path.join(REPO, ".bench_fixture_v2.npz")
SPOT_DIR = os.path.join(REPO, "experiments", "speech_localization")
SEP_DIR = os.path.join(REPO, "experiments", "speech_separation")
CACHE_DIR = os.path.join(REPO, ".bench_cache")

# The bench scene of bench.py (copied, so that nothing of the JAX package is
# imported): 7 mics, 5 speakers, and the search range of the speakers.
MIC_POS = [
    [3.0, 1.0, 0.02], [3.5, 1.3, 0.02], [3.5, 0.7, 0.02], [3.7, 1.0, 0.02],
    [3.3, 1.5, 0.02], [3.3, 0.5, 0.02], [3.6, 1.15, 0.02],
]
SRC_POS = [
    [4.8, 2.4, 0.4], [2.2, 3.4, 0.3], [5.4, 4.1, 0.5], [1.6, 1.9, 0.35],
    [3.1, 4.6, 0.45],
]
ROI = [1.0, 6.2, 0.2, 5.4, 0.1, 0.62]

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
MIX_SAMPLES = 144000  # all 3 s of the scene
KERNEL_SHAPES = [(B, T) for T in (72000, 144000) for B in (32, 37, 512)]

_T0 = time.time()


def log(msg: str) -> None:
    print(f"[{time.time() - _T0:8.2f}s] {msg}", flush=True)


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` over `reps` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` with the card kept busy while the host
    queues the calls, so that host time per call does not show."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms of spinning on the card
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int = 2000) -> float:
    """Mean host time of one call of `fn`, in microseconds."""
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    sync()
    return us


def device_phase() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no GPU")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"device: {name} x{count}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, stdin=subprocess.DEVNULL)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    for line in smi.stdout.strip().splitlines():
        print(line.strip(), flush=True)
    # Full float32 everywhere, so the card's numbers compare with the CPU's.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmuls and cuDNN convolutions")
    return {"platform": "gpu", "kind": name, "count": count}


def build_phase() -> None:
    from acousticswarms_speech_tpu_torch.ops import roll_kernel

    t0 = time.time()
    path = roll_kernel.build()
    log(f"build: {os.path.relpath(path, REPO)} in {time.time() - t0:.2f}s")
    for line in roll_kernel.build_log().splitlines():
        if "ptxas" in line or "registers" in line or "spill" in line:
            print(f"  {line.strip()}", flush=True)


def _shift_table(B: int, T: int, gen) -> "torch.Tensor":
    """Random shifts in (-T, T), with the edge cases -(T-1), -5, 0, 3 and
    T-1 on every channel of the first five candidates."""
    import torch

    shifts = torch.randint(-T + 1, T, (B, 7), generator=gen, dtype=torch.int32)
    for k, s in enumerate([-(T - 1), -5, 0, 3, T - 1][:B]):
        shifts[k] = s
    return shifts


def check_kernel(mix, shifts) -> dict:
    """The kernel against its plain version on one input; times of the
    kernel, the plain version and one torch.gather with a precomputed
    index, and the bytes bound."""
    import torch

    from acousticswarms_speech_tpu_torch.ops.roll_kernel import \
        roll_channels_batch_cuda
    from acousticswarms_speech_tpu_torch.ops.shift import \
        roll_channels_batch_plain

    B, M = shifts.shape
    T = mix.shape[1]
    got = roll_channels_batch_cuda(mix, shifts)
    want = roll_channels_batch_plain(mix, shifts)
    sync()
    if not torch.equal(got, want):
        bad = (got != want).sum().item()
        raise AssertionError(f"roll kernel != plain at B={B} T={T}: "
                             f"{bad} elements differ")
    err = (got - want).abs().max().item()
    del got, want
    src = torch.remainder(
        torch.arange(T, device=mix.device)[None, None, :]
        - shifts[:, :, None].long(), T)
    expanded = mix[None].expand(B, M, T)
    res = {
        "B": B, "M": M, "T": T, "max_abs_err": err,
        "ms": cuda_ms(lambda: roll_channels_batch_cuda(mix, shifts)),
        "plain_ms": cuda_ms(lambda: roll_channels_batch_plain(mix, shifts)),
        "library_ms": cuda_ms(lambda: torch.gather(expanded, 2, src)),
    }
    moved = 4 * (M * T + B * M + B * M * T)  # read mix and shifts, write out
    res["bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
    return res


def kernel_check_phase() -> None:
    import torch

    gen = torch.Generator().manual_seed(0)
    for B, T in KERNEL_SHAPES:
        mix = torch.randn(7, T, generator=gen).to(DEVICE)
        shifts = _shift_table(B, T, gen).to(DEVICE)
        r = check_kernel(mix, shifts)
        log(f"kernel check B={B} M=7 T={T}: equal; kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f}")


def launch_floor_phase() -> dict:
    """Where the roll kernel's ~0.03 ms floor on small launches comes from:
    the forward's smallest launch and an empty kernel through the same
    ctypes path, timed paced by the host (cuda_ms, as the kernel check
    times them) and queued behind a busy card (device time alone), with
    the wrapper's host time per call."""
    import torch

    from acousticswarms_speech_tpu_torch.ops import roll_kernel

    dev = torch.empty(0, device=DEVICE).device  # with its index
    gen = torch.Generator().manual_seed(1)
    B, T = 4, 144000
    mix = torch.randn(7, T, generator=gen).to(dev)
    shifts = _shift_table(B, T, gen).to(dev)

    def roll():
        roll_kernel.roll_channels_batch_cuda(mix, shifts)

    def empty():
        roll_kernel.empty_launch_cuda(dev)

    out = {
        f"roll_{B}x7x{T}": {
            "paced_ms": cuda_ms(roll), "queued_ms": queued_ms(roll),
            "bound_ms": 4 * (7 * T + 7 * B + 7 * B * T) / HBM_BYTES_PER_S * 1e3,
            "wrapper_host_us": host_us(roll, 500)},
        "empty": {"paced_ms": cuda_ms(empty), "queued_ms": queued_ms(empty),
                  "wrapper_host_us": host_us(empty)},
    }
    log(f"launch floor {json.dumps(out)}")
    return out


def main_path_phase():
    import numpy as np
    import torch

    from acousticswarms_speech_tpu_torch.models import load_release
    from acousticswarms_speech_tpu_torch.ops import shift as shift_ops
    from acousticswarms_speech_tpu_torch.ops.roll_kernel import \
        roll_channels_batch_cuda
    from acousticswarms_speech_tpu_torch.pipeline.joint import JointPipeline
    from acousticswarms_speech_tpu_torch.search import spotform

    mix = np.load(FIXTURE)["mix"].astype(np.float32)[:, :MIX_SAMPLES]
    log(f"fixture: mix {mix.shape}")
    t0 = time.time()
    spot = load_release(SPOT_DIR, DEVICE)
    sep = load_release(SEP_DIR, DEVICE)
    log(f"release weights loaded in {time.time() - t0:.2f}s: SpotNet "
        f"{sum(p.numel() for p in spot.parameters())} params, SepNet "
        f"{sum(p.numel() for p in sep.parameters())} params "
        f"(max_speakers {sep.max_speakers})")
    pipe = JointPipeline(spot, sep, device=DEVICE)
    t0 = time.time()
    pipe.setup(MIC_POS, ROI, cache_dir=CACHE_DIR)
    log(f"setup in {time.time() - t0:.2f}s "
        f"(G={pipe.mic_processor.geom.num_clusters})")

    t0 = time.time()
    pipe.forward(mix)
    sync()
    log(f"warm-up forward {time.time() - t0:.2f}s")

    # Record the roll shapes of the timed forward without changing its path.
    shapes = []
    real_roll = shift_ops.roll_channels_batch

    def recording_roll(m, s):
        shapes.append((m.clone(), s.clone()))
        return real_roll(m, s)

    spotform.roll_channels_batch = recording_roll
    shift_ops.roll_channels_batch = recording_roll
    pipe.spot_model.calls = 0
    roll_channels_batch_cuda.launches = 0
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    patches, audio_loc, audio, _, _, spot_times = pipe.forward(mix)
    sync()
    wall = time.time() - t0
    launches = roll_channels_batch_cuda.launches
    spotform.roll_channels_batch = real_roll
    shift_ops.roll_channels_batch = real_roll

    metrics = pipe.stage_metrics()
    log(f"timed forward {wall:.3f}s; stage_metrics "
        f"{json.dumps(metrics)}; spot_times {spot_times}")
    log(f"roll kernel launches in the timed forward: {launches} at "
        f"(B, M, T) {[tuple(s.shape) + (m.shape[1],) for m, s in shapes]}")
    if launches <= 0:
        raise AssertionError("the forward never launched the roll kernel")
    if launches != len(shapes):
        raise AssertionError(f"{launches} launches for {len(shapes)} rolls")
    n = len(patches)
    if n < 1:
        raise AssertionError("the forward found no speaker")
    audio = np.asarray(audio)
    audio_loc = np.asarray(audio_loc)
    T = mix.shape[1]
    if audio.shape != (n, T) or audio_loc.shape != (n, T):
        raise AssertionError(f"audio shapes {audio.shape}, {audio_loc.shape} "
                             f"for {n} heads and T={T}")
    if not (np.isfinite(audio).all() and np.isfinite(audio_loc).all()):
        raise AssertionError("non-finite audio")
    src = np.asarray(SRC_POS)[:, :2]
    for k, pf in enumerate(patches):
        pos = np.asarray(pf[0].center_pos())
        d = np.linalg.norm(src - pos[:2], axis=1)
        log(f"head {k}: (x, y) = ({pos[0]:.3f}, {pos[1]:.3f}); nearest "
            f"source {int(d.argmin())} at {d.min():.3f} m; audio rms "
            f"{float(np.sqrt((audio[k] ** 2).mean())):.5f}")
    # The largest sweep of the forward (the fine one) alone, synchronized:
    # its device-bound time, against the fine stage's wall time.
    m, s = max(shapes, key=lambda r: r[1].shape[0] * r[0].shape[1])
    offsets = list(-s[:, 1:].cpu().numpy().astype(float))
    sync()
    t0 = time.time()
    pipe.spot_model.sweep(m, offsets, strict=1, with_similarity=True).powers
    sweep_s = time.time() - t0
    log(f"fine sweep alone (B={len(offsets)}, T={m.shape[1]}): {sweep_s:.3f}s")
    return pipe, mix, shapes, launches, {
        "wall_s": wall, "heads": n, **metrics,
        "fine_sweep_alone_s": sweep_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def reference_phase(pipe, mix, shapes, launches) -> dict:
    """The card against the port's CPU code, and the kernel at the main
    path's own shapes; returns the kernel row of the largest launch."""
    import numpy as np
    import torch

    from acousticswarms_speech_tpu_torch.models import load_release
    from acousticswarms_speech_tpu_torch.ops.srp import (srp_phat_map,
                                                         srp_window_size)

    srp = pipe.mic_processor.srp.computer
    window = srp_window_size(mix.shape[1])
    gpu_map = srp(mix, window).cpu()
    cpu_map = srp_phat_map(torch.from_numpy(mix), srp.steer_re.cpu(),
                           srp.steer_im.cpu(), srp.bins.cpu(), window,
                           srp.nfft, srp.hop)
    err = (gpu_map - cpu_map).abs().max().item()
    log(f"SRP map card vs CPU: max abs err {err:.3e} (map max "
        f"{cpu_map.max().item():.4f})")
    # float32 sums in another order over 198 bins x 21 pairs x 67 frames
    assert err <= 1e-4 * max(1.0, cpu_map.abs().max().item()), err

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 7, 4096)).astype(np.float32))
    w = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    spot_cpu = load_release(SPOT_DIR, "cpu")
    with torch.no_grad():
        want = spot_cpu(x, w)
        got = pipe.spot_model.model(x.to(DEVICE), w.to(DEVICE)).cpu()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"SpotNet card vs CPU (B=2, T=4096): max abs err {err:.3e} "
        f"(output max {scale:.3f})")
    # float32 with TF32 off; cuDNN and the CPU sum in other orders
    assert err <= 1e-3 * scale, err
    del spot_cpu

    sep_cpu = load_release(SEP_DIR, "cpu")
    seg = mix[:, mix.shape[1] // 3:mix.shape[1] // 3 + 8192]
    offs = [np.zeros(6), np.array([3.0, -2, 4, 1, -5, 2])]
    with torch.no_grad():
        want = torch.from_numpy(
            _separate(sep_cpu, seg, offs, "cpu"))
        got = torch.from_numpy(pipe.sep_model.infer_sample(seg, offs))
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"SepNet card vs CPU (2 speakers, T=8192): max abs err {err:.3e} "
        f"(output max {scale:.4f})")
    assert err <= 1e-3 * scale, err
    del sep_cpu

    rows = []
    for m, s in shapes:
        r = check_kernel(m.contiguous(), s.contiguous())
        rows.append(r)
        log(f"kernel at main-path shape B={r['B']} T={r['T']}: equal; "
            f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f}")
    big = max(rows, key=lambda r: r["B"] * r["T"])
    return {
        "name": "roll_channels_batch", "route": "cuda",
        "source": "acousticswarms_speech_tpu_torch/csrc/roll.cu",
        "replaces": "acousticswarms_speech_tpu/ops/pallas_shift.py:36",
        "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": "bytes",
        "library_ms": big["library_ms"],
        "shape": [big["B"], big["M"], big["T"]],
    }


class _StageClock:
    """Adds up, across threads, the wall time spent in wrapped methods."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self._lock = threading.Lock()

    def wrap(self, cls, name):
        real = getattr(cls, name)
        clock = self

        def timed(*args, **kwargs):
            t0 = time.time()
            try:
                return real(*args, **kwargs)
            finally:
                with clock._lock:
                    clock.seconds[name] = (clock.seconds.get(name, 0.0)
                                           + time.time() - t0)

        setattr(cls, name, timed)
        return real


def _finite_numbers(obj) -> bool:
    if isinstance(obj, dict):
        return all(_finite_numbers(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(_finite_numbers(v) for v in obj)
    if isinstance(obj, float):
        return math.isfinite(obj)
    return True


def _json_diff(a, b, path=""):
    """Paths (with both values) where two JSON objects differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        keys = sorted(set(a) | set(b))
        return [d for k in keys for d in _json_diff(a.get(k), b.get(k),
                                                   f"{path}.{k}")]
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _json_diff(x, y, f"{path}[{i}]")]
    return [] if a == b else [f"{path}: {a!r} vs {b!r}"]


def _repeatability_probe(pipe) -> dict:
    """Whether the two networks give bit-equal outputs for the same input
    twice in a row on the card (cuDNN may pick algorithms that accumulate
    with atomics, e.g. for transposed convolutions)."""
    import numpy as np
    import torch

    from acousticswarms_speech_tpu_torch.pipeline.evaluate import get_items

    _, mix, _ = get_items(os.path.join(DEV_SET, "00000"))
    x = torch.as_tensor(mix, device=DEVICE)
    rng = np.random.default_rng(0)
    shifts = torch.as_tensor(rng.integers(-200, 200, size=(64, 7)),
                             dtype=torch.int32, device=DEVICE)
    shifts[:, 0] = 0
    from acousticswarms_speech_tpu_torch.ops.shift import roll_channels_batch_plain

    rolled = roll_channels_batch_plain(x, shifts)
    w = torch.tensor([[0.0, 1.0]], device=DEVICE).expand(64, 2)
    out = {}
    with torch.no_grad():
        a = pipe.spot_model.model(rolled, w)
        b = pipe.spot_model.model(rolled, w)
        out["spotnet_equal"] = bool(torch.equal(a, b))
        out["spotnet_max_diff"] = float((a - b).abs().max())
        sep_in = rolled[:2].reshape(1, 14, -1)
        n = torch.tensor([2], device=DEVICE)
        a = pipe.sep_model.model(sep_in, n)
        b = pipe.sep_model.model(sep_in, n)
        out["sepnet_equal"] = bool(torch.equal(a, b))
        out["sepnet_max_diff"] = float((a - b).abs().max())
    return out


def _read_results(folder: str) -> dict:
    out = {}
    for name in sorted(os.listdir(folder)):
        if name.startswith("result_"):
            with open(os.path.join(folder, name)) as f:
                out[name] = json.load(f)
    return out


def eval_phase() -> dict:
    """evaluate_dataset of the port over the dev scenes on both release
    experiments: serially with cuDNN's default algorithms (what the CLI
    runs), then serially and with two lanes with deterministic cuDNN
    algorithms, whose results must be equal; checks and quality numbers."""
    import torch

    from acousticswarms_speech_tpu_torch.ops import shift as shift_ops
    from acousticswarms_speech_tpu_torch.ops.roll_kernel import \
        roll_channels_batch_cuda
    from acousticswarms_speech_tpu_torch.pipeline import throughput
    from acousticswarms_speech_tpu_torch.pipeline.analyze import analyze
    from acousticswarms_speech_tpu_torch.pipeline.evaluate import \
        evaluate_dataset
    from acousticswarms_speech_tpu_torch.pipeline.joint import JointPipeline
    from acousticswarms_speech_tpu_torch.search import spotform

    scenes = sorted(d for d in os.listdir(DEV_SET)
                    if os.path.isdir(os.path.join(DEV_SET, d)))
    t0 = time.time()
    pipe = JointPipeline.from_experiments(SPOT_DIR, SEP_DIR, device=DEVICE)
    log(f"eval: from_experiments in {time.time() - t0:.2f}s; "
        f"{len(scenes)} dev scenes")
    probe = _repeatability_probe(pipe)
    log(f"eval: repeatability on the card with cuDNN's default algorithms: "
        f"{json.dumps(probe)}")
    default_dir = os.path.join(OUT_DIR, "eval_serial_default")
    serial_dir = os.path.join(OUT_DIR, "eval_serial")
    lanes_dir = os.path.join(OUT_DIR, "eval_lanes")
    for d in (default_dir, serial_dir, lanes_dir):
        shutil.rmtree(d, ignore_errors=True)

    clock = _StageClock()
    real_setup = clock.wrap(JointPipeline, "setup")
    real_forward = clock.wrap(JointPipeline, "forward")
    real_run = throughput.PipelinedRunner.run
    real_roll = shift_ops.roll_channels_batch
    shapes, stats = [], {}

    def recording_roll(m, s):
        shapes.append((m.clone(), s.clone()))
        return real_roll(m, s)

    def recording_run(self, *args, **kwargs):
        results, st = real_run(self, *args, **kwargs)
        stats.update(st)
        return results, st

    def timed_eval(folder, **kwargs):
        """(counts, seconds, roll launches, setup and forward seconds)."""
        clock.seconds.clear()
        roll_channels_batch_cuda.launches = 0
        sync()
        t0 = time.time()
        counts = evaluate_dataset(pipe, DEV_SET, results_folder=folder,
                                  **kwargs)
        sync()
        return (counts, time.time() - t0, roll_channels_batch_cuda.launches,
                dict(clock.seconds))

    torch.cuda.reset_peak_memory_stats()
    try:
        # The inputs of every roll launch of this pass are recorded, to hold
        # the kernel against its plain version on them afterwards.
        spotform.roll_channels_batch = recording_roll
        shift_ops.roll_channels_batch = recording_roll
        try:
            counts, default_s, default_launches, default_clock = \
                timed_eval(default_dir)
        finally:
            spotform.roll_channels_batch = real_roll
            shift_ops.roll_channels_batch = real_roll
        if default_launches != len(shapes) or default_launches <= 0:
            raise AssertionError(f"serial eval: {default_launches} roll "
                                 f"launches for {len(shapes)} rolls")
        # The lanes run must reproduce the serial results bit for bit, so
        # cuDNN is held to deterministic algorithms for these two passes.
        torch.backends.cudnn.deterministic = True
        probe = _repeatability_probe(pipe)
        log(f"eval: repeatability with cudnn.deterministic: "
            f"{json.dumps(probe)}")
        det_counts, serial_s, serial_launches, serial_clock = \
            timed_eval(serial_dir)
        throughput.PipelinedRunner.run = recording_run
        lane_counts, lanes_s, lanes_launches, _ = timed_eval(lanes_dir,
                                                             lanes=2)
    finally:
        throughput.PipelinedRunner.run = real_run
        JointPipeline.setup = real_setup
        JointPipeline.forward = real_forward
        torch.backends.cudnn.deterministic = False
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    default = _read_results(default_dir)
    serial, lanes = _read_results(serial_dir), _read_results(lanes_dir)
    for name, results in (("default", default), ("serial", serial)):
        if sorted(results) != [f"result_{s}.json" for s in scenes]:
            raise AssertionError(f"{name} results: {sorted(results)}")
        for scene, res in results.items():
            if not _finite_numbers(res):
                raise AssertionError(f"non-finite value in {name} {scene}")
    if lane_counts != det_counts or sorted(lanes) != sorted(serial):
        raise AssertionError(f"lanes {lane_counts} != serial {det_counts}")
    diffs = []
    for name, want in serial.items():
        got = dict(lanes[name])
        want = dict(want)
        got.pop("stage_times")
        want.pop("stage_times")
        diffs += [f"{name} {d}" for d in _json_diff(want, got)]
    if diffs:
        for d in diffs[:40]:
            log(f"eval: lanes differ from serial: {d}")
        raise AssertionError(f"{len(diffs)} values of the lanes results "
                             f"differ from the serial ones")
    if not serial_launches == lanes_launches == default_launches:
        raise AssertionError(f"roll launches: {default_launches} default, "
                             f"{serial_launches} deterministic serial, "
                             f"{lanes_launches} lanes")
    summary = analyze(default_dir, verbose=False)
    det_summary = analyze(serial_dir, verbose=False)
    if analyze(lanes_dir, verbose=False) != det_summary:
        raise AssertionError("analyze differs between serial and lanes runs")
    for name, summ in (("default", summary), ("deterministic", det_summary)):
        if summ["tp"] <= 0 or not _finite_numbers(summ):
            raise AssertionError(f"analyze of the {name} run: {summ}")

    def f1(summ):
        p, r = summ["precision"], summ["recall"]
        return 2 * p * r / (p + r) if p + r > 0 else 0.0

    quality_keys = ("tp", "fp", "fn", "precision", "recall", "sisdri_mean",
                    "sisdri_mir_mean", "loc_err_median")
    n = len(scenes)
    out = {
        "scenes": n, **{k: summary[k] for k in quality_keys},
        "f1": f1(summary),
        "deterministic": {**{k: det_summary[k] for k in quality_keys},
                          "f1": f1(det_summary)},
        "serial_s": default_s, "serial_s_per_scene": default_s / n,
        "serial_setup_s": default_clock.get("setup", 0.0),
        "serial_forward_s": default_clock.get("forward", 0.0),
        "deterministic_serial_s": serial_s,
        "deterministic_serial_forward_s": serial_clock.get("forward", 0.0),
        "deterministic_lanes_s": lanes_s,
        "deterministic_lanes_mixtures_per_s": stats["mixtures_per_sec"],
        "lane_utilization": stats["lane_utilization"],
        "roll_launches_serial": default_launches,
        "roll_launches_serial_deterministic": serial_launches,
        "roll_launches_lanes": lanes_launches, "peak_memory_gb": peak_gb,
    }
    for label, summ in (("cuDNN default", summary),
                        ("cuDNN deterministic", det_summary)):
        log(f"eval ({label}): P {summ['precision']:.4f} R "
            f"{summ['recall']:.4f} F1 {f1(summ):.4f} (tp {summ['tp']}, fp "
            f"{summ['fp']}, fn {summ['fn']}); SI-SDRi "
            f"{summ['sisdri_mean']:.3f} dB, SI-SDRi (mir) "
            f"{summ['sisdri_mir_mean']:.3f} dB; median localization error "
            f"{summ['loc_err_median']:.3f} m")
    log(f"eval: serial, cuDNN default {default_s:.2f}s = {default_s / n:.3f} "
        f"s/scene (setup {out['serial_setup_s']:.2f}s, forward "
        f"{out['serial_forward_s']:.2f}s in all); serial, cuDNN "
        f"deterministic {serial_s:.2f}s = {serial_s / n:.3f} s/scene (forward "
        f"{out['deterministic_serial_forward_s']:.2f}s); lanes=2, cuDNN "
        f"deterministic {lanes_s:.2f}s = {stats['mixtures_per_sec']:.4f} "
        f"mixtures/s, lane utilization "
        f"{[round(u, 3) for u in stats['lane_utilization']]}; lanes results "
        f"equal to the deterministic serial ones apart from stage_times")
    log(f"eval: roll kernel launches {default_launches} serial (default), "
        f"{serial_launches} serial (deterministic), {lanes_launches} lanes; "
        f"peak device memory {peak_gb:.2f} GB")

    from acousticswarms_speech_tpu_torch.ops.shift import \
        roll_channels_batch_plain

    rows = {}
    for m, s in shapes:  # every launch of the serial run; timed once a shape
        key = (s.shape[0], m.shape[1])
        if key not in rows:
            rows[key] = check_kernel(m.contiguous(), s.contiguous())
        elif not torch.equal(roll_channels_batch_cuda(m, s),
                             roll_channels_batch_plain(m, s)):
            raise AssertionError(f"roll kernel != plain at eval shape {key}")
    for (B, T), r in sorted(rows.items()):
        log(f"kernel at eval shape B={B} T={T}: equal; kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f}")
    out["kernel_shapes_checked"] = len(rows)
    out["kernel_max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    big = max(rows.values(), key=lambda r: r["B"] * r["T"])
    out["largest_launch"] = {k: big[k] for k in
                             ("B", "M", "T", "ms", "plain_ms", "library_ms",
                              "bound_ms")}
    return out


def _train_experiment(src_dir: str, name: str) -> str:
    """A copy of `src_dir`'s description that trains on the dev scenes and
    warm-starts from `src_dir` (its release weights)."""
    with open(os.path.join(src_dir, "description.json")) as f:
        desc = json.load(f)
    desc["train_set_params"]["input_dir"] = DEV_SET
    desc["test_set_params"]["input_dir"] = DEV_SET
    desc["training_params"]["pretrain_path"] = src_dir
    desc["training_params"]["epochs"] = 1
    exp = os.path.join(OUT_DIR, name)
    shutil.rmtree(exp, ignore_errors=True)
    os.makedirs(exp)
    with open(os.path.join(exp, "description.json"), "w") as f:
        json.dump(desc, f, indent=4)
    return exp, desc


def train_phase() -> dict:
    """train() of both release descriptions at full width, 3 steps each."""
    import torch

    from acousticswarms_speech_tpu_torch.models.msgpack_reader import \
        read_msgpack
    from acousticswarms_speech_tpu_torch.training.experiment import \
        load_model_from_exp
    from acousticswarms_speech_tpu_torch.training.train import train

    out = {}
    for src in (SPOT_DIR, SEP_DIR):
        name = "train_" + os.path.basename(src)
        exp, desc = _train_experiment(src, name)
        steps, trained = [], []

        def on_step(model, info):
            steps.append(info)
            trained[:] = [model]

        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        train_losses, val_losses = train(exp, max_steps_per_epoch=3,
                                         print_interval=1, device=DEVICE,
                                         on_step=on_step)
        wall = time.time() - t0
        losses = [s["loss"] for s in steps]
        if len(steps) != 3 or not all(math.isfinite(x) for x in
                                      losses + train_losses + val_losses):
            raise AssertionError(f"{name}: steps {steps}, train "
                                 f"{train_losses}, val {val_losses}")
        ckpt = os.path.join(exp, "checkpoints", f"{name}_0.msgpack")
        tree = read_msgpack(ckpt)
        n_arrays = len(_flatten_tree(tree["params"]))
        loaded = load_model_from_exp(exp, mode="best", device=DEVICE)
        want = trained[0].state_dict()
        got = loaded.state_dict()
        if set(got) != set(want) or n_arrays != len(want):
            raise AssertionError(f"{name}: checkpoint keys differ")
        for k, v in want.items():
            if not torch.equal(got[k], v):
                raise AssertionError(f"{name}: checkpoint {k} != trained")
        out[name] = {
            "batch_size": desc["training_params"]["batch_size"],
            "losses": losses, "train_loss": train_losses[0],
            "val_loss": val_losses[0],
            "step_s_median_2_3": statistics.median(s["seconds"]
                                                   for s in steps[1:]),
            "step_s": [s["seconds"] for s in steps], "wall_s": wall,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "params": sum(v.numel() for v in want.values()),
        }
        log(f"train {name}: losses {losses}; val {val_losses[0]:.6f}; step "
            f"time median of steps 2-3 {out[name]['step_s_median_2_3']:.3f}s; "
            f"peak device memory {out[name]['peak_memory_gb']:.2f} GB; "
            f"checkpoint ({n_arrays} arrays) reads back equal to the trained "
            f"parameters")
    return out


def _flatten_tree(tree, prefix=""):
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten_tree(v, f"{prefix}{k}."))
        else:
            flat[prefix + k] = v
    return flat


def _separate(model, seg, offs, device):
    from acousticswarms_speech_tpu_torch.search.spotform import \
        SeparationInference

    return SeparationInference(model, device=device).infer_sample(seg, offs)


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    sys.path.insert(0, REPO)
    try:
        from acousticswarms_speech_tpu_torch.ops.roll_kernel import \
            roll_channels_batch_cuda  # (fails early outside the repo)

        device = device_phase()
        build_phase()
        kernel_check_phase()
        launch_floor_phase()
        pipe, mix, shapes, launches, summary = main_path_phase()
        kernel_row = reference_phase(pipe, mix, shapes, launches)
        log(f"main path summary {json.dumps(summary)}")
        del pipe
        t0 = time.time()
        evaluation = eval_phase()
        log(f"evaluation phase {time.time() - t0:.2f}s: "
            f"{json.dumps(evaluation)}")
        t0 = time.time()
        roll_channels_batch_cuda.launches = 0
        training = train_phase()
        train_launches = roll_channels_batch_cuda.launches
        log(f"training phase {time.time() - t0:.2f}s: {json.dumps(training)}; "
            f"roll kernel launches {train_launches}")
        # The datasets shift on the host and the kernel has no VJP.
        if train_launches != 0:
            raise AssertionError(f"training launched the roll kernel "
                                 f"{train_launches} times")
        kernel_row["launches_by_path"] = {
            "joint_forward": launches,
            "evaluate_serial": evaluation["roll_launches_serial"],
            "evaluate_serial_deterministic":
                evaluation["roll_launches_serial_deterministic"],
            "evaluate_lanes": evaluation["roll_launches_lanes"],
            "train": train_launches,
        }
        kernel_row["eval_largest_launch"] = evaluation["largest_launch"]
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        return 1
    finally:
        faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": [kernel_row]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
