#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printed with the seconds since start:
  device       the card's name, count and power limit;
  build        nvcc builds the roll kernel (csrc/roll.cu), its register
               and spill report is printed, and g++ builds the WAV loader
               (csrc/wavloader.cpp), both started together;
  kernel check the roll kernel against its plain PyTorch version (exact
               equality: it is a copy) at M = 7, T in {72000, 144000},
               B in {32, 37, 512}, and at B = 7000, M = 10, T = 1024 (70000
               rows, past the grid's y limit of 65535), with edge and
               random shifts, timed with CUDA events beside the plain
               version, one torch.gather and the bytes bound;
  main path    JointPipeline.forward of the port on the 3 s, 7-mic bench
               scene (.bench_fixture_v2.npz) with both release networks at
               full width in float32: a warm-up forward, then a timed one
               with the kernel's launch count reset just before it, and
               the count of candidates subdivided beside the coarse sweep;
  reference    the card's SRP map, SpotNet and SepNet outputs against the
               same port code on the CPU, on the bench scene or a slice of it,
               and the roll kernel at every shape the main path gave it;
  profile      one more forward with profile_dir (torch.profiler, host and
               card): device busy time and idle share, the top device ops,
               each stage span's time; the trace's roll kernels must number
               the kernel counter's launches;
  bf16         (a) SpotNet on 8 candidates of the fine sweep's rolled
               inputs and SepNet at the bench scene's heads, in bfloat16
               on the card and on the CPU; (b) the bench-scene forward with
               use_bf16=True, warm-up then timed, its heads beside the
               float32 ones;
  bench        scripts/bench as a child process in bfloat16, 3 timed
               forwards and two lanes over 4 mixtures: exit 0, a last line
               with the latency rate (1 / the median forward) as `value`,
               the throughput and 5-entry stage lists, no kernel built
               (compile_cache), roll kernel launches in every timed forward;
               its heads and spot calls beside the bf16 phase's;
  many_mics    the 10-mic configuration: two 3 s scenes and a 1 s one
               (10 mics, 3 talkers) rendered on the card and on the CPU,
               compared as in the generation phase; both release
               descriptions at full width with n_mics = 10 and weights
               from seeds, written as experiments under chip_smoke_out/
               and loaded by from_experiments; evaluate_dataset and analyze
               over the two 3 s scenes, the first scene's set-up at grid
               0.05 m (G, the steering table's bytes, the seconds) and
               forward giving the float32 figures; that scene's bfloat16
               forward, its heads matched against float32's, and the
               networks in bfloat16 at 10 and 20 input channels on seeded
               inputs of that scene (SpotNet on 2 candidates of 1 s, SepNet
               on 2 speakers over 0.5 s), card against CPU as in the bf16
               phase;
               forward_streaming over the 1 s scene in chunks of 28000
               samples with 8000 of overlap; the narrow networks (seeded)
               on 0.5 s of the first scene on the card with deterministic
               cuDNN, and on the CPU in a child process (with the CPU's
               bfloat16 networks) started once the experiments are
               written: the same heads within the 0.1 m grid, audio at
               >= 30 dB SI-SDR.  The roll kernel's launches are counted per
               step, the kernel is held against its plain version on every
               launch and its largest launch is timed; the peak device
               memory is logged;
  evaluation   JointPipeline.from_experiments of both release experiments,
               evaluate_dataset over the 16 dev scenes (.devdata_v2/test):
               serially with cuDNN's default algorithms (as the evaluate
               CLI runs), then serially and with lanes=2 over every fourth
               scene (4 of the 16) with cuDNN held to deterministic
               algorithms, where the lanes' result JSONs must equal the
               serial ones apart from stage times; analyze
               reads all three, every output is finite, the roll kernel is
               held against its plain version on the inputs of every
               launch of the first pass, and SepNet at each scene's true
               TDoAs gives the oracle-position SI-SDRi;
  bf16 eval    scripts/precompute_geometry.py writes the geometry caches
               into a copy of every other dev scene (8 of the 16), each
               checked against a fresh build, then evaluate_dataset in
               bfloat16, serially, reads them (--cached_init); P/R/F1 and
               SI-SDRi beside float32's;
  retune       (a) evaluate_dataset with power tracing (search/
               power_trace.py), float32 and deterministic cuDNN, over dev
               scenes 00000, 00004, 00008 and 00012: results equal to the
               evaluation phase's deterministic serial pass but for stage
               times, an nms_summary with pair_sisdr in the trace of every
               scene that reached the NMS, and scripts/replay_nms at the
               run's own settings giving each scene its live head count;
               (b) scripts/retune_release (the traced probe in bfloat16,
               analyze, the three trace analyzers, the replay in four modes,
               the provenance) and (d) scripts/run_eval_suite
               (--skip_bench: the bench phase runs the bench), each as a
               child process on dev scene 00000 of the bf16 phase's copy
               (--num_shards 16), both started together: exit 0 and every
               table printed; (c) scripts/probe_sep_batch at full width,
               batch sizes 1, 2 and 4: a finite step time and a peak memory
               for each;
  training     train() of each release description at full width for one
               epoch of 3 steps on the dev scenes, warm-started from the
               release weights; losses finite, and the written checkpoint
               reads back through load_model_from_exp equal to the trained
               parameters;
  tools        export_release of both trained experiments, read back
               through JointPipeline.from_release (the float16 rounding of
               the trained parameters); seed_checkpoint_from_release into a
               fresh experiment, from which train() resumes for one step;
  generation   a seeded voice bank, then two scenes (7 mics, 3 talkers,
               3 s; max_order 10 and --sample_rt60) with the room rendered
               on the card and again on the CPU: premix within 1e-6 of its
               peak, metadata.json equal, WAVs within 1 LSB;
  mining       the 16 dev scenes copied and mined on the card, two again
               on the CPU: SRP maps within 1e-5 of their peak, labels
               equal (a difference only for a candidate within that
               tolerance of a detection threshold);
  baselines    MicArray with the MUSIC and TOPS prune methods on dev scene
               00000, card against CPU: maps within 1e-8 of their peak,
               pruned patches equal; TOPS's smallest singular value by
               svdvals against the Gram route it uses;
  loader       the native WAV loader's reads of the dev mixtures equal to
               utils.audio's;
  mesh         parallel/ on the card, in spawned ranks that load the
               release networks themselves: (a) the main path's fine sweep
               (336 candidates, T = 72000) through SpotformExecutor(mesh=)
               on an nccl mesh of world size 1, against the unsharded
               sweep; (b) two gloo ranks sharing the card, cuDNN held to
               deterministic algorithms: the same sweep sharded 168 + 168
               against the unsharded one (powers rtol 1e-4, SI-SDR matrix
               atol 1e-2, waveforms 1e-4 of the peak), then
               JointPipeline(mesh=).forward of the bench scene on both
               ranks against the unsharded forward (the same heads; audio
               within 1e-4 of the peak); (c) the dry run
               (parallel/dryrun.py) on two gloo ranks.  Each rank counts its
               roll kernel launches over its sharded work and holds the
               kernel against its plain version on its largest launch.
The roll kernel is held against its plain version on the inputs of every
launch of the profiled forward, the bf16 forward, the bf16 evaluation, the
traced evaluation and the 10-mic phase, which fails unless it launched the
kernel.  Its launch count is set to 0 before the batch
probe and the training, tools, generation, mining and baselines phases and
read after each; the run fails unless each is 0.  The mesh phase's ranks count theirs (mesh_rank0,
mesh_rank1); the run fails unless each is above 0.

The last line is {"ok": true, "device": {...}}; the line before it holds the
kernel table as JSON.  Any fault prints a traceback and exits 1 without
those lines; so does a machine without CUDA.  A watchdog ends a run that
hangs.  The script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import faulthandler
import glob
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
# (B, M, T): the 7-mic sweeps' sizes, and 7000 candidates of 10 mics, whose
# 70000 rows pass the grid's y limit of 65535.
KERNEL_SHAPES = ([(B, 7, T) for T in (72000, 144000) for B in (32, 37, 512)]
                 + [(7000, 10, 1024)])

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


@contextlib.contextmanager
def recording_rolls():
    """Yields a list that receives (mix, shifts) copies of every roll of
    the sweeps and separation while the block runs, without changing what
    they compute."""
    from acousticswarms_speech_tpu_torch.ops import shift as shift_ops
    from acousticswarms_speech_tpu_torch.search import spotform

    rolls = []
    real = shift_ops.roll_channels_batch

    def recording(m, s):
        rolls.append((m.clone(), s.clone()))
        return real(m, s)

    spotform.roll_channels_batch = shift_ops.roll_channels_batch = recording
    try:
        yield rolls
    finally:
        spotform.roll_channels_batch = shift_ops.roll_channels_batch = real


def hold_rolls(rolls, label: str) -> None:
    """The roll kernel against its plain version on the inputs of every
    recorded launch: exact equality, or the run fails."""
    import torch

    from acousticswarms_speech_tpu_torch.ops.roll_kernel import \
        roll_channels_batch_cuda
    from acousticswarms_speech_tpu_torch.ops.shift import \
        roll_channels_batch_plain

    for m, s in rolls:
        got = roll_channels_batch_cuda(m, s)
        if not torch.equal(got, roll_channels_batch_plain(m, s)):
            raise AssertionError(f"{label}: roll kernel != plain at "
                                 f"{tuple(s.shape) + (m.shape[1],)}")


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


def build_phase() -> dict:
    """nvcc builds the roll kernel and g++ the WAV loader, both started
    together; returns each build's seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from acousticswarms_speech_tpu_torch.ops import roll_kernel
    from acousticswarms_speech_tpu_torch.runtime import native

    def timed(build):
        t0 = time.time()
        return build(), time.time() - t0

    builds = {"roll.cu (nvcc)": roll_kernel.build,
              "wavloader.cpp (g++)": native.build}
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {k: pool.submit(timed, fn) for k, fn in builds.items()}
        done = {k: f.result() for k, f in futures.items()}
    for name, (path, sec) in done.items():
        log(f"build {name}: {os.path.relpath(path, REPO)} in {sec:.2f}s")
    for line in roll_kernel.build_log().splitlines():
        if "ptxas" in line or "registers" in line or "spill" in line:
            print(f"  {line.strip()}", flush=True)
    return {name: sec for name, (_, sec) in done.items()}


def _shift_table(B: int, M: int, T: int, gen) -> "torch.Tensor":
    """Random shifts in (-T, T), with the edge cases -(T-1), -5, 0, 3 and
    T-1 on every channel of the first five candidates."""
    import torch

    shifts = torch.randint(-T + 1, T, (B, M), generator=gen, dtype=torch.int32)
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
    for B, M, T in KERNEL_SHAPES:
        mix = torch.randn(M, T, generator=gen).to(DEVICE)
        shifts = _shift_table(B, M, T, gen).to(DEVICE)
        r = check_kernel(mix, shifts)
        log(f"kernel check B={B} M={M} T={T}: equal; kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f}")


def main_path_phase():
    import numpy as np
    import torch

    from acousticswarms_speech_tpu_torch.models import load_release
    from acousticswarms_speech_tpu_torch.ops.roll_kernel import \
        roll_channels_batch_cuda
    from acousticswarms_speech_tpu_torch.pipeline.joint import JointPipeline

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

    # Count the candidates subdivided beside the coarse sweep: those the
    # processor subdivides before the coarse result is read.
    proc = pipe.mic_processor
    overlap = {"subdivided": 0, "subdivide_s": 0.0}

    def subdivide(patch):
        overlap["subdivided"] += 1
        t0 = time.time()
        try:
            return type(proc).subdivide_patch(proc, patch)
        finally:
            overlap["subdivide_s"] += time.time() - t0

    def big_patch(mix_data, patch_list, *args, **kwargs):
        overlap["beside_coarse"] = overlap["subdivided"]
        overlap["candidates"] = len(patch_list)
        return type(proc).spotform_big_patch(proc, mix_data, patch_list,
                                             *args, **kwargs)

    proc.subdivide_patch, proc.spotform_big_patch = subdivide, big_patch
    pipe.spot_model.calls = 0
    try:
        # the roll inputs of the timed forward, recorded
        with recording_rolls() as shapes:
            roll_channels_batch_cuda.launches = 0
            sync()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            patches, audio_loc, audio, _, _, spot_times = pipe.forward(mix)
            sync()
            wall = time.time() - t0
            launches = roll_channels_batch_cuda.launches
    finally:
        del proc.subdivide_patch, proc.spotform_big_patch

    metrics = pipe.stage_metrics()
    log(f"timed forward {wall:.3f}s; stage_metrics "
        f"{json.dumps(metrics)}; spot_times {spot_times}")
    log(f"roll kernel launches in the timed forward: {launches} at "
        f"(B, M, T) {[tuple(s.shape) + (m.shape[1],) for m, s in shapes]}")
    log(f"coarse stage {metrics['time_coarse_spotform_s']:.4f}s: "
        f"{overlap['beside_coarse']} of {overlap['candidates']} candidates "
        f"subdivided beside the coarse sweep; {overlap['subdivided']} "
        f"subdivisions in the forward, {overlap['subdivide_s']:.3f}s of host "
        f"time in all")
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
    return pipe, mix, shapes, launches, (patches, audio), {
        "wall_s": wall, "heads": n, **metrics,
        "subdivided_beside_coarse": overlap["beside_coarse"],
        "coarse_candidates": overlap["candidates"],
        "subdivisions": overlap["subdivided"],
        "subdivide_s": overlap["subdivide_s"],
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
    runs), then serially and with two lanes over every fourth scene with
    deterministic cuDNN algorithms, whose results must be equal; checks
    and quality numbers."""
    import torch

    from acousticswarms_speech_tpu_torch.ops.roll_kernel import \
        roll_channels_batch_cuda
    from acousticswarms_speech_tpu_torch.pipeline import throughput
    from acousticswarms_speech_tpu_torch.pipeline.analyze import analyze
    from acousticswarms_speech_tpu_torch.pipeline.evaluate import \
        evaluate_dataset
    from acousticswarms_speech_tpu_torch.pipeline.joint import JointPipeline

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
    timed_forward = JointPipeline.forward
    real_run = throughput.PipelinedRunner.run
    stats = {}
    # The roll launches of each forward of the serial passes, in scene
    # order: what the lanes pass over its subset of scenes must launch.
    forward_launches = []

    def counting_forward(self, *args, **kwargs):
        before = roll_channels_batch_cuda.launches
        try:
            return timed_forward(self, *args, **kwargs)
        finally:
            forward_launches.append(roll_channels_batch_cuda.launches - before)

    JointPipeline.forward = counting_forward
    # every fourth scene: the retune phase's traced scenes among them
    lane_scenes = scenes[::4]

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
        with recording_rolls() as shapes:
            counts, default_s, default_launches, default_clock = \
                timed_eval(default_dir)
        default_forward_launches = list(forward_launches)
        if default_launches != len(shapes) or default_launches <= 0:
            raise AssertionError(f"serial eval: {default_launches} roll "
                                 f"launches for {len(shapes)} rolls")
        # The lanes run must reproduce the serial results bit for bit, so
        # cuDNN is held to deterministic algorithms for these two passes.
        torch.backends.cudnn.deterministic = True
        probe = _repeatability_probe(pipe)
        log(f"eval: repeatability with cudnn.deterministic: "
            f"{json.dumps(probe)}")
        forward_launches.clear()
        in_lanes = set(lane_scenes).__contains__
        det_counts, serial_s, serial_launches, serial_clock = \
            timed_eval(serial_dir, sample_filter=in_lanes)
        det_forward_launches = list(forward_launches)
        throughput.PipelinedRunner.run = recording_run
        lane_counts, lanes_s, lanes_launches, _ = timed_eval(
            lanes_dir, lanes=2, sample_filter=in_lanes)
    finally:
        throughput.PipelinedRunner.run = real_run
        JointPipeline.setup = real_setup
        JointPipeline.forward = real_forward
        torch.backends.cudnn.deterministic = False
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    default = _read_results(default_dir)
    serial, lanes = _read_results(serial_dir), _read_results(lanes_dir)
    for name, results, want in (("default", default, scenes),
                                ("serial", serial, lane_scenes),
                                ("lanes", lanes, lane_scenes)):
        if sorted(results) != [f"result_{s}.json" for s in want]:
            raise AssertionError(f"{name} results: {sorted(results)}")
        for scene, res in results.items():
            if not _finite_numbers(res):
                raise AssertionError(f"non-finite value in {name} {scene}")
    if lane_counts != det_counts:
        raise AssertionError(f"lanes {lane_counts} != serial {det_counts}")
    diffs = []
    for name in sorted(lanes):
        got = dict(lanes[name])
        want = dict(serial[name])
        got.pop("stage_times")
        want.pop("stage_times")
        diffs += [f"{name} {d}" for d in _json_diff(want, got)]
    if diffs:
        for d in diffs[:40]:
            log(f"eval: lanes differ from serial: {d}")
        raise AssertionError(f"{len(diffs)} values of the lanes results "
                             f"differ from the serial ones")
    # The default pass's launches in its forwards of the lanes' scenes
    default_want = sum(n for s, n in zip(scenes, default_forward_launches)
                       if in_lanes(s))
    if len(default_forward_launches) != len(scenes) or \
            sum(default_forward_launches) != default_launches or \
            len(det_forward_launches) != len(lane_scenes) or \
            sum(det_forward_launches) != serial_launches or \
            serial_launches != default_want or \
            lanes_launches != serial_launches:
        raise AssertionError(f"roll launches: {default_launches} default "
                             f"({default_want} in the lanes' scenes), "
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
        "deterministic_scenes": len(lane_scenes),
        "deterministic_serial_s": serial_s,
        "deterministic_serial_forward_s": serial_clock.get("forward", 0.0),
        "lanes_scenes": len(lane_scenes), "deterministic_lanes_s": lanes_s,
        "deterministic_lanes_mixtures_per_s": stats["mixtures_per_sec"],
        "lane_utilization": stats["lane_utilization"],
        "roll_launches_serial": default_launches,
        "roll_launches_serial_deterministic": serial_launches,
        "roll_launches_lanes": lanes_launches, "peak_memory_gb": peak_gb,
    }
    oracle = _oracle_sisdri(pipe, scenes)
    out["oracle_sisdri_mean"] = oracle["mean"]
    out["oracle_sisdri"] = oracle["per_scene"]
    for label, summ in (("cuDNN default", summary),
                        (f"cuDNN deterministic, {len(lane_scenes)} scenes",
                         det_summary)):
        log(f"eval ({label}): P {summ['precision']:.4f} R "
            f"{summ['recall']:.4f} F1 {f1(summ):.4f} (tp {summ['tp']}, fp "
            f"{summ['fp']}, fn {summ['fn']}); SI-SDRi "
            f"{summ['sisdri_mean']:.3f} dB, SI-SDRi (mir) "
            f"{summ['sisdri_mir_mean']:.3f} dB; median localization error "
            f"{summ['loc_err_median']:.3f} m")
    log(f"eval: serial, cuDNN default {default_s:.2f}s = {default_s / n:.3f} "
        f"s/scene (setup {out['serial_setup_s']:.2f}s, forward "
        f"{out['serial_forward_s']:.2f}s in all); serial, cuDNN "
        f"deterministic over {len(lane_scenes)} scenes {serial_s:.2f}s = "
        f"{serial_s / len(lane_scenes):.3f} s/scene (forward "
        f"{out['deterministic_serial_forward_s']:.2f}s); lanes=2 over "
        f"the same scenes, cuDNN "
        f"deterministic {lanes_s:.2f}s = {stats['mixtures_per_sec']:.4f} "
        f"mixtures/s, lane utilization "
        f"{[round(u, 3) for u in stats['lane_utilization']]}; lanes results "
        f"equal to the deterministic serial ones apart from stage_times")
    log(f"eval: SI-SDRi at the true positions (SepNet on each scene's "
        f"metadata shifts, on the card) {oracle['mean']:.3f} dB over "
        f"{len(oracle['values'])} talkers, beside the pipeline's "
        f"{summary['sisdri_mean']:.3f} dB; per scene "
        f"{json.dumps(oracle['per_scene'])}")
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


def _oracle_sisdri(pipe, scenes) -> dict:
    """SI-SDRi of the pipeline's separation at each dev scene's true TDoAs
    (the `shifts` of its metadata.json) against mic00_voice*.wav, as the
    evaluation computes it: si_sdr(output) - si_sdr(mic 0's mixture)."""
    import numpy as np

    from acousticswarms_speech_tpu_torch.pipeline.evaluate import get_items
    from acousticswarms_speech_tpu_torch.utils.metrics import si_sdr

    per_scene, values = {}, []
    for scene in scenes:
        metadata, mix, gts = get_items(os.path.join(DEV_SET, scene))
        voices = [k for k in metadata if k.startswith("voice")]
        offs = [np.asarray(metadata[v]["shifts"], np.float64) for v in voices]
        est = pipe.sep_model.infer_sample(mix, offs)
        if est.shape != gts.shape or not np.isfinite(est).all():
            raise AssertionError(f"oracle separation of {scene}: {est.shape}")
        sisdri = [float(si_sdr(est[i], gts[i]) - si_sdr(mix[0], gts[i]))
                  for i in range(len(voices))]
        per_scene[scene] = [round(x, 3) for x in sisdri]
        values += sisdri
    return {"per_scene": per_scene, "values": values,
            "mean": float(np.mean(values))}


ROLL_KERNEL = "roll_channels_kernel"  # csrc/roll.cu's kernel, in the trace
PROFILE_DIR = os.path.join(OUT_DIR, "profile")


def _union_s(intervals) -> float:
    """Total length of the union of (start, end) intervals, in their unit."""
    total, cur = 0.0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return total + (cur[1] - cur[0] if cur is not None else 0.0)


def profile_phase(pipe, mix) -> dict:
    """One more forward of the bench scene with profile_dir: device busy
    time (the union of the kernels' intervals in the trace) and idle share
    over the forward's window (the first stage span's start to the last
    one's end, widened to the first and last kernel), the top device ops,
    each stage span's time; the trace's roll kernels must number the
    kernel counter's launches."""
    from acousticswarms_speech_tpu_torch.ops.roll_kernel import \
        roll_channels_batch_cuda
    from acousticswarms_speech_tpu_torch.pipeline.joint import STAGES

    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    with recording_rolls() as rolls:
        roll_channels_batch_cuda.launches = 0
        sync()
        t0 = time.time()
        patches, *_ = pipe.forward(mix, profile_dir=PROFILE_DIR)
        sync()
        wall = time.time() - t0
        launches = roll_channels_batch_cuda.launches
    traces = glob.glob(os.path.join(PROFILE_DIR, "*.pt.trace.json"))
    if len(traces) != 1 or not patches:
        raise AssertionError(f"profiled forward: traces {traces}, "
                             f"{len(patches)} heads")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    spans = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation" and e.get("name") in STAGES}
    if sorted(spans) != sorted(STAGES) or not kernels:
        raise AssertionError(f"trace: spans {sorted(spans)}, "
                             f"{len(kernels)} kernels")
    trace_rolls = sum(ROLL_KERNEL in e["name"] for e in kernels)
    if trace_rolls != launches or launches <= 0:
        raise AssertionError(f"trace holds {trace_rolls} roll kernels, the "
                             f"counter {launches}")
    hold_rolls(rolls, "profiled forward")
    starts = [e["ts"] for e in kernels] + [e["ts"] for e in spans.values()]
    ends = ([e["ts"] + e["dur"] for e in kernels]
            + [e["ts"] + e["dur"] for e in spans.values()])
    window_s = (max(ends) - min(starts)) / 1e6
    busy_s = _union_s((e["ts"], e["ts"] + e["dur"]) for e in kernels) / 1e6
    by_name: dict[str, list] = {}
    for e in kernels:
        by_name.setdefault(e["name"], []).append(e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]
    out = {
        "wall_s": wall, "trace_mb": os.path.getsize(traces[0]) / 1e6,
        "window_s": window_s, "device_busy_s": busy_s,
        "idle_share": 1.0 - busy_s / window_s, "kernels": len(kernels),
        "kernel_names": len(by_name), "roll_launches": launches,
        "trace_roll_kernels": trace_rolls,
        "stage_spans_s": {k: spans[k]["dur"] / 1e6 for k in STAGES},
        "top_device_ops": [{"name": name[:120], "count": len(d),
                            "total_s": sum(d) / 1e6} for name, d in top],
    }
    log(f"profile: forward with profile_dir {wall:.3f}s (trace "
        f"{out['trace_mb']:.1f} MB written at its end); in the trace the "
        f"forward spans {window_s:.3f}s, device busy {busy_s:.3f}s "
        f"(union of {len(kernels)} kernels of {len(by_name)} names), idle "
        f"share {out['idle_share']:.3f}; roll kernels {trace_rolls} in the "
        f"trace, {launches} by the counter; equal to plain")
    log(f"profile: stage spans (s) "
        f"{json.dumps({k: round(v, 4) for k, v in out['stage_spans_s'].items()})}")
    for r in out["top_device_ops"]:
        log(f"profile: top device op {r['total_s']:.4f}s in {r['count']} "
            f"launches: {r['name']}")
    return out


# bf16 against float32 and the CPU: the card's bfloat16 is held to the
# port's CPU bfloat16 code at most BF16_MARGIN_DB below the CPU bfloat16's
# own SI-SDR against the card's float32 (two bfloat16 results with their
# own roundings each lie that far from float32)
BF16_MARGIN_DB = 6.0


def _bf16_check(label, card16, cpu16, card32) -> dict:
    """Rows of the card's bfloat16 output against the CPU's bfloat16 and
    the card's float32 (numpy arrays): the card's bfloat16 within
    BF16_MARGIN_DB of the CPU bfloat16's own SI-SDR against float32."""
    import numpy as np

    from acousticswarms_speech_tpu_torch.utils.metrics import si_sdr

    def sisdr_rows(a, b):
        return [float(si_sdr(x, y)) for x, y in zip(a, b)]

    got = sisdr_rows(card16, cpu16)
    own = sisdr_rows(cpu16, card32)
    card_own = sisdr_rows(card16, card32)
    if not (np.isfinite(card16).all()
            and min(got) >= min(own) - BF16_MARGIN_DB):
        raise AssertionError(f"{label}: card bf16 vs CPU bf16 SI-SDR "
                             f"{got}, CPU bf16 vs card f32 {own}")
    log(f"bf16 {label}: card vs CPU bf16 SI-SDR min {min(got):.2f} dB "
        f"(bound {min(own) - BF16_MARGIN_DB:.2f}); against the card's "
        f"f32: CPU bf16 min {min(own):.2f} dB, card bf16 min "
        f"{min(card_own):.2f} dB; max abs err card vs CPU bf16 "
        f"{float(np.abs(card16 - cpu16).max()):.3e} (peak "
        f"{float(np.abs(cpu16).max()):.4f})")
    return {"card_vs_cpu_min_db": min(got), "cpu_bf16_vs_f32_min_db":
            min(own), "card_bf16_vs_f32_min_db": min(card_own)}


def _bf16_nets_check(pipe, pipe16, mix, fine_mix, fine_shifts, heads):
    """(a): SpotNet on 8 candidates of the fine sweep's rolled inputs and
    SepNet at the bench scene's heads, in bfloat16 on the card and on the
    CPU, against the card's float32."""
    import torch

    from acousticswarms_speech_tpu_torch.models import load_release
    from acousticswarms_speech_tpu_torch.models.common import normalize_input
    from acousticswarms_speech_tpu_torch.ops.shift import \
        roll_channels_batch_plain
    from acousticswarms_speech_tpu_torch.search.spotform import \
        SeparationInference

    out = {}
    x = torch.as_tensor(fine_mix, device=DEVICE)
    s = torch.as_tensor(fine_shifts[:8], device=DEVICE)
    normed, _, _ = normalize_input(roll_channels_batch_plain(x, s))
    w = torch.tensor([[1.0, 0.0]]).expand(8, 2)
    spot_cpu = load_release(SPOT_DIR, "cpu", torch.bfloat16)
    with torch.no_grad():
        card16 = pipe16.spot_model.model(normed.bfloat16(),
                                         w.to(DEVICE).bfloat16())
        card32 = pipe.spot_model.model(normed, w.to(DEVICE))
        cpu16 = spot_cpu(normed.cpu().bfloat16(), w.bfloat16())
    del spot_cpu
    out["spotnet"] = _bf16_check(f"SpotNet (B=8, T={fine_mix.shape[1]})",
                                 card16.float().cpu().numpy()[:, 0],
                                 cpu16.float().numpy()[:, 0],
                                 card32.cpu().numpy()[:, 0])
    offs = [p[0].sample_offset for p in heads]
    cpu_sep = SeparationInference(load_release(SEP_DIR, "cpu"), use_bf16=True,
                                  device="cpu")
    out["sepnet"] = _bf16_check(
        f"SepNet ({len(offs)} heads, T={mix.shape[1]})",
        pipe16.sep_model.infer_sample(mix, offs),
        cpu_sep.infer_sample(mix, offs), pipe.sep_model.infer_sample(mix, offs))
    return out


def bf16_phase(pipe, mix, fine_mix, fine_shifts, f32_out) -> dict:
    """(a) the networks in bfloat16, card against the CPU; (b) the forward
    of the bench scene with use_bf16=True, warm-up then timed, beside the
    float32 forward's heads and audio."""
    import numpy as np

    from acousticswarms_speech_tpu_torch.ops.roll_kernel import \
        roll_channels_batch_cuda
    from acousticswarms_speech_tpu_torch.pipeline.joint import JointPipeline
    from acousticswarms_speech_tpu_torch.utils.metrics import si_sdr

    heads32, audio32 = f32_out
    pipe16 = JointPipeline(pipe.spot_model.model, pipe.sep_model.model,
                           device=DEVICE, use_bf16=True)
    out = {"nets": _bf16_nets_check(pipe, pipe16, mix, fine_mix, fine_shifts,
                                    heads32)}
    pipe16.setup(MIC_POS, ROI, cache_dir=CACHE_DIR)
    t0 = time.time()
    pipe16.forward(mix)
    sync()
    warm = time.time() - t0
    with recording_rolls() as rolls:
        roll_channels_batch_cuda.launches = 0
        pipe16.spot_model.calls = 0
        sync()
        t0 = time.time()
        patches, audio_loc, audio, *_ = pipe16.forward(mix)
        sync()
        wall = time.time() - t0
        launches = roll_channels_batch_cuda.launches
    audio = np.asarray(audio)
    if not patches or audio.shape != (len(patches), mix.shape[1]) or not \
            np.isfinite(audio).all() or launches <= 0:
        raise AssertionError(f"bf16 forward: {len(patches)} heads, audio "
                             f"{audio.shape}, {launches} roll launches")
    hold_rolls(rolls, "bf16 forward")
    pos32 = np.array([p[0].center_pos()[:2] for p in heads32])
    matched = []
    for k, p in enumerate(patches):
        d = np.linalg.norm(pos32 - np.asarray(p[0].center_pos()[:2]), axis=1)
        j = int(d.argmin())
        matched.append({"head": k, "f32_head": j, "distance_m": float(d[j]),
                        "audio_sisdr_db": float(si_sdr(audio[k],
                                                       audio32[j]))})
    out.update({"warmup_s": warm, "wall_s": wall, "roll_launches": launches,
                "heads": len(patches), "f32_heads": len(heads32),
                "matched": matched, **pipe16.stage_metrics()})
    log(f"bf16 forward: warm-up {warm:.2f}s, timed {wall:.3f}s; stage_metrics "
        f"{json.dumps(pipe16.stage_metrics())}; roll kernel launches "
        f"{launches}, equal to plain")
    log(f"bf16 forward: {len(patches)} heads beside {len(heads32)} in "
        f"float32; matched (bf16 head, f32 head, distance m, SI-SDR of bf16 "
        f"audio against f32 dB): "
        + "; ".join(f"({m['head']}, {m['f32_head']}, {m['distance_m']:.3f}, "
                    f"{m['audio_sisdr_db']:.2f})" for m in matched))
    return out


# The bench at a cut depth: 3 timed forwards (default 7), 2 lanes over 4
# mixtures (default 7).
BENCH_ENV = {"BENCH_REPEATS": "3", "BENCH_LANES": "2",
             "BENCH_THROUGHPUT_ITEMS": "4", "BENCH_BF16": "1"}
BENCH_TIMEOUT_S = 300


def bench_phase(bf16: dict) -> dict:
    """scripts/bench as a child process, as users and the evaluation suite
    run it, in bfloat16 (BENCH_ENV).  Its last stdout line must parse, hold
    no error, give the latency rate (1 / the median forward) as `value`,
    the throughput of two lanes and 5-entry stage lists, show no kernel
    built (the build phase built it) and roll kernel launches in every
    timed forward.  Its heads and spot calls are logged beside the bf16
    phase's (cuDNN's default algorithms may break a near-tie otherwise)."""
    import torch

    torch.cuda.empty_cache()
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "bench.log")
    t0 = time.time()
    with open(path, "w") as err:
        proc = subprocess.run(
            [sys.executable, "-m", "acousticswarms_speech_tpu_torch.scripts.bench"],
            cwd=REPO, env=dict(os.environ, **BENCH_ENV), stdout=subprocess.PIPE,
            stderr=err, text=True, timeout=BENCH_TIMEOUT_S,
            stdin=subprocess.DEVNULL)
    wall = time.time() - t0
    with open(path) as f:
        for ln in f.read().splitlines():
            if ln.startswith("[bench]"):
                print(f"  | {ln}", flush=True)
    out = proc.stdout.strip().splitlines()
    try:
        line = json.loads(out[-1])
    except (IndexError, ValueError):
        line = {}
    faults = [] if proc.returncode == 0 else [f"exit code {proc.returncode}"]
    times = line.get("forward_s") or [math.nan]
    latency = round(1.0 / statistics.median(times), 4)
    checks = {
        "a JSON last line": bool(line),
        "no error": "error" not in line,
        "value = 1 / median forward": line.get("value") == latency
        == line.get("latency_mixtures_per_sec"),
        "3 timed forwards": len(times) == 3,
        "throughput of 2 lanes": math.isfinite(
            line.get("throughput_mixtures_per_sec") or math.nan)
        and line.get("throughput_lanes") == 2
        and len(line.get("lane_utilization", [])) == 2,
        "5 stage medians and IQRs": all(
            len(line.get(k, [])) == 5 and _finite_numbers(line[k])
            for k in ("stage_median_s", "stage_iqr_s")),
        "no kernel built": line.get("compile_cache", {}).get(
            "entries_added") == 0,
        "roll launches in every timed forward": len(
            line.get("roll_launches_per_forward", [])) == 3
        and min(line["roll_launches_per_forward"]) > 0,
        "bf16 and TF32 off": (line.get("use_bf16"), line.get("tf32"))
        == (True, False),
        "the card's name and power limit": bool(
            line.get("device", {}).get("name"))
        and (line["device"].get("power_limit_w") or 0) > 0,
    }
    faults += [k for k, ok in checks.items() if not ok]
    if faults:
        print("\n".join(out[-5:]), flush=True)
        raise AssertionError(f"bench: {faults}")
    log(f"bench line: {json.dumps(line)}")
    log(f"bench: exit 0 in {wall:.2f}s; latency {line['value']} mixtures/s "
        f"(forwards {[round(t, 3) for t in times]} s), throughput "
        f"{line['throughput_mixtures_per_sec']} mixtures/s over 2 lanes "
        f"(util {line['lane_utilization']}); stage medians "
        f"{line['stage_median_s']}; roll kernel launches per forward "
        f"{line['roll_launches_per_forward']}; heads {line['clusters']} and "
        f"spot calls {line['spot_calls']} beside the bf16 phase's "
        f"{bf16['heads']} and {bf16['spotform_calls']}")
    return {"wall_s": wall, "line": line,
            "roll_launches": sum(line["roll_launches_per_forward"])}


def _same_geometry(a, b) -> bool:
    import numpy as np

    va, vb = vars(a), vars(b)
    return sorted(va) == sorted(vb) and all(
        np.array_equal(np.asarray(va[k]), np.asarray(vb[k])) for k in va)


def bf16_eval_phase(evaluation: dict) -> dict:
    """(c) evaluate_dataset over the dev scenes in bfloat16, serially,
    reading the geometry caches that scripts/precompute_geometry.py wrote
    into a copy of the dev set (each checked first against a fresh
    build), beside the float32 pass's figures."""
    from acousticswarms_speech_tpu_torch.dsp.geometry import build_geometry
    from acousticswarms_speech_tpu_torch.ops.roll_kernel import \
        roll_channels_batch_cuda
    from acousticswarms_speech_tpu_torch.pipeline.analyze import analyze
    from acousticswarms_speech_tpu_torch.pipeline.evaluate import (
        evaluate_dataset, preprocess_metadata)
    from acousticswarms_speech_tpu_torch.pipeline.joint import JointPipeline
    from acousticswarms_speech_tpu_torch.scripts.precompute_geometry import \
        precompute

    data = os.path.join(OUT_DIR, "devdata_bf16")
    folder = os.path.join(OUT_DIR, "eval_serial_bf16")
    for d in (data, folder):
        shutil.rmtree(d, ignore_errors=True)
    dev = sorted(d for d in os.listdir(DEV_SET)
                 if os.path.isdir(os.path.join(DEV_SET, d)))
    for scene in dev[::2]:  # every other scene, 8 of the 16
        shutil.copytree(os.path.join(DEV_SET, scene), os.path.join(data, scene))
    t0 = time.time()
    scenes = precompute(data)
    precompute_s = time.time() - t0
    t0 = time.time()
    for scene in scenes:
        with open(os.path.join(scene, "metadata.json")) as f:
            _, mics, _, _, _, roi = preprocess_metadata(json.load(f))
        caches = glob.glob(os.path.join(scene, "tdoa_geometry_*.npz"))
        if len(caches) != 1 or not _same_geometry(
                build_geometry(mics, roi, cache_dir=scene),
                build_geometry(mics, roi)):
            raise AssertionError(f"geometry cache of {scene}: {caches}")
    check_s = time.time() - t0
    log(f"eval bf16: precompute_geometry wrote {len(scenes)} caches in "
        f"{precompute_s:.2f}s; each equals a fresh build ({check_s:.2f}s)")

    pipe = JointPipeline.from_experiments(SPOT_DIR, SEP_DIR, device=DEVICE,
                                          use_bf16=True)
    clock = _StageClock()
    real_setup = clock.wrap(JointPipeline, "setup")
    real_forward = clock.wrap(JointPipeline, "forward")
    try:
        with recording_rolls() as rolls:
            roll_channels_batch_cuda.launches = 0
            sync()
            t0 = time.time()
            counts = evaluate_dataset(pipe, data, results_folder=folder,
                                      cache_geometry=True)
            sync()
            wall = time.time() - t0
            launches = roll_channels_batch_cuda.launches
    finally:
        JointPipeline.setup = real_setup
        JointPipeline.forward = real_forward
    results = _read_results(folder)
    if len(results) != len(scenes) or launches != len(rolls) or \
            launches <= 0 or not all(map(_finite_numbers, results.values())):
        raise AssertionError(f"bf16 eval: {len(results)} results, "
                             f"{launches} launches for {len(rolls)} rolls")
    hold_rolls(rolls, "bf16 evaluation")
    summ = analyze(folder, verbose=False)
    if summ["tp"] <= 0 or not _finite_numbers(summ):
        raise AssertionError(f"analyze of the bf16 run: {summ}")
    p, r = summ["precision"], summ["recall"]
    n = len(scenes)
    out = {"scenes": n, "counts": counts, "precision": p, "recall": r,
           "f1": 2 * p * r / (p + r) if p + r > 0 else 0.0,
           **{k: summ[k] for k in ("tp", "fp", "fn", "sisdri_mean",
                                   "sisdri_mir_mean", "loc_err_median")},
           "serial_s": wall, "s_per_scene": wall / n,
           "setup_s": clock.seconds.get("setup", 0.0),
           "forward_s": clock.seconds.get("forward", 0.0),
           "precompute_s": precompute_s, "roll_launches": launches}
    f32 = evaluation
    log(f"eval bf16 (cached geometry): P {p:.4f} R {r:.4f} F1 "
        f"{out['f1']:.4f} (tp {summ['tp']}, fp {summ['fp']}, fn "
        f"{summ['fn']}); SI-SDRi {summ['sisdri_mean']:.3f} dB (mir "
        f"{summ['sisdri_mir_mean']:.3f}); {wall / n:.3f} s/scene, setup "
        f"{out['setup_s']:.2f}s, forward {out['forward_s']:.2f}s in all; "
        f"roll kernel launches {launches}, equal to plain")
    log(f"eval f32 (geometry built per scene, same run): P "
        f"{f32['precision']:.4f} R {f32['recall']:.4f} F1 {f32['f1']:.4f}; "
        f"SI-SDRi {f32['sisdri_mean']:.3f} dB (mir "
        f"{f32['sisdri_mir_mean']:.3f}); {f32['serial_s_per_scene']:.3f} "
        f"s/scene, setup {f32['serial_setup_s']:.2f}s, forward "
        f"{f32['serial_forward_s']:.2f}s in all")
    return out


# The retune phase's traced pass: 4 of the 16 dev scenes, those of the
# evaluation phase's deterministic passes.
RETUNE_SCENES = ["00000", "00004", "00008", "00012"]
# Result fields exempt when the traced pass is held equal to the untraced
# deterministic pass: the stage times (host clock).  Tracing adds no field
# to result_*.json; its records go to trace_*.json beside them.
TRACE_EXEMPT = ("stage_times",)
# What each table of the re-tune loop prints, after its "=== title ===".
RETUNE_TABLES = {
    "analyze": "precision = ",
    "NMS probe": "NMS totals: in ",
    "retention root-cause (sub-patch aware)": "retention (big-patch",
    "threshold tuner": "=== SPOT_POWER_THRESHOLD2 (fine)",
    "NMS merge-threshold replay": "pair coverage",
    "labeled TDoA-deviation stats": "GT-labeled",
    "TDoA gate sweep": "gate sweep at sisdr_thr=",
    "elect A/B": "elect A/B at sisdr_thr=",
    "frozen defaults now in effect (probe provenance)":
        "NMS_SISDR_THRESHOLD = ",
}
CHILD_TIMEOUT_S = 300


def _traced_pass(evaluation: dict) -> dict:
    """(a) evaluate_dataset with power tracing, float32, deterministic
    cuDNN, over RETUNE_SCENES: results equal to the evaluation phase's
    deterministic serial pass, an nms_summary with pair_sisdr in every
    trace of a scene that reached the NMS, and replay_nms at the run's own
    settings giving each scene its live head count."""
    import collections

    import torch

    from acousticswarms_speech_tpu_torch.ops.roll_kernel import \
        roll_channels_batch_cuda
    from acousticswarms_speech_tpu_torch.pipeline.evaluate import \
        evaluate_dataset
    from acousticswarms_speech_tpu_torch.pipeline.joint import JointPipeline
    from acousticswarms_speech_tpu_torch.scripts import replay_nms
    from acousticswarms_speech_tpu_torch.search import power_trace

    folder = os.path.join(OUT_DIR, "retune_traced")
    untraced = os.path.join(OUT_DIR, "eval_serial")
    shutil.rmtree(folder, ignore_errors=True)
    t0 = time.time()
    pipe = JointPipeline.from_experiments(SPOT_DIR, SEP_DIR, device=DEVICE)
    load_s = time.time() - t0
    was = power_trace.ENABLED
    power_trace.drain()
    torch.backends.cudnn.deterministic = True
    power_trace.ENABLED = True
    try:
        with recording_rolls() as rolls:
            roll_channels_batch_cuda.launches = 0
            sync()
            t0 = time.time()
            evaluate_dataset(pipe, DEV_SET, results_folder=folder,
                             sample_filter=set(RETUNE_SCENES).__contains__)
            sync()
            wall = time.time() - t0
            launches = roll_channels_batch_cuda.launches
    finally:
        power_trace.ENABLED = was
        power_trace.drain()
        torch.backends.cudnn.deterministic = False
    del pipe
    if launches != len(rolls) or launches <= 0:
        raise AssertionError(f"traced eval: {launches} roll launches for "
                             f"{len(rolls)} rolls")
    hold_rolls(rolls, "traced evaluation")
    del rolls

    diffs, stage_s = [], {"traced": 0.0, "untraced": 0.0}
    stages, reached, heads = collections.Counter(), [], {}
    for scene in RETUNE_SCENES:
        name = f"result_{scene}.json"
        with open(os.path.join(folder, name)) as f:
            got = json.load(f)
        with open(os.path.join(untraced, name)) as f:
            want = json.load(f)
        stage_s["traced"] += sum(got["stage_times"])
        stage_s["untraced"] += sum(want["stage_times"])
        for k in TRACE_EXEMPT:
            got.pop(k)
            want.pop(k)
        diffs += [f"{name} {d}" for d in _json_diff(want, got)]
        heads[scene] = len(got["pred"]) + len(got["false_positive"])
        with open(os.path.join(folder, f"trace_{scene}.json")) as f:
            recs = json.load(f)["records"]
        stages.update(r["stage"] for r in recs)
        if any(r["stage"] == "fine_clusters" and r["n_clusters"] > 0
               for r in recs):
            reached.append(scene)
            if not any(r["stage"] == "nms_summary"
                       and r.get("pair_sisdr") is not None for r in recs):
                raise AssertionError(f"trace_{scene}.json: the scene reached "
                                     f"the NMS, no nms_summary with "
                                     f"pair_sisdr")
    if diffs:
        for d in diffs[:40]:
            log(f"retune: traced differs from untraced: {d}")
        raise AssertionError(f"{len(diffs)} values of the traced results "
                             f"differ from the untraced deterministic ones")

    with open(os.path.join(folder, "config.json")) as f:
        settings = replay_nms.live_settings(json.load(f))
    replayed = {}
    for fp, _, summary, pairs in replay_nms.load_scenes(folder):
        scene = os.path.basename(fp)[len("trace_"):-len(".json")]
        n, _, _, tested, missing, _ = replay_nms.replay(summary, pairs,
                                                        **settings)
        replayed[scene] = {"live": heads[scene], "replayed": n,
                           "pairs_tested": tested, "pairs_untested": missing}
        # Exact when every windowed test comes from the live pass; a pair it
        # did not test counts as not similar, so the replay can only keep
        # more heads than the live pass did (a bound).
        if (missing == 0 and n != heads[scene]) or n < heads[scene]:
            raise AssertionError(f"replay of {scene}: {replayed[scene]}")
        if missing:
            log(f"retune: replay of {scene} is a bound, not exact: {missing} "
                f"windowed pairs the live pass did not test; {n} heads >= "
                f"{heads[scene]} live")
    if sorted(replayed) != reached:
        raise AssertionError(f"replayable scenes {sorted(replayed)}, scenes "
                             f"that reached the NMS {reached}")
    n = len(RETUNE_SCENES)
    det_per_scene = (evaluation["deterministic_serial_s"]
                     / evaluation["deterministic_scenes"])
    out = {"scenes": n, "from_experiments_s": load_s, "wall_s": wall,
           "s_per_scene": wall / n,
           "untraced_deterministic_s_per_scene": det_per_scene,
           "stage_s_traced": stage_s["traced"],
           "stage_s_untraced": stage_s["untraced"],
           "roll_launches": launches, "records_by_stage": dict(stages),
           "replay": replayed}
    log(f"retune (a): traced evaluation of {n} dev scenes in {wall:.2f}s = "
        f"{wall / n:.3f} s/scene (untraced deterministic pass "
        f"{det_per_scene:.3f} s/scene over its "
        f"{evaluation['deterministic_scenes']} scenes); stage times of "
        f"these scenes {stage_s['traced']:.3f}s traced, "
        f"{stage_s['untraced']:.3f}s untraced; results equal to the "
        f"untraced deterministic pass apart from {list(TRACE_EXEMPT)}; roll "
        f"kernel launches {launches}, equal to plain")
    log(f"retune (a): records by stage {json.dumps(dict(sorted(stages.items())))}")
    log(f"retune (a): replay_nms at the live settings {json.dumps(settings)}: "
        f"{json.dumps(replayed)}")
    return out


def _start_child(args: list[str], log_name: str):
    path = os.path.join(OUT_DIR, log_name)
    f = open(path, "w")
    proc = subprocess.Popen([sys.executable, "-m", *args], cwd=REPO,
                            stdout=f, stderr=subprocess.STDOUT,
                            stdin=subprocess.DEVNULL)
    return proc, f, path


def _wait_children(children) -> list[tuple[int, str, float]]:
    """(exit code, output, seconds) of each started child; a child that
    outlasts CHILD_TIMEOUT_S is killed."""
    t0 = time.time()
    out = []
    try:
        for proc, f, path in children:
            try:
                code = proc.wait(timeout=max(1.0, CHILD_TIMEOUT_S
                                             - (time.time() - t0)))
            except subprocess.TimeoutExpired:
                proc.kill()
                code = proc.wait()
            f.close()
            with open(path) as fh:
                out.append((code, fh.read(), time.time() - t0))
    finally:
        for proc, f, _ in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            f.close()
    return out


def _check_retune_loop(code: int, text: str) -> list[str]:
    """The loop's exit code and, after each step's title, its table."""
    faults = [] if code == 0 else [f"exit code {code}"]
    for title, marker in RETUNE_TABLES.items():
        head = f"=== {title} ==="
        at = text.find(head)
        if at < 0 or text.find(marker, at) < 0:
            faults.append(f"no '{marker}' after '{head}'")
    return faults


def retune_phase(evaluation: dict) -> dict:
    """(a) the traced pass; (b) the re-tune loop (scripts/retune_release)
    and (d) the evaluation suite (scripts/run_eval_suite) as child
    processes in bfloat16 on one scene of the bf16 phase's dev copy with
    geometry caches, both started together; (c) the separation batch probe
    at full width, batch sizes 1, 2 and 4."""
    import torch

    from acousticswarms_speech_tpu_torch.scripts import probe_sep_batch

    traced = _traced_pass(evaluation)
    torch.cuda.empty_cache()

    data = os.path.join(OUT_DIR, "devdata_bf16")
    loop_dir = os.path.join(OUT_DIR, "retune_loop")
    suite_dir = os.path.join(OUT_DIR, "eval_suite")
    shutil.rmtree(suite_dir, ignore_errors=True)
    pkg = "acousticswarms_speech_tpu_torch.scripts"
    children = [
        _start_child([f"{pkg}.retune_release", loop_dir, "--dataset", data,
                      "--num_shards", "16", "--shard_index", "0"],
                     "retune_loop.log"),
        _start_child([f"{pkg}.run_eval_suite", "--dataset", data,
                      "--results_folder", suite_dir, "--num_shards", "16",
                      "--shard_index", "0", "--skip_bench"],
                     "eval_suite.log"),
    ]
    (loop_code, loop_out, loop_s), (suite_code, suite_out, suite_s) = \
        _wait_children(children)
    faults = _check_retune_loop(loop_code, loop_out)
    tables = loop_out[loop_out.find("=== analyze ==="):]
    for line in tables.splitlines():
        print(f"  | {line}", flush=True)
    if faults:
        print(loop_out[-4000:], flush=True)
        raise AssertionError(f"retune_release: {faults}")
    log(f"retune (b): retune_release on dev scene 00000 (bf16, cached "
        f"geometry) exit 0 in {loop_s:.2f}s, every table printed")
    suite_results = sorted(glob.glob(os.path.join(suite_dir, "result_*.json")))
    if suite_code != 0 or [os.path.basename(p) for p in suite_results] != \
            ["result_00000.json"] or "precision = " not in suite_out:
        print(suite_out[-4000:], flush=True)
        raise AssertionError(f"run_eval_suite: exit code {suite_code}, "
                             f"results {suite_results}")
    log(f"retune (d): run_eval_suite on dev scene 00000 exit 0 in "
        f"{suite_s:.2f}s (started with (b))")

    t0 = time.time()
    rows, probe_launches = counted(
        "probe_sep_batch", probe_sep_batch.probe, [1, 2, 4], SEP_DIR, DEVICE)
    probe_s = time.time() - t0
    for r in rows:
        if r["failed"] or not (math.isfinite(r["step_s"] or math.nan)
                               and math.isfinite(r["peak_gb"] or math.nan)):
            raise AssertionError(f"probe_sep_batch: {r}")
    log(f"retune (c): probe_sep_batch at full width in {probe_s:.2f}s: "
        + "; ".join(f"B={r['batch']} step {r['step_s']:.4f}s "
                    f"({r['step_s_per_sample']:.4f}s/sample), first "
                    f"{r['first_step_s']:.3f}s, peak {r['peak_gb']:.2f} GB"
                    for r in rows))
    return {"traced": traced, "loop_s": loop_s, "suite_s": suite_s,
            "probe": rows, "probe_s": probe_s,
            "probe_roll_launches": probe_launches}


def tools_phase() -> dict:
    """The release life cycle on the trained experiments of the training
    phase: export_release, read back through JointPipeline.from_release
    (the float16 rounding of the trained parameters), then
    seed_checkpoint_from_release into a fresh experiment from which
    train() resumes for one step."""
    import torch

    from acousticswarms_speech_tpu_torch.pipeline.joint import JointPipeline
    from acousticswarms_speech_tpu_torch.scripts import (
        export_release, seed_checkpoint_from_release)
    from acousticswarms_speech_tpu_torch.training import checkpoints, train

    exps = [os.path.join(OUT_DIR, "train_" + os.path.basename(d))
            for d in (SPOT_DIR, SEP_DIR)]
    t0 = time.time()
    for exp in exps:
        export_release.export(exp, DEVICE)
    pipe = JointPipeline.from_release(*exps, device=DEVICE)
    for exp, model in zip(exps, (pipe.spot_model.model, pipe.sep_model.model)):
        name = os.path.basename(exp)
        want = checkpoints.load_params(os.path.join(
            exp, "checkpoints", f"{name}_0.msgpack"))
        got = model.state_dict()
        if sorted(got) != sorted(want) or not all(
                torch.equal(got[k].cpu(), v.half().float())
                for k, v in want.items()):
            raise AssertionError(f"{name}: release != float16 of trained")
    del pipe
    export_s = time.time() - t0

    src = exps[0]
    seeded = os.path.join(OUT_DIR, "seeded_" + os.path.basename(SPOT_DIR))
    shutil.rmtree(seeded, ignore_errors=True)
    os.makedirs(os.path.join(seeded, "release"))
    shutil.copy(os.path.join(src, "release", "params_f16.msgpack"),
                os.path.join(seeded, "release"))
    with open(os.path.join(src, "description.json")) as f:
        desc = json.load(f)
    desc["training_params"]["epochs"] = 2
    with open(os.path.join(seeded, "description.json"), "w") as f:
        json.dump(desc, f)
    t0 = time.time()
    ckpt = seed_checkpoint_from_release.seed(seeded, 0, DEVICE)
    loaded, steps = [], []
    real_load = checkpoints.load_params

    def recording_load(path):
        loaded.append(os.path.relpath(path, seeded))
        return real_load(path)

    checkpoints.load_params = recording_load
    try:
        train.train(seeded, max_steps_per_epoch=1, device=DEVICE,
                    on_step=lambda model, info: steps.append(info))
    finally:
        checkpoints.load_params = real_load
    name = os.path.basename(seeded)
    want_ckpt = os.path.join("checkpoints", f"{name}_0.msgpack")
    if (ckpt is None or loaded[:1] != [want_ckpt] or len(steps) != 1
            or not os.path.exists(os.path.join(
                seeded, "checkpoints", f"{name}_1.msgpack"))):
        raise AssertionError(f"seeded resume: loaded {loaded}, steps {steps}")
    out = {"export_s": export_s, "seed_and_resume_s": time.time() - t0,
           "resumed_from": loaded[0], "resume_loss": steps[0]["loss"]}
    log(f"tools: export_release of both trained experiments, read back "
        f"through JointPipeline.from_release equal to the float16 of the "
        f"trained parameters ({export_s:.2f}s); seed_checkpoint_from_release "
        f"then train() resumed from {loaded[0]} for one step (loss "
        f"{steps[0]['loss']:.4f}) into epoch 1 ({out['seed_and_resume_s']:.2f}s)")
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


# Dataset generation on the card against the CPU: two scenes of 7 mics,
# 3 talkers and 3 s, one at max_order 10 and one with --sample_rt60.
GEN_SCENES = [("order10", 1, {}), ("rt60", 2, {"sample_rt60": True})]
RIR_TOL = 1e-6  # of the premix's peak: float32 sinc taps summed in float64
SRP_TOL = 1e-5  # of the SRP map's peak: float32 sums in other orders
MAP_TOL = 1e-8  # of a MUSIC/TOPS map's peak: complex128


def _pcm(path: str):
    import wave

    import numpy as np

    with wave.open(path) as w:
        return np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)


def _generate(voices, root, label, seed, extra, device):
    """generate_sample of scene `label` on `device`; (seconds, premix)."""
    import argparse

    import numpy as np

    from acousticswarms_speech_tpu_torch.data import generate_dataset, roomsim

    premixes = []
    real = roomsim.ShoeBox.simulate

    def recording(self, *args, **kwargs):
        premixes.append(real(self, *args, **kwargs))
        return premixes[-1]

    args = argparse.Namespace(
        output_path=os.path.join(root, str(device)), n_mics=7,
        n_voices_min=3, n_voices_max=3, sr=48000, duration=3.0, dimensions=3,
        max_order=10, max_order_cap=150, sample_rt60=False,
        generate_colocated=False, device=device)
    vars(args).update(extra)
    roomsim.ShoeBox.simulate = recording
    try:
        t0 = time.time()
        generate_dataset.generate_sample(voices, args, label, 0,
                                         np.random.RandomState(seed))
        sec = time.time() - t0
    finally:
        roomsim.ShoeBox.simulate = real
    if len(premixes) != 1:
        raise AssertionError(f"{label}: {len(premixes)} renders")
    return sec, premixes[0]


def _render_on_both(voices, root, label, seed, extra) -> dict:
    """Scene `label` rendered with the room on the card and again on the
    CPU: premix within RIR_TOL of its peak, metadata.json equal, one WAV
    per mic and talker, WAVs within 1 LSB."""
    import numpy as np

    from acousticswarms_speech_tpu_torch.data import roomsim

    card_s, card = _generate(voices, root, label, seed, extra, DEVICE)
    cpu_s, cpu = _generate(voices, root, label, seed, extra, "cpu")
    if card.shape != cpu.shape or not np.isfinite(card).all():
        raise AssertionError(f"{label}: premix {card.shape} vs {cpu.shape}")
    err = float(np.abs(card - cpu).max())
    peak = float(np.abs(cpu).max())
    if not err <= RIR_TOL * peak:
        raise AssertionError(f"{label}: premix card vs CPU {err} "
                             f"(peak {peak})")
    dirs = [os.path.join(root, d, label, "00000") for d in (DEVICE, "cpu")]
    metas = []
    for d in dirs:
        with open(os.path.join(d, "metadata.json")) as f:
            metas.append(json.load(f))
    if metas[0] != metas[1]:
        raise AssertionError(f"{label}: metadata.json differs")
    meta = metas[1]
    mics = sum(k.startswith("mic") for k in meta)
    talkers = sum(k.startswith("voice") for k in meta)
    wavs = sorted(f for f in os.listdir(dirs[1]) if f.endswith(".wav"))
    if mics != extra.get("n_mics", 7) or len(wavs) != mics + talkers:
        raise AssertionError(f"{label}: {mics} mics, {wavs}")
    lsb = max(int(np.abs(_pcm(os.path.join(dirs[0], w)).astype(np.int32)
                         - _pcm(os.path.join(dirs[1], w))).max())
              for w in wavs)
    if lsb > 1:
        raise AssertionError(f"{label}: WAVs differ by {lsb} LSB")
    order = (roomsim.inverse_sabine(meta["rt60"], meta["Room_dimensions"])
             [1] if "rt60" in meta else 10)
    out = {"card_s": card_s, "cpu_s": cpu_s, "premix_max_abs_err": err,
           "premix_peak": peak, "wav_max_lsb": lsb,
           "premix_shape": list(card.shape), "max_order": min(order, 150),
           "rt60": meta.get("rt60"), "absorption": meta["absorption"]}
    log(f"generation {label}: {mics} mics, {talkers} talkers, "
        f"{out['max_order']} reflections max (rt60 {meta.get('rt60')}, "
        f"absorption {meta['absorption']:.3f}); card {card_s:.3f}s, CPU "
        f"{cpu_s:.3f}s per scene; premix {tuple(card.shape)} card vs CPU max "
        f"abs err {err:.3e} (peak {peak:.4f}); metadata.json equal; WAVs "
        f"within {lsb} LSB")
    return out


def generation_phase() -> dict:
    """A seeded voice bank, then each scene of GEN_SCENES rendered with the
    room on the card and again on the CPU: premix, metadata.json and WAVs
    compared."""
    from acousticswarms_speech_tpu_torch.data import voicegen

    root = os.path.join(OUT_DIR, "generation")
    shutil.rmtree(root, ignore_errors=True)
    bank = os.path.join(root, "voices")
    t0 = time.time()
    voicegen.generate_voice_bank(bank, n_speakers=6, clips_per_speaker=2,
                                 duration=3.0, seed=0)
    log(f"generation: voice bank (6 speakers x 2 utterances of 3 s) in "
        f"{time.time() - t0:.2f}s")
    voices = [os.path.join(bank, d) for d in sorted(os.listdir(bank))]
    return {label: _render_on_both(voices, root, label, seed, extra)
            for label, seed, extra in GEN_SCENES}


def _threshold_margin(engine, offsets) -> float:
    """How far the SRP map value of the cluster nearest to a candidate's
    TDoA offsets lies from the two peak-detection thresholds of
    SrpEngine.find_valid_peaks at that cluster's cells."""
    import numpy as np

    geom = engine.geom
    c = int(np.abs(geom.cluster_offsets - np.asarray(offsets)).max(1).argmin())
    t0, t_lo, t_hi = engine.threshold
    t = float(np.clip(t0 * engine.max_power, t_lo, t_hi))
    v = float(engine.srp_map[c])
    margins = [abs(v - t * (0.9 + 1 / geom.dis_matrix[ix, iy])) for ix, iy, _
               in np.argwhere(geom.cluster_index == c)]
    margins += [abs(v - 4 * t * (1 + 1 / geom.dis_matrix[ix, iy])) for ix, iy, _
                in np.argwhere(geom.cluster_index == c)]
    return min(margins) if margins else float("inf")


def _mine(scene_dir, device) -> dict:
    from acousticswarms_speech_tpu_torch.data import generate_srp_sample
    from acousticswarms_speech_tpu_torch.search.srp_pruning import SrpEngine

    engines = []
    real = SrpEngine.compute_map

    def recording(self, *args, **kwargs):
        engines.append(self)
        return real(self, *args, **kwargs)

    SrpEngine.compute_map = recording
    try:
        t0 = time.time()
        neg, pos = generate_srp_sample.mine_sample(scene_dir, device=device)
        sync()
        sec = time.time() - t0
    finally:
        SrpEngine.compute_map = real
    return {"neg": neg, "pos": pos, "engine": engines[-1], "s": sec}


def mining_phase() -> dict:
    """The 16 dev scenes copied and mined on the card, two of them again on
    the CPU (in a copy of their own: mining writes challeng_sample.json
    into the scene directory): SRP maps and candidate labels compared."""
    import numpy as np

    scenes = sorted(d for d in os.listdir(DEV_SET)
                    if os.path.isdir(os.path.join(DEV_SET, d)))
    roots = {dev: os.path.join(OUT_DIR, "mine", str(dev))
             for dev in (DEVICE, "cpu")}
    for dev, root in roots.items():
        shutil.rmtree(root, ignore_errors=True)
        for scene in scenes if dev == DEVICE else scenes[:2]:
            shutil.copytree(os.path.join(DEV_SET, scene),
                            os.path.join(root, scene))
    card = {s: _mine(os.path.join(roots[DEVICE], s), DEVICE) for s in scenes}
    out = {"scenes": len(scenes), "negatives": {}, "card_s": {}, "cpu_s": {}}
    for scene, r in card.items():
        with open(os.path.join(roots[DEVICE], scene,
                               "challeng_sample.json")) as f:
            if json.load(f) != {"negative_sample": r["neg"],
                                "positive_sample": r["pos"]}:
                raise AssertionError(f"mining {scene}: JSON != result")
        out["negatives"][scene] = len(r["neg"])
        out["card_s"][scene] = r["s"]
    for scene in scenes[:2]:
        r = _mine(os.path.join(roots["cpu"], scene), "cpu")
        got_map, want_map = card[scene]["engine"].srp_map, r["engine"].srp_map
        peak = float(np.abs(want_map).max())
        err = float(np.abs(got_map - want_map).max())
        if not err <= SRP_TOL * peak:
            raise AssertionError(f"mining {scene}: SRP map card vs CPU {err}")
        for kind in ("neg", "pos"):
            a = {tuple(x) for x in card[scene][kind]}
            b = {tuple(x) for x in r[kind]}
            for cand in sorted(a ^ b):
                margin = _threshold_margin(r["engine"], cand)
                log(f"mining {scene}: {kind} candidate {list(cand)} found "
                    f"only on the {'card' if cand in a else 'CPU'}; its "
                    f"map value lies {margin:.3e} from a threshold")
                if margin > SRP_TOL * peak:
                    raise AssertionError(f"mining {scene}: {kind} lists "
                                         f"differ at {list(cand)}")
        out["cpu_s"][scene] = r["s"]
        log(f"mining {scene}: SRP map card vs CPU max abs err {err:.3e} (map "
            f"max {peak:.4f}); {len(r['neg'])} negatives and {len(r['pos'])} "
            f"positives on the CPU, {len(card[scene]['neg'])} and "
            f"{len(card[scene]['pos'])} on the card; CPU {r['s']:.3f}s")
    card_s = list(out["card_s"].values())
    out["card_s_median"] = statistics.median(card_s)
    log(f"mining: negatives per scene {out['negatives']}; card seconds per "
        f"scene median {out['card_s_median']:.3f} (first {card_s[0]:.3f}, "
        f"max {max(card_s):.3f})")
    return out


def _baseline_map(mic_pos, range_spk, mix, method, device):
    """MicArray(prune_method=method) on `device`: (float64 map, patches,
    seconds)."""
    from acousticswarms_speech_tpu_torch.pipeline import mic_array

    arr = mic_array.MicArray(mic_pos, spk_range=range_spk,
                             prune_method=method, device=device)
    maps = []
    real = mic_array.BASELINE_MAPS[method]

    def recording(*args, **kwargs):
        maps.append(real(*args, **kwargs))
        return maps[-1]

    mic_array.BASELINE_MAPS[method] = recording
    try:
        sync()
        t0 = time.time()
        patches, _ = arr.apply_srp_phat(mix)
        sync()
        sec = time.time() - t0
    finally:
        mic_array.BASELINE_MAPS[method] = real
    return maps[0], patches, sec


def _tops_svd_check(mic_pos, range_spk, mix) -> dict:
    """TOPS's smallest singular value on the card two ways, on dev scene
    00000's stacked projections: torch.linalg.svdvals of D, and the square
    root of the smallest eigenvalue of the 3x3 Gram D D^H."""
    import torch

    from acousticswarms_speech_tpu_torch.constants import FREQ_BINS, FS, N_FFT
    from acousticswarms_speech_tpu_torch.dsp import music, tops
    from acousticswarms_speech_tpu_torch.dsp.geometry import build_geometry

    geom = build_geometry(mic_pos, range_spk, grid_size=0.05)
    mode = music.grid_mode_vectors(geom.grids, geom.mic_pos, FREQ_BINS, FS,
                                   N_FFT, device=DEVICE)
    node = tops.TOPS(geom.mic_pos, geom.grids, FREQ_BINS, mode, nfft=N_FFT)
    X = music._windows_stft(mix, mix.shape[1], 1, N_FFT, DEVICE)[0]
    D = node.projections(X)

    def gram():  # what TOPS.process computes
        G = D @ D.conj().transpose(-1, -2)
        return torch.linalg.eigvalsh(G)[:, 0].clamp(min=0).sqrt()

    svd = []  # one call: it takes seconds on the card
    svd_ms = cuda_ms(lambda: svd.append(torch.linalg.svdvals(D)[:, -1]), 1, 0)
    a, b = svd[0], gram()
    return {"D_shape": list(D.shape), "svdvals_ms": svd_ms,
            "gram_eigvalsh_ms": cuda_ms(gram, 5, 1),
            "inverse_max_rel_diff": float(((1 / a - 1 / b).abs().max()
                                           / (1 / a).max()).item())}


def baselines_phase() -> dict:
    """MicArray with the MUSIC and TOPS prune methods on dev scene 00000,
    on the card and on the CPU: maps and pruned patch lists compared."""
    import numpy as np

    from acousticswarms_speech_tpu_torch.pipeline.evaluate import (
        get_items, preprocess_metadata)

    metadata, mix, _ = get_items(os.path.join(DEV_SET, "00000"))
    _, mic_pos, _, _, _, range_spk = preprocess_metadata(metadata)
    out = {}
    for method in ("MUSIC", "TOPS"):
        card_map, card_patches, card_s = _baseline_map(
            mic_pos, range_spk, mix, method, DEVICE)
        cpu_map, cpu_patches, cpu_s = _baseline_map(
            mic_pos, range_spk, mix, method, "cpu")
        peak = float(np.abs(cpu_map).max())
        err = float(np.abs(card_map - cpu_map).max())
        if not (np.isfinite(card_map).all() and err <= MAP_TOL * peak):
            raise AssertionError(f"{method}: map card vs CPU {err} ({peak})")
        same = len(card_patches) == len(cpu_patches) and all(
            np.array_equal(a.sample_offset, b.sample_offset)
            and np.array_equal(a.width_list, b.width_list)
            for a, b in zip(card_patches, cpu_patches))
        if not same or not card_patches:
            raise AssertionError(f"{method}: patches {len(card_patches)} on "
                                 f"the card, {len(cpu_patches)} on the CPU")
        out[method] = {"card_s": card_s, "cpu_s": cpu_s, "map_max_abs_err": err,
                       "map_peak": peak, "patches": len(card_patches),
                       "grid_points": len(cpu_map)}
        log(f"baselines {method}: G={len(cpu_map)}; map card {card_s:.3f}s, "
            f"CPU {cpu_s:.3f}s; card vs CPU max abs err {err:.3e} (map max "
            f"{peak:.4g}); {len(card_patches)} patches, equal")
    out["tops_svd"] = _tops_svd_check(mic_pos, range_spk, mix)
    log(f"baselines TOPS smallest singular value on the card: "
        f"{json.dumps(out['tops_svd'])}")
    return out


def loader_phase(build_s: dict) -> dict:
    """native.load_wavs of the 16 dev scenes' mixtures against
    utils.audio's reads."""
    import numpy as np
    import torch

    from acousticswarms_speech_tpu_torch.runtime import native
    from acousticswarms_speech_tpu_torch.utils.audio import read_wav

    scenes = sorted(d for d in os.listdir(DEV_SET)
                    if os.path.isdir(os.path.join(DEV_SET, d)))
    paths = [[os.path.join(DEV_SET, s, f"mic{m:02d}_mixed.wav")
              for m in range(7)] for s in scenes]
    t0 = time.time()
    got = [native.load_wavs(p, len(native.load_wav(p[0]))) for p in paths]
    native_s = time.time() - t0
    t0 = time.time()
    want = [np.concatenate([read_wav(f)[0] for f in p]) for p in paths]
    python_s = time.time() - t0
    for s, a, b in zip(scenes, got, want):
        if not torch.equal(torch.from_numpy(a), torch.from_numpy(b)):
            raise AssertionError(f"loader: scene {s} differs")
    out = {"build_s": build_s["wavloader.cpp (g++)"], "native_read_s":
           native_s, "python_read_s": python_s, "scenes": len(scenes)}
    log(f"loader: built in {out['build_s']:.2f}s; {len(scenes)} scenes x 7 "
        f"mixtures read natively in {native_s:.4f}s and by utils.audio in "
        f"{python_s:.4f}s, equal")
    return out


# The 10-mic configuration (BASELINE.json's stretch configuration, "10+
# mics"): scenes rendered on the card, and both release descriptions at full
# width with n_mics = 10 and weights drawn from seeds.  No 10-mic weights
# exist, so its heads and quality figures measure nothing but the path.
MANY_MICS = 10
# (label, seed, seconds), 3 talkers each: two scenes for the evaluation and
# the forwards, and one for streaming, cut from 6 s to 1 s (two chunks): the
# seeded networks make ~1150 spot calls per chunk, 9.2 s each on an H100.
MANY_SCENES = [("m10_a", 11, 3.0), ("m10_b", 12, 3.0), ("m10_stream", 13, 1.0)]
MANY_SEEDS = {"speech_localization": 10, "speech_separation": 11}
# forward_streaming's chunks, as tests/test_torch_pipeline.py streams
STREAM_CHUNK, STREAM_OVERLAP = 28000, 8000
# The CPU tests' narrow networks at 10 mics (tests/test_torch_many_mics.py),
# on 0.5 s of a scene with a 0.25 s selection crop and a 0.1 m grid.
NARROW_SPOT = dict(channels=8, encoder_channels=32, residual_layers=1,
                   num_head=2, ffw_dim=16, num_transformer_layers=1)
NARROW_SEP = dict(max_speakers=5, channels=8, encoder_channels=32,
                  residual_layers=1, num_head=2, ffw_dim=16,
                  bottleneck_layers=1, bottleneck_ksize=7)
NARROW_SLICE_S, NARROW_CROP_S, NARROW_GRID = 0.5, 0.25, 0.1
NARROW_SISDR_DB = 30.0  # card against CPU audio, as the CPU tests hold
NARROW_CPU_THREADS = 4  # the CPU runs', in a child beside the card's work
# bfloat16 at 10 (SpotNet) and 20 (SepNet) input channels, card against the
# CPU: SpotNet on 2 candidates of 1 s of the first scene, SepNet on two
# speakers over 0.5 s of it, at TDoA offsets from a seed.
MANY_BF16_SPOT_S, MANY_BF16_SEP_S = 1.0, 0.5


def _random_experiment(name: str, seed: int, root: str) -> str:
    """<root>/<name>_m10: the release description of `name` with n_mics =
    MANY_MICS, and float16 release weights (the layout of
    scripts/export_release) that init_model draws from a torch.Generator
    seeded with `seed`."""
    from acousticswarms_speech_tpu_torch.models import create_model, init_model
    from acousticswarms_speech_tpu_torch.models.msgpack_writer import \
        write_msgpack
    from acousticswarms_speech_tpu_torch.scripts.export_release import \
        _float16_sorted
    from acousticswarms_speech_tpu_torch.training.checkpoints import \
        params_tree

    with open(os.path.join(REPO, "experiments", name, "description.json")) as f:
        desc = json.load(f)
    for key in ("model_params", "train_set_params", "test_set_params"):
        desc[key]["n_mics"] = MANY_MICS
    model = init_model(create_model(desc["model_name"], desc["model_params"]),
                       seed=seed)
    exp = os.path.join(root, f"{name}_m{MANY_MICS}")
    os.makedirs(os.path.join(exp, "release"))
    with open(os.path.join(exp, "description.json"), "w") as f:
        json.dump(desc, f, indent=4)
    write_msgpack(os.path.join(exp, "release", "params_f16.msgpack"),
                  _float16_sorted(params_tree(model.state_dict())))
    return exp


def _head_positions(patches):
    import numpy as np

    return np.array([np.asarray(p[0].center_pos())[:2] for p in patches])


def _narrow_forward(scene_dir: str, device: str, out_path: str) -> None:
    """JointPipeline.forward of the narrow 10-mic networks (weights from
    seeds 20 and 21) on NARROW_SLICE_S of a scene, after its first
    NARROW_SLICE_S, on `device`; writes the heads' centres, the audio, the
    spot calls and the seconds to `out_path` (npz)."""
    import numpy as np

    from acousticswarms_speech_tpu_torch.constants import FS
    from acousticswarms_speech_tpu_torch.models import (SepNet, SpotNet,
                                                        init_model)
    from acousticswarms_speech_tpu_torch.pipeline.evaluate import (
        get_items, preprocess_metadata)
    from acousticswarms_speech_tpu_torch.pipeline.joint import JointPipeline

    metadata, mix, _ = get_items(scene_dir)
    _, mic_pos, _, _, _, roi = preprocess_metadata(metadata)
    n = int(NARROW_SLICE_S * FS)
    seg = np.ascontiguousarray(mix[:, n:2 * n])
    pipe = JointPipeline(
        init_model(SpotNet(n_mics=MANY_MICS, **NARROW_SPOT), seed=20),
        init_model(SepNet(n_mics=MANY_MICS, **NARROW_SEP), seed=21),
        device=device, sweep_crop_seconds=NARROW_CROP_S)
    pipe.setup(mic_pos, roi, grid_size=NARROW_GRID)
    t0 = time.time()
    patches, audio_loc, audio, *_ = pipe.forward(seg)
    np.savez(out_path, heads=_head_positions(patches), audio=np.asarray(audio),
             audio_loc=np.asarray(audio_loc), calls=pipe.spot_model.calls,
             seconds=time.time() - t0)


def _bf16_nets(exps: dict, scene_dir: str, device: str, out_path: str,
               with_f32: bool = False) -> None:
    """The 10-mic SpotNet (window one-hot [1, 0]) on 2 candidates rolled by
    seeded shifts over MANY_BF16_SPOT_S of a scene, after its first
    NARROW_SLICE_S, and SepNet on two speakers at seeded offsets over
    MANY_BF16_SEP_S of it, both in bfloat16 on `device` (and in float32
    with `with_f32`); writes the outputs to `out_path` (npz)."""
    import numpy as np
    import torch

    from acousticswarms_speech_tpu_torch.constants import FS
    from acousticswarms_speech_tpu_torch.models import load_release
    from acousticswarms_speech_tpu_torch.models.common import normalize_input
    from acousticswarms_speech_tpu_torch.ops.shift import \
        roll_channels_batch_plain
    from acousticswarms_speech_tpu_torch.pipeline.evaluate import get_items
    from acousticswarms_speech_tpu_torch.search.spotform import \
        SeparationInference

    _, mix, _ = get_items(scene_dir)
    n = int(NARROW_SLICE_S * FS)
    rng = np.random.default_rng(30)
    shifts = rng.integers(-20, 20, size=(2, MANY_MICS)).astype(np.int32)
    shifts[:, 0] = 0
    seg = np.ascontiguousarray(mix[:, n:n + int(MANY_BF16_SPOT_S * FS)])
    normed, _, _ = normalize_input(roll_channels_batch_plain(
        torch.from_numpy(seg), torch.from_numpy(shifts)))
    w = torch.tensor([[1.0, 0.0]]).expand(len(shifts), 2)
    offsets = [rng.integers(-20, 20, MANY_MICS - 1).astype(float)
               for _ in range(2)]
    sep_mix = np.ascontiguousarray(mix[:, n:n + int(MANY_BF16_SEP_S * FS)])
    res = {}
    for key, dtype in (("bf16", torch.bfloat16),
                       ("f32", torch.float32))[:2 if with_f32 else 1]:
        spot = load_release(exps["speech_localization"], device, dtype)
        with torch.no_grad():
            res[f"spot_{key}"] = spot(normed.to(device, dtype), w.to(
                device, dtype)).float().cpu().numpy()[:, 0]
        del spot
        sep = SeparationInference(load_release(exps["speech_separation"],
                                               device),
                                  use_bf16=key == "bf16", device=device)
        res[f"sep_{key}"] = sep.infer_sample(sep_mix, offsets)
        del sep
    np.savez(out_path, **res)


def _cpu_child(exps: dict, scene_dir: str, root: str):
    """A child process running, on the CPU, _narrow_forward and then
    _bf16_nets on the first scene (narrow_cpu.npz, bf16_cpu.npz)."""
    code = (f"import sys; sys.path.insert(0, {REPO!r}); import torch; "
            f"torch.set_num_threads({NARROW_CPU_THREADS}); import chip_smoke; "
            f"chip_smoke._narrow_forward({scene_dir!r}, 'cpu', "
            f"{os.path.join(root, 'narrow_cpu.npz')!r}); "
            f"chip_smoke._bf16_nets({exps!r}, {scene_dir!r}, 'cpu', "
            f"{os.path.join(root, 'bf16_cpu.npz')!r})")
    with open(os.path.join(root, "cpu_child.log"), "w") as f:
        return subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                                stdout=f, stderr=subprocess.STDOUT,
                                stdin=subprocess.DEVNULL)


def _narrow_card_vs_cpu(drive, scene_dir: str, root: str, child) -> dict:
    """The narrow networks on the card with deterministic cuDNN, beside the
    child's CPU run of the same: the same heads within the grid, audio at
    >= NARROW_SISDR_DB."""
    import numpy as np
    import torch

    from acousticswarms_speech_tpu_torch.utils.metrics import si_sdr

    card_path = os.path.join(root, "narrow_card.npz")
    torch.backends.cudnn.deterministic = True
    try:
        drive("narrow", lambda: _narrow_forward(scene_dir, DEVICE, card_path))
    finally:
        torch.backends.cudnn.deterministic = False
    t0 = time.time()
    code = child.wait(timeout=CHILD_TIMEOUT_S)
    waited = time.time() - t0
    if code != 0:
        with open(os.path.join(root, "cpu_child.log")) as f:
            print(f.read()[-4000:], flush=True)
        raise AssertionError(f"many_mics CPU child exited {code}")
    card = np.load(card_path)
    cpu = np.load(os.path.join(root, "narrow_cpu.npz"))
    faults, dist, sisdr = [], math.nan, [math.nan]
    if card["heads"].shape != cpu["heads"].shape or not len(cpu["heads"]):
        faults.append(f"{len(card['heads'])} heads on the card, "
                      f"{len(cpu['heads'])} on the CPU")
    else:
        dist = float(np.abs(card["heads"] - cpu["heads"]).max())
        sisdr = [float(si_sdr(a, b)) for key in ("audio", "audio_loc")
                 for a, b in zip(card[key], cpu[key])]
        if dist > NARROW_GRID or min(sisdr) < NARROW_SISDR_DB:
            faults.append(f"heads {dist:.3f} m apart, audio SI-SDR {sisdr}")
    out = {"heads": len(cpu["heads"]), "max_center_dist_m": dist,
           "min_sisdr_db": min(sisdr), "spot_calls_card": int(card["calls"]),
           "spot_calls_cpu": int(cpu["calls"]),
           "card_s": float(card["seconds"]), "cpu_s": float(cpu["seconds"]),
           "cpu_waited_s": waited}
    log(f"many_mics narrow networks ({NARROW_SLICE_S} s, crop "
        f"{NARROW_CROP_S} s, grid {NARROW_GRID} m): {len(card['heads'])} heads "
        f"on the card (deterministic cuDNN, forward {out['card_s']:.2f}s) and "
        f"{len(cpu['heads'])} on the CPU ({NARROW_CPU_THREADS} threads in a "
        f"child, forward {out['cpu_s']:.2f}s, waited {waited:.2f}s), centres "
        f"within {dist:.4f} m; audio SI-SDR card vs CPU min {min(sisdr):.2f} "
        f"dB; spot calls {out['spot_calls_card']} and {out['spot_calls_cpu']}")
    if faults:
        raise AssertionError(f"many_mics narrow card vs CPU: {faults}")
    return out


def many_mics_phase() -> dict:
    """The 10-mic configuration on the card (see the module docstring):
    scenes, full-width networks, evaluation (whose first scene gives the
    float32 forward), the bfloat16 forward, streaming, and the narrow
    networks card against CPU (the CPU run in a child process beside the
    rest).  Every driven step counts the roll kernel's launches (set to 0
    just before it, read just after) and records the inputs of each roll;
    the kernel is held against its plain version on all of them after."""
    import numpy as np
    import torch

    from acousticswarms_speech_tpu_torch.data import voicegen
    from acousticswarms_speech_tpu_torch.ops.roll_kernel import \
        roll_channels_batch_cuda
    from acousticswarms_speech_tpu_torch.pipeline.joint import JointPipeline

    root = os.path.join(OUT_DIR, "many_mics")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"launches": {}, "seconds": {}}
    rolls = []

    def drive(name, fn):
        """fn() with the launch count set to 0 just before and read just
        after; returns (result, seconds)."""
        with recording_rolls() as got:
            roll_channels_batch_cuda.launches = 0
            sync()
            t0 = time.time()
            result = fn()
            sync()
            sec = time.time() - t0
            n = roll_channels_batch_cuda.launches
        if n != len(got):
            raise AssertionError(f"many_mics {name}: {n} launches for "
                                 f"{len(got)} rolls")
        out["launches"][name] = n
        out["seconds"][name] = sec
        rolls.extend(got)
        return result, sec

    def memory():
        return (f"peak device memory "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # 1. scenes; the narrow networks' CPU run starts on the first at once
    t0 = time.time()
    bank = os.path.join(root, "voices")
    voicegen.generate_voice_bank(bank, n_speakers=6, clips_per_speaker=2,
                                 duration=3.0, seed=0)
    voices = [os.path.join(bank, d) for d in sorted(os.listdir(bank))]
    out["generation"] = {
        label: _render_on_both(voices, root, label, seed,
                               {"n_mics": MANY_MICS, "duration": sec})
        for label, seed, sec in MANY_SCENES}
    scene = {label: os.path.join(root, DEVICE, label, "00000")
             for label, _, _ in MANY_SCENES}
    out["seconds"]["scenes"] = time.time() - t0

    # 2. the networks at full width, written as experiments; the CPU's
    # share of steps 4 and 6 starts in a child at once
    t0 = time.time()
    exps = {name: _random_experiment(name, seed,
                                     os.path.join(root, "experiments"))
            for name, seed in MANY_SEEDS.items()}
    child = _cpu_child(exps, scene["m10_a"], root)
    try:
        pipe = JointPipeline.from_experiments(exps["speech_localization"],
                                              exps["speech_separation"],
                                              device=DEVICE)
        out["seconds"]["networks"] = time.time() - t0
        log(f"many_mics: experiments "
            f"{[os.path.relpath(e, REPO) for e in exps.values()]} written and "
            f"loaded in {out['seconds']['networks']:.2f}s: SpotNet "
            f"{sum(p.numel() for p in pipe.spot_model.model.parameters())} "
            f"params, SepNet "
            f"{sum(p.numel() for p in pipe.sep_model.model.parameters())} "
            f"params, {MANY_MICS} mics")
        out.update(_many_mics_driven(drive, pipe, scene, root, memory))
        del pipe
        _bf16_nets(exps, scene["m10_a"], DEVICE,
                   os.path.join(root, "bf16_card.npz"), with_f32=True)
        # 6. the narrow networks, card against CPU
        out["narrow"] = _narrow_card_vs_cpu(drive, scene["m10_a"], root, child)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    # 4 (continued). bfloat16 at 10 and 20 input channels, card against CPU
    card = np.load(os.path.join(root, "bf16_card.npz"))
    cpu = np.load(os.path.join(root, "bf16_cpu.npz"))
    out["bf16_nets"] = {
        "spotnet": _bf16_check(
            f"10-mic SpotNet (B=2, T={card['spot_bf16'].shape[-1]})",
            card["spot_bf16"], cpu["spot_bf16"], card["spot_f32"]),
        "sepnet": _bf16_check(
            f"10-mic SepNet (2 speakers, T={card['sep_bf16'].shape[-1]})",
            card["sep_bf16"], cpu["sep_bf16"], card["sep_f32"])}
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9

    total = sum(out["launches"].values())
    if total <= 0:
        raise AssertionError("the 10-mic path never launched the roll kernel")
    hold_rolls(rolls, "many_mics")
    m, s = max(rolls, key=lambda r: r[1].shape[0] * r[0].shape[1])
    big = check_kernel(m.contiguous(), s.contiguous())
    out["largest_launch"] = {k: big[k] for k in ("B", "M", "T", "ms",
                                                 "plain_ms", "library_ms",
                                                 "bound_ms")}
    out["roll_launches"] = total
    log(f"many_mics: roll kernel launches {json.dumps(out['launches'])} "
        f"({total} in all), each equal to plain; largest launch "
        f"B={big['B']} M={big['M']} T={big['T']}: kernel_ms={big['ms']:.4f} "
        f"plain_ms={big['plain_ms']:.4f} library_ms={big['library_ms']:.4f} "
        f"bound_ms={big['bound_ms']:.4f}; {memory()}")
    return out


def _many_mics_driven(drive, pipe, scene, root, memory) -> dict:
    """Steps 3-5 of the 10-mic phase on the full-width pipeline: the
    evaluation of the two 3 s scenes, whose first scene's set-up and
    forward are the float32 forward's figures; the bfloat16 forward of that
    scene against them; streaming."""
    import numpy as np

    from acousticswarms_speech_tpu_torch.pipeline.analyze import analyze
    from acousticswarms_speech_tpu_torch.pipeline.evaluate import (
        evaluate_dataset, get_items, preprocess_metadata)
    from acousticswarms_speech_tpu_torch.pipeline.joint import JointPipeline
    from acousticswarms_speech_tpu_torch.utils.metrics import si_sdr

    out = {}
    # 3. evaluation over the two 3 s scenes; the first scene's set-up and
    # forward are caught on their way through
    data = os.path.join(root, "dataset")
    folder = os.path.join(root, "eval")
    for k, label in enumerate(("m10_a", "m10_b")):
        shutil.copytree(scene[label], os.path.join(data, f"{k:05d}"))
    first = {}

    def setup(*args, **kwargs):
        t0 = time.time()
        JointPipeline.setup(pipe, *args, **kwargs)
        if "setup_s" not in first:
            srp = pipe.mic_processor.srp.computer
            first.update(setup_s=time.time() - t0, args=(args, kwargs),
                         grid_points=int(pipe.mic_processor.geom.num_clusters),
                         table_bytes=srp.steer_re.nbytes + srp.steer_im.nbytes)

    def forward(mix_data, *args, **kwargs):
        calls = pipe.spot_model.calls
        t0 = time.time()
        res = JointPipeline.forward(pipe, mix_data, *args, **kwargs)
        if "forward" not in first:
            sync()
            first.update(forward=res, wall_s=time.time() - t0, mix=mix_data,
                         metrics=dict(pipe.stage_metrics(),
                                      spotform_calls=pipe.spot_model.calls
                                      - calls))
        return res

    pipe.setup, pipe.forward = setup, forward
    try:
        counts, eval_s = drive("evaluate", lambda: evaluate_dataset(
            pipe, data, results_folder=folder))
    finally:
        del pipe.setup, pipe.forward
    results = _read_results(folder)
    if sorted(results) != ["result_00000.json", "result_00001.json"] or \
            not all(map(_finite_numbers, results.values())):
        raise AssertionError(f"many_mics evaluation: {sorted(results)}")
    summ = analyze(folder, verbose=False)
    p, r = summ["precision"], summ["recall"]
    out["evaluate"] = {"counts": counts, "s": eval_s, "precision": p,
                       "recall": r, "f1": 2 * p * r / (p + r) if p + r else 0.0,
                       "sisdri_mean": summ["sisdri_mean"],
                       "spot_calls": [res["spot_times"] for res in
                                      results.values()]}
    patches, audio_loc, audio = first["forward"][:3]
    mix = first["mix"]
    audio, audio_loc = np.asarray(audio), np.asarray(audio_loc)
    if audio.shape != (len(patches), mix.shape[1]) or audio_loc.shape != \
            audio.shape or not np.isfinite(audio).all():
        raise AssertionError(f"many_mics forward: {len(patches)} heads, audio "
                             f"{audio.shape}")
    heads = _head_positions(patches)
    log(f"many_mics forward (float32, the evaluation's first scene, "
        f"{mix.shape}): setup {first['setup_s']:.2f}s (G="
        f"{first['grid_points']}, SRP steering table "
        f"{first['table_bytes'] / 1e9:.3f} GB), forward {first['wall_s']:.3f}s;"
        f" stage_metrics {json.dumps(first['metrics'])}; {len(patches)} heads "
        f"at {np.round(heads, 3).tolist()}")
    log(f"many_mics evaluation of 2 scenes (untrained weights: no quality "
        f"figure): {eval_s:.2f}s, counts {counts}; P {p:.4f} R {r:.4f} F1 "
        f"{out['evaluate']['f1']:.4f}; SI-SDRi {summ['sisdri_mean']} dB; "
        f"spot calls {out['evaluate']['spot_calls']}; {memory()}")

    # 4. the bfloat16 forward of the first scene
    pipe16 = JointPipeline(pipe.spot_model.model, pipe.sep_model.model,
                           device=DEVICE, use_bf16=True)
    args, kwargs = first["args"]
    pipe16.setup(*args, **kwargs)
    (patches16, _, audio16, *_), wall16 = drive("forward_bf16",
                                                lambda: pipe16.forward(mix))
    audio16 = np.asarray(audio16)
    if audio16.shape != (len(patches16), mix.shape[1]) or \
            not np.isfinite(audio16).all():
        raise AssertionError(f"many_mics bf16 forward: {len(patches16)} "
                             f"heads, audio {audio16.shape}")
    matched = []
    for k, pos in enumerate(_head_positions(patches16) if len(heads) else []):
        d = np.linalg.norm(heads - pos, axis=1)
        j = int(d.argmin())
        matched.append((k, j, float(d[j]), float(si_sdr(audio16[k], audio[j]))))
    metrics16 = pipe16.stage_metrics()
    log(f"many_mics forward (bfloat16): {wall16:.3f}s; stage_metrics "
        f"{json.dumps(metrics16)}; {len(patches16)} heads beside "
        f"{len(patches)} in float32; matched (bf16 head, f32 head, distance "
        f"m, SI-SDR of bf16 audio against f32 dB): "
        + "; ".join(f"({k}, {j}, {d:.3f}, {s:.2f})" for k, j, d, s in matched))
    del pipe16
    out["forward"] = {
        **{k: first[k] for k in ("setup_s", "grid_points", "table_bytes",
                                 "wall_s")},
        "heads": len(patches), **first["metrics"], "bf16_wall_s": wall16,
        "bf16_heads": len(patches16),
        "bf16_spotform_calls": metrics16["spotform_calls"],
        "bf16_matched": matched}

    # 5. streaming
    metadata, long_mix, _ = get_items(scene["m10_stream"])
    _, mic_pos, _, _, _, roi = preprocess_metadata(metadata)
    t0 = time.time()
    pipe.setup(mic_pos, roi)
    setup_s = time.time() - t0
    pipe.spot_model.calls = 0
    (tracks, per_chunk), stream_s = drive(
        "streaming", lambda: pipe.forward_streaming(
            long_mix, chunk_samples=STREAM_CHUNK, overlap=STREAM_OVERLAP))
    T = long_mix.shape[1]
    n_chunks = len(per_chunk)
    if n_chunks != -(-(T - STREAM_OVERLAP) // (STREAM_CHUNK - STREAM_OVERLAP)) \
            or any(tr["audio"].shape != (T,) or not np.isfinite(tr["audio"]).all()
                   or not set(tr["chunks"]) <= set(range(n_chunks))
                   for tr in tracks):
        raise AssertionError(f"many_mics streaming: {n_chunks} chunks, "
                             f"{len(tracks)} tracks")
    out["streaming"] = {"setup_s": setup_s, "s": stream_s, "chunks": n_chunks,
                        "tracks": len(tracks),
                        "spot_calls": pipe.spot_model.calls}
    log(f"many_mics streaming ({long_mix.shape}, chunks of {STREAM_CHUNK} "
        f"with {STREAM_OVERLAP} overlap): setup {setup_s:.2f}s, "
        f"{stream_s:.2f}s for {n_chunks} chunks; {len(tracks)} tracks over "
        f"chunks {[sorted(tr['chunks']) for tr in tracks]}; spot calls "
        f"{pipe.spot_model.calls}; {memory()}")
    return out


MESH_TIMEOUT_S = 180  # each rank's process-group timeout
MESH_DEADLINE_S = 240  # each launch's
SWEEP_RTOL = 1e-4  # powers: rows run in other chunk batches on cuDNN
SIM_ATOL = 1e-2  # dB, the SI-SDR matrix
WAVE_TOL = 1e-4  # of the peak: waveforms and separated audio


def _sweep_close(label: str, cmp: dict) -> bool:
    """Check a rank's sharded sweep against the unsharded one; True when
    they are bit-equal."""
    import numpy as np

    exact = cmp["waveform_max_abs_diff"] == 0 and cmp["sisdr_max_abs_diff"] == 0
    for key in ("powers", "powers_win"):
        got, want = cmp[key]
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        log(f"mesh {label}: {key} max rel diff {rel:.3e}")
        exact = exact and bool(np.array_equal(got, want))
        if not rel <= SWEEP_RTOL:
            raise AssertionError(f"mesh {label}: {key} differ by {rel}")
    if not cmp["sisdr_max_abs_diff"] <= SIM_ATOL:
        raise AssertionError(f"mesh {label}: SI-SDR matrix differs by "
                             f"{cmp['sisdr_max_abs_diff']}")
    if not cmp["waveform_max_abs_diff"] <= WAVE_TOL * cmp["waveform_peak"]:
        raise AssertionError(f"mesh {label}: waveforms differ by "
                             f"{cmp['waveform_max_abs_diff']}")
    log(f"mesh {label}: sharded sweep (K={cmp['K']}, T={cmp['T']}) vs "
        f"unsharded: SI-SDR matrix max abs diff {cmp['sisdr_max_abs_diff']:.3e}"
        f" dB, waveforms {cmp['waveform_max_abs_diff']:.3e} (peak "
        f"{cmp['waveform_peak']:.4f}); bit-equal: {exact}")
    return exact


def _same_heads(got: dict, want: dict) -> list[str]:
    """Where two forwards' final heads differ (centers within 1e-5 m and
    localization offsets within 1e-4 samples, as the CPU tests hold)."""
    import numpy as np

    if len(got["heads"]) != len(want["heads"]):
        return [f"{len(got['heads'])} heads vs {len(want['heads'])}"]
    diffs = []
    for k, (g, w) in enumerate(zip(got["heads"], want["heads"])):
        if not (np.allclose(g["center"], w["center"], rtol=0, atol=1e-5)
                and np.allclose(g["localization_offset"],
                                w["localization_offset"], rtol=0, atol=1e-4)
                and np.array_equal(g["audio_offset"], w["audio_offset"])
                and g["label"] == w["label"]):
            diffs.append(f"head {k}: {g} vs {w}")
    return diffs


def mesh_phase(fine_mix, fine_shifts, mix) -> dict:
    """parallel/ on the card: the nccl sweep at world size 1, the two-rank
    gloo sweep and forward, and the dry run (see the module docstring)."""
    import numpy as np
    import torch

    from acousticswarms_speech_tpu_torch.parallel import ranks
    from acousticswarms_speech_tpu_torch.parallel.mesh import launch

    torch.cuda.empty_cache()  # the ranks share the card with this process
    offsets = list(-fine_shifts[:, 1:].astype(float))
    out = {}

    def run(label, world, backend, deterministic, forward=None):
        t0 = time.time()
        res = launch(ranks.release_mesh_check, world, backend, "cuda",
                     args=(SPOT_DIR, fine_mix, offsets, deterministic, forward),
                     timeout_s=MESH_TIMEOUT_S, deadline_s=MESH_DEADLINE_S)
        wall = time.time() - t0
        if len({r["checksum"] for r in res}) != 1:
            raise AssertionError(f"mesh {label}: the ranks' sweeps differ")
        for r in res:
            k = r["kernel"]
            if not k["equal"] or k["max_abs_err"] != 0:
                raise AssertionError(f"mesh {label} rank {r['rank']}: roll "
                                     f"kernel != plain at {k['shape']}")
            if r["launches"] <= 0:
                raise AssertionError(f"mesh {label} rank {r['rank']}: no roll "
                                     f"kernel launch")
            log(f"mesh {label} rank {r['rank']} ({r['backend']}, "
                f"{r['device']}): sharded sweep {r['sharded_sweep_s']:.3f}s, "
                f"of which all-gathers {r['gather_s']:.4f}s "
                f"({100 * r['gather_s'] / r['sharded_sweep_s']:.1f}%); roll "
                f"kernel launches {r['launches']} ({r['sweep_launches']} in "
                f"the sweep), largest {k['shape']} equal to plain; spot calls "
                f"{r['sweep_spot_calls']} in the sweep"
                + (f", {r['forward_spot_calls']} in the forward "
                   f"{r['sharded_forward_s']:.3f}s" if forward else "")
                + f"; peak memory {r['peak_memory_gb']:.2f} GB")
        log(f"mesh {label}: unsharded sweep on rank 0 "
            f"{res[0]['unsharded_sweep_s']:.3f}s"
            + (f", unsharded forward {res[0]['unsharded_forward_s']:.3f}s"
               if forward else "") + f"; launch wall {wall:.2f}s")
        exact = _sweep_close(label, res[0]["sweep"])
        return res, wall, exact

    nccl, out["nccl_wall_s"], out["nccl_bit_equal"] = run("nccl x1", 1, "nccl",
                                                           True)
    forward = {"sep_dir": SEP_DIR, "mix": mix, "mic_pos": MIC_POS,
               "roi": ROI, "cache_dir": CACHE_DIR}
    gloo, out["gloo_wall_s"], out["gloo_bit_equal"] = run("gloo x2", 2, "gloo",
                                                          True, forward)
    want = gloo[0]["unsharded_forward"]
    for r in gloo:
        diffs = _same_heads(r["sharded_forward"], want)
        for d in diffs:
            log(f"mesh gloo x2 rank {r['rank']}: forward head differs: {d}")
        if diffs:
            raise AssertionError(f"mesh rank {r['rank']}: the sharded "
                                 f"forward's heads differ from the unsharded")
        a, b = r["sharded_forward"]["audio"], want["audio"]
        err = float(np.abs(a - b).max())
        if a.shape != b.shape or not err <= WAVE_TOL * np.abs(b).max():
            raise AssertionError(f"mesh rank {r['rank']}: audio differs {err}")
        log(f"mesh gloo x2 rank {r['rank']}: forward {len(want['heads'])} "
            f"heads equal to the unsharded forward's; audio max abs diff "
            f"{err:.3e} (peak {np.abs(b).max():.4f})")
    t0 = time.time()
    dry = subprocess.run(
        [sys.executable, "-m", "acousticswarms_speech_tpu_torch.parallel.dryrun",
         "--n_devices", "2", "--device", "cuda", "--backend", "gloo"],
        cwd=REPO, capture_output=True, text=True, timeout=MESH_DEADLINE_S,
        stdin=subprocess.DEVNULL)
    out["dryrun_s"] = time.time() - t0
    if dry.returncode != 0:
        raise AssertionError(f"dry run exited {dry.returncode}:\n"
                             f"{dry.stdout}\n{dry.stderr}")
    log(f"mesh dry run in {out['dryrun_s']:.2f}s: {dry.stdout.strip()}")
    out["launches"] = {"mesh_nccl_rank0": nccl[0]["launches"],
                       **{f"mesh_rank{r['rank']}": r["launches"] for r in gloo}}
    out["kernel_max_abs_err"] = max(r["kernel"]["max_abs_err"]
                                    for r in nccl + gloo)
    for label, res in (("nccl", nccl), ("gloo", gloo)):
        out[label] = [{k: r[k] for k in (
            "rank", "sharded_sweep_s", "gather_s", "launches",
            "sweep_launches", "sweep_spot_calls", "peak_memory_gb")}
            for r in res]
        out[label][0]["unsharded_sweep_s"] = res[0]["unsharded_sweep_s"]
    for r, summary in zip(gloo, out["gloo"]):
        summary["forward_spot_calls"] = r["forward_spot_calls"]
        summary["sharded_forward_s"] = r["sharded_forward_s"]
    out["gloo"][0]["unsharded_forward_s"] = gloo[0]["unsharded_forward_s"]
    return out


def counted(name: str, phase, *args):
    """Run a phase with the roll kernel's launch count set to 0 just before
    and read just after; these paths never roll, so it must stay 0."""
    from acousticswarms_speech_tpu_torch.ops.roll_kernel import \
        roll_channels_batch_cuda

    t0 = time.time()
    roll_channels_batch_cuda.launches = 0
    result = phase(*args)
    sync()
    launches = roll_channels_batch_cuda.launches
    log(f"{name} phase {time.time() - t0:.2f}s; roll kernel launches "
        f"{launches}")
    if launches != 0:
        raise AssertionError(f"{name} launched the roll kernel {launches} "
                             f"times")
    return result, launches


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
        build_s = build_phase()
        kernel_check_phase()
        pipe, mix, shapes, launches, f32_out, summary = main_path_phase()
        kernel_row = reference_phase(pipe, mix, shapes, launches)
        log(f"main path summary {json.dumps(summary)}")
        fine_mix, fine_shifts = (t.cpu().numpy() for t in max(
            shapes, key=lambda r: r[1].shape[0] * r[0].shape[1]))
        del shapes
        t0 = time.time()
        profile = profile_phase(pipe, mix)
        log(f"profile phase {time.time() - t0:.2f}s: {json.dumps(profile)}")
        t0 = time.time()
        bf16 = bf16_phase(pipe, mix, fine_mix, fine_shifts, f32_out)
        log(f"bf16 phase {time.time() - t0:.2f}s: {json.dumps(bf16)}")
        del pipe, f32_out
        t0 = time.time()
        bench = bench_phase(bf16)
        log(f"bench phase {time.time() - t0:.2f}s")
        t0 = time.time()
        many_mics = many_mics_phase()
        log(f"many_mics phase {time.time() - t0:.2f}s: {json.dumps(many_mics)}")
        t0 = time.time()
        evaluation = eval_phase()
        log(f"evaluation phase {time.time() - t0:.2f}s: "
            f"{json.dumps(evaluation)}")
        t0 = time.time()
        bf16_eval = bf16_eval_phase(evaluation)
        log(f"bf16 evaluation phase {time.time() - t0:.2f}s: "
            f"{json.dumps(bf16_eval)}")
        t0 = time.time()
        retune = retune_phase(evaluation)
        log(f"retune phase {time.time() - t0:.2f}s: {json.dumps(retune)}")
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
        tools, tools_launches = counted("tools", tools_phase)
        generation, gen_launches = counted("generation", generation_phase)
        mining, mine_launches = counted("mining", mining_phase)
        baselines, base_launches = counted("baselines", baselines_phase)
        loader = loader_phase(build_s)
        new_paths = {"generation": generation, "mining": mining,
                     "baselines": baselines, "loader": loader, "tools": tools}
        log(f"new paths: {json.dumps(new_paths)}")
        t0 = time.time()
        mesh = mesh_phase(fine_mix, fine_shifts, mix)
        log(f"mesh phase {time.time() - t0:.2f}s: {json.dumps(mesh)}")
        kernel_row["launches_by_path"] = {
            "joint_forward": launches,
            "joint_forward_profiled": profile["roll_launches"],
            "joint_forward_bf16": bf16["roll_launches"],
            "bench": bench["roll_launches"],
            "many_mics": many_mics["roll_launches"],
            "evaluate_serial": evaluation["roll_launches_serial"],
            "evaluate_serial_deterministic":
                evaluation["roll_launches_serial_deterministic"],
            "evaluate_lanes": evaluation["roll_launches_lanes"],
            "evaluate_serial_bf16": bf16_eval["roll_launches"],
            "evaluate_traced": retune["traced"]["roll_launches"],
            "probe_sep_batch": retune["probe_roll_launches"],
            "train": train_launches,
            "tools": tools_launches,
            "generation": gen_launches,
            "mining": mine_launches,
            "baselines": base_launches,
            **mesh["launches"],
        }
        kernel_row["max_abs_err"] = max(kernel_row["max_abs_err"],
                                        mesh["kernel_max_abs_err"])
        kernel_row["eval_largest_launch"] = evaluation["largest_launch"]
        kernel_row["many_mics_largest_launch"] = many_mics["largest_launch"]
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
