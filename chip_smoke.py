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
  main path    JointPipeline.forward of the port on the 3 s, 7-mic bench
               scene (.bench_fixture_v2.npz) with both release networks at
               full width in float32: a warm-up forward, then a timed one
               with the kernel's launch count reset just before it;
  reference    the card's SRP map, SpotNet and SepNet outputs against the
               same port code on the CPU, on the bench scene or a slice of it,
               and the roll kernel at every shape the main path gave it.

The last line is {"ok": true, "device": {...}}; the line before it holds the
kernel table as JSON.  Any fault prints a traceback and exits 1 without
those lines; so does a machine without CUDA.  A watchdog ends a run that
hangs.  The script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import faulthandler
import json
import os
import subprocess
import sys
import time
import traceback

WATCHDOG_S = 1100
REPO = os.path.dirname(os.path.abspath(__file__))
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


def _separate(model, seg, offs, device):
    from acousticswarms_speech_tpu_torch.search.spotform import \
        SeparationInference

    return SeparationInference(model, device=device).infer_sample(seg, offs)


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    sys.path.insert(0, REPO)
    try:
        import acousticswarms_speech_tpu_torch  # noqa: F401  (fail early)

        device = device_phase()
        build_phase()
        kernel_check_phase()
        pipe, mix, shapes, launches, summary = main_path_phase()
        kernel_row = reference_phase(pipe, mix, shapes, launches)
        log(f"main path summary {json.dumps(summary)}")
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
