"""Time the roll kernel (csrc/roll.cu) against other versions of its source,
in one process on the card.

    python -m acousticswarms_speech_tpu_torch.scripts.roll_ab OTHER.cu [...] \
        [--shape B M T] [--shape ...] [--rounds 12]

Each source exports `roll_channels_batch_launch` with csrc/roll.cu's C
interface.  Every version is built by nvcc with the kernel's flags (its
register report printed), held equal to the plain PyTorch version, then
timed with CUDA events in interleaved rounds, each version in turn in one
order and then the reverse, so that the card's clock and power state weigh
on all alike.  A version whose launch fails at a shape (a grid of one row
per block past 65535 rows) is left out there.  One line per shape: each
version's median, min and max ms over its timings (two a round), and the
bytes bound.
Compare versions only within one run.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import roll_kernel
from ..ops.shift import roll_channels_batch_plain
from ..runtime.build import BUILD_ROOT, compile_library

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SHAPES = [(336, 7, 72000), (1124, 10, 72000), (7000, 10, 1024)]


def _build(name: str, source: str, out_dir: str):
    lib = os.path.join(out_dir, name, "libroll.so")
    log = compile_library(source, lib)
    fn = ctypes.CDLL(lib).roll_channels_batch_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    return fn, regs


def compare(sources: dict[str, str], shapes, rounds: int = 12,
            reps: int = 20) -> dict:
    """{shape: {name: [ms]}} for each version in `sources`: two timings a
    round, each the mean of `reps` launches."""
    out_dir = os.path.join(BUILD_ROOT, "roll_ab")
    with ThreadPoolExecutor(len(sources)) as pool:
        futures = {n: pool.submit(_build, n, s, out_dir)
                   for n, s in sources.items()}
        built = {n: f.result() for n, f in futures.items()}
    for name, (_, regs) in built.items():
        print(f"{name}: {sources[name]}; {'; '.join(regs)}", flush=True)
    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    for B, M, T in shapes:
        mix = torch.randn(M, T, generator=gen).cuda()
        shifts = torch.randint(-T + 1, T, (B, M), generator=gen,
                               dtype=torch.int32).cuda()
        want = roll_channels_batch_plain(mix, shifts)
        got = torch.empty_like(want)

        def launch(fn):
            return fn(mix.data_ptr(), shifts.data_ptr(), got.data_ptr(), B, M,
                      T, stream)

        names = []
        for name, (fn, _) in built.items():
            got.zero_()
            if launch(fn) != 0:
                continue
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} != plain at {(B, M, T)}")
            names.append(name)
        times = {n: [] for n in names}
        for _ in range(rounds):
            for name in names + names[::-1]:
                fn = built[name][0]
                for _ in range(3):
                    launch(fn)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(reps):
                    launch(fn)
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / reps)
        bound = 4 * (M * T + B * M + B * M * T) / HBM_BYTES_PER_S * 1e3
        print(f"{(B, M, T)} bound {bound:.4f} ms: " + "; ".join(
            f"{n} median {statistics.median(v):.4f} min {min(v):.4f} max "
            f"{max(v):.4f}" for n, v in times.items()), flush=True)
        result[(B, M, T)] = times
    return result


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("others", nargs="+", help="other roll.cu sources")
    parser.add_argument("--shape", nargs=3, type=int, action="append",
                        metavar=("B", "M", "T"), help=f"default {SHAPES}")
    parser.add_argument("--rounds", type=int, default=12)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernels run only on the card")
    sources = {"current": roll_kernel.SOURCE}
    sources.update({os.path.basename(p): p for p in args.others})
    compare(sources, [tuple(s) for s in args.shape or SHAPES], args.rounds)


if __name__ == "__main__":
    main()
