"""Run one cell of the benchmark once, on one NVIDIA GPU.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON line as the last line of
standard output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer metrics), `device`,
with `--trace 1` `breakdown`, and last `check`, the numbers compared with
the plain reference beside their limits, which also end standard error.
Exits 1 and prints no result without a CUDA device, when the port cannot
be imported, or when JAX or the JAX package is loaded once the window has
closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(BENCH_DIR, ".cache")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # compile caches at fixed paths inside the checkout (the roll kernel's
    # library goes to the port's own kernel_build/, also inside it)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR,
                                                      "torch_extensions")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("[benchmark] no CUDA device: this benchmark runs on one NVIDIA "
              "GPU only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from benchmark import harness

    spec = harness.cell_spec(args.workload)
    chips = spec["cell"]["chips"]
    if torch.cuda.device_count() < chips:
        print(f"[benchmark] the cell needs {chips} GPUs, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"[benchmark] loaded after the window: {found}", file=sys.stderr)
        return 1
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
