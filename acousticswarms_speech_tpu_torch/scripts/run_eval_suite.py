"""Evaluation suite: the bench, held-out-scene evaluation, then its
analysis (JAX: scripts/run_eval_suite.py).

Runs, each in a child process:
  1. the port's `scripts.bench` -> one JSON line (skipped with
     --skip_bench);
  2. the port's `pipeline.evaluate` over a shard of the held-out test set,
     in bfloat16 on the cached geometry;
  3. the port's `pipeline.analyze` -> precision/recall, localization
     error, SI-SDRi.

A failed bench prints `bench FAILED` and the evaluation still runs, as in
the JAX script; unlike it, the suite then exits with the bench's code.  A
failed evaluation or analysis ends the suite with its code.

    python -m acousticswarms_speech_tpu_torch.scripts.run_eval_suite \
        [--dataset .speechdata_v1/test] [--num_shards 3] [--shard_index 0] \
        [--results_folder .results_speech] [--skip_bench] [--device cuda]

Relative paths given on the command line are taken from the current
directory; the defaults lie under the repository.  The device defaults to
cuda, and the suite raises before any step when there is no card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

from ..device import resolve_device

PKG = "acousticswarms_speech_tpu_torch"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset",
                   default=os.path.join(REPO, ".speechdata_v1", "test"))
    p.add_argument("--spot_exp", default=os.path.join(
        REPO, "experiments", "speech_localization"))
    p.add_argument("--sep_exp", default=os.path.join(
        REPO, "experiments", "speech_separation"))
    p.add_argument("--results_folder",
                   default=os.path.join(REPO, ".results_speech"))
    p.add_argument("--num_shards", type=int, default=3)
    p.add_argument("--shard_index", type=int, default=0)
    p.add_argument("--skip_bench", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device of the evaluation (default cuda; "
                        "raises without a card unless 'cpu' is given)")
    args = p.parse_args(argv)
    for k in ("dataset", "spot_exp", "sep_exp", "results_folder"):
        setattr(args, k, os.path.abspath(getattr(args, k)))
    return args


def spot_dir(spot_exp: str) -> str:
    """`spot_exp` when it holds checkpoints or a release, else the stage-1
    localization experiment."""
    if os.path.isdir(os.path.join(spot_exp, "checkpoints")) or \
            os.path.isdir(os.path.join(spot_exp, "release")):
        return spot_exp
    return os.path.join(REPO, "experiments", "speech_localization_stage1")


def commands(args) -> list[tuple[str, list[str]]]:
    """(title, command) of each child, in order."""
    evaluate = [
        sys.executable, "-m", f"{PKG}.pipeline.evaluate", args.dataset,
        "--spot_experiment_dir", spot_dir(args.spot_exp),
        "--sep_experiment_dir", args.sep_exp,
        "--results_folder", args.results_folder,
        "--use_fp16", "--cached_init",
        "--num_shards", str(args.num_shards),
        "--shard_index", str(args.shard_index),
    ]
    if args.device is not None:
        evaluate += ["--device", args.device]
    analyze = [sys.executable, "-m", f"{PKG}.pipeline.analyze",
               args.results_folder]
    steps = [("eval", evaluate), ("analyze", analyze)]
    if not args.skip_bench:
        bench = [sys.executable, "-m", f"{PKG}.scripts.bench"]
        if args.device is not None:
            bench += ["--device", args.device]
        steps.insert(0, ("bench", bench))
    return steps


def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device)
    bench_code = 0
    for title, cmd in commands(args):
        print(f"=== {title} ===", flush=True)
        print(" ".join(cmd), flush=True)
        code = subprocess.run(cmd, cwd=REPO).returncode
        if code and title == "bench":
            print("bench FAILED", file=sys.stderr)
            bench_code = code
        elif code:
            print(f"run_eval_suite: {title} failed with exit code {code}",
                  file=sys.stderr)
            return code
    return bench_code


if __name__ == "__main__":
    sys.exit(main())
