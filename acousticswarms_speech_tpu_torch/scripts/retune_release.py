"""Per-release NMS/threshold re-tune loop in one command (JAX:
scripts/retune_release.sh with scripts/round4_probe.sh).

The merge/power thresholds encode the current networks' leakage profile,
so every weight release invalidates them.  The loop, in order:

  1. a traced probe: the port's `pipeline.evaluate` over one shard of the
     dataset with both release experiments, in bfloat16 on the cached
     geometry, in a child process whose environment sets
     ACOUSTIC_TRACE_POWERS=1 and SPOT_POWER_THRESHOLD1=<coarse_thr> (an
     uncensored coarse threshold); its trace_*.json go beside the results;
  2. `pipeline.analyze`, then the three analyzers of the trace records
     (analyze_probe, analyze_retention, tune_thresholds);
  3. the offline NMS replay in four modes (merge thresholds, `--devs`,
     `--gate`, `--elect`);
  4. the probe's provenance: the NMS_/SPOT_/THRESHOLD keys of its
     config.json.

It prints the decision tables and leaves freezing a default to the
operator.  The steps after the probe run in this process, each as
`python -m` would run it.  The loop stops at the first step that fails and
exits with that step's code.

    python -m acousticswarms_speech_tpu_torch.scripts.retune_release \
        [results_dir] [--dataset DIR] [--num_shards 27] [--shard_index 0] \
        [--coarse_thr 0.004] [--device cuda]

`results_dir` defaults to `.results_retune` and the dataset to
`.speechdata_v1/test`, both under the repository; the probe deletes
`results_dir` first.  The device defaults to cuda, and the loop raises
before any step when there is no card.
"""
from __future__ import annotations

import argparse
import json
import os
import runpy
import shutil
import subprocess
import sys
import traceback
from typing import NamedTuple

from ..device import resolve_device

PKG = "acousticswarms_speech_tpu_torch"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SPOT_EXP = os.path.join(REPO, "experiments", "speech_localization")
SEP_EXP = os.path.join(REPO, "experiments", "speech_separation")


class Step(NamedTuple):
    title: str
    module: str
    argv: list
    env: dict | None = None  # a child process with these variables added


def steps(args) -> list[Step]:
    """The loop's steps for the parsed arguments, in order."""
    out = args.results_dir
    probe = [args.dataset, "--spot_experiment_dir", SPOT_EXP,
             "--sep_experiment_dir", SEP_EXP, "--results_folder", out,
             "--use_fp16", "--cached_init",
             "--num_shards", str(args.num_shards),
             "--shard_index", str(args.shard_index)]
    if args.device is not None:
        probe += ["--device", args.device]
    scripts = f"{PKG}.scripts"
    return [
        Step("traced probe", f"{PKG}.pipeline.evaluate", probe,
             {"ACOUSTIC_TRACE_POWERS": "1",
              "SPOT_POWER_THRESHOLD1": str(args.coarse_thr)}),
        Step("analyze", f"{PKG}.pipeline.analyze", [out]),
        Step("NMS probe", f"{scripts}.analyze_probe", [out]),
        Step("retention root-cause (sub-patch aware)",
             f"{scripts}.analyze_retention",
             [out, "--dataset", args.dataset,
              "--coarse_thr", str(args.coarse_thr)]),
        Step("threshold tuner", f"{scripts}.tune_thresholds", [out]),
        Step("NMS merge-threshold replay", f"{scripts}.replay_nms", [out]),
        Step("labeled TDoA-deviation stats", f"{scripts}.replay_nms",
             [out, "--devs"]),
        Step("TDoA gate sweep", f"{scripts}.replay_nms", [out, "--gate"]),
        Step("elect A/B", f"{scripts}.replay_nms", [out, "--elect"]),
    ]


def run_step(step: Step) -> int:
    """Run `step` as `python -m <module> <argv>` would; its exit code."""
    sys.stdout.flush()
    if step.env is not None:
        cmd = [sys.executable, "-m", step.module, *step.argv]
        print(" ".join(cmd), flush=True)
        return subprocess.run(cmd, cwd=REPO,
                              env={**os.environ, **step.env}).returncode
    argv = sys.argv
    sys.argv = [step.module, *step.argv]
    try:
        runpy.run_module(step.module, run_name="__main__", alter_sys=True)
        return 0
    except SystemExit as e:
        if e.code is None or isinstance(e.code, int):
            return e.code or 0
        print(e.code, file=sys.stderr)
        return 1
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        sys.argv = argv
        sys.stdout.flush()


def provenance(results_dir: str) -> None:
    """The NMS_/SPOT_/THRESHOLD keys of the probe's config.json."""
    with open(os.path.join(results_dir, "config.json")) as f:
        cfg = json.load(f)
    for k in sorted(cfg):
        if any(t in k for t in ("NMS_", "SPOT_", "THRESHOLD")):
            print(f"  {k} = {cfg[k]}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("results_dir", nargs="?",
                   default=os.path.join(REPO, ".results_retune"))
    p.add_argument("--dataset",
                   default=os.path.join(REPO, ".speechdata_v1", "test"))
    p.add_argument("--num_shards", type=int, default=27)
    p.add_argument("--shard_index", type=int, default=0)
    p.add_argument("--coarse_thr", type=float, default=0.004)
    p.add_argument("--device", default=None,
                   help="torch device of the probe (default cuda; raises "
                        "without a card unless 'cpu' is given)")
    args = p.parse_args(argv)
    args.results_dir = os.path.abspath(args.results_dir)
    args.dataset = os.path.abspath(args.dataset)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device)
    shutil.rmtree(args.results_dir, ignore_errors=True)
    for step in steps(args):
        print(f"=== {step.title} ===", flush=True)
        code = run_step(step)
        if code:
            print(f"retune_release: step '{step.title}' ({step.module}) "
                  f"failed with exit code {code}", file=sys.stderr)
            return code
    print("=== frozen defaults now in effect (probe provenance) ===")
    provenance(args.results_dir)
    print("=== done: pick knees from the tables above, update the "
          "env-default\n    lines (search/clustering.py, constants.py), and "
          f"commit together\n    with {args.results_dir} as evidence ===",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
