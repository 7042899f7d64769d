"""Readings of the compared numbers, from which the limits are set: sound
runs of the port (the lower readings) and runs of its controls, the port
in a precision below the configuration's (the upper readings), on several
seeds in one process.

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,3 \
        --controls none,tf32,bf16 --seconds 10

Each run is the cell's own run (`harness.run_cell`) with a short window
(long enough for the mixtures a run checks) and no warm-up; one JSON line
per run on standard output: workload, seed, control, correct, the mixtures
finished and the numbers.  `tf32` lets matmuls and cuDNN use TF32 (the
nearest precision below float32 with TF32 off); `bf16` is the port's
bfloat16 path.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def readings(workload: str, seeds, control: str | None, seconds: float,
             device="cuda"):
    """One dict per seed: seed, control, correct, finished, numbers."""
    from benchmark import harness

    out = []
    for seed in seeds:
        spec = harness.cell_spec(workload)
        spec["traffic"]["warmup"] = 0
        spec["end_to_end"] = spec["per_layer"] = []
        result = harness.run_cell(spec, seed, seconds, False, device,
                                  time.perf_counter(), control=control)
        out.append({"workload": workload, "seed": seed, "control": control,
                    "correct": result["correct"],
                    "attempted": result["attempted"],
                    "numbers": {k: v["value"]
                                for k, v in result["check"].items()}})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", default="none")
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    for control in args.controls.split(","):
        readings(args.workload, seeds, None if control == "none" else control,
                 args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
