"""Mine SRP hard negatives for a range of scenes.

    python -m acousticswarms_speech_tpu_torch.data.mine_range \\
        <dataset_dir> <begin> <end> [--device cpu]

Writes challeng_sample.json into each scene `<dataset_dir>/<idx:05d>` with
idx in [begin, end), skipping scenes without metadata.json and scenes
already mined.  A scene that fails is reported and the others are still
mined; the command then exits 1, so a run with failures never looks like a
finished one.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import traceback

from .generate_srp_sample import mine_sample


def mine_range(base: str, begin: int, end: int, device=None) -> list[int]:
    """Mine scenes begin..end-1 of `base`; returns the indices that failed."""
    t00 = time.time()
    done, failed = 0, []
    for idx in range(begin, end):
        d = os.path.join(base, f"{idx:05d}")
        if not os.path.exists(os.path.join(d, "metadata.json")):
            continue
        if os.path.exists(os.path.join(d, "challeng_sample.json")):
            done += 1
            continue
        try:
            neg, pos = mine_sample(d, device=device)
        except Exception as e:  # noqa: BLE001 (reported; the exit code says so)
            failed.append(idx)
            print(f"[{idx}] FAILED: {e}", flush=True)
            traceback.print_exc()
            continue
        done += 1
        print(f"[{idx}] {len(neg)} neg {len(pos)} pos "
              f"({time.time() - t00:.0f}s, {done} done)", flush=True)
    print("MINER DONE", done, f"({len(failed)} failed)" if failed else "",
          flush=True)
    return failed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset_dir", type=str)
    parser.add_argument("begin", type=int)
    parser.add_argument("end", type=int)
    parser.add_argument("--device", type=str, default=None,
                        help="device of the SRP map (default cuda)")
    args = parser.parse_args(argv)
    failed = mine_range(args.dataset_dir, args.begin, args.end, args.device)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
