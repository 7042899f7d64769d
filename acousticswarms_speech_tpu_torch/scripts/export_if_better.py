"""Export release weights only if the run's best validation loss is at or
below a threshold (JAX: scripts/export_if_better.py).

After a resume seeded from the release (seed_checkpoint_from_release.py)
the sidecar's history covers only the new epochs, and exporting its best
checkpoint blindly could replace the committed release with a worse one.

    python -m acousticswarms_speech_tpu_torch.scripts.export_if_better \
        <exp_dir> <val_threshold> [--device cpu]
"""
from __future__ import annotations

import argparse
import os

from ..training.checkpoints import load_state_summary
from .export_release import export


def export_if_better(exp_dir: str, threshold: float,
                     device=None) -> str | None:
    """The release path when it was written, else None."""
    exp_dir = exp_dir.rstrip("/")
    state_path = os.path.join(exp_dir, "checkpoints", "state.msgpack")
    summary = load_state_summary(state_path) or {}
    # the sidecar's key is val_losses; older runs wrote test_losses
    losses = summary.get("val_losses") or summary.get("test_losses") or []
    if not losses:
        print(f"[export_if_better] no val history in {state_path}; skipping")
        return None
    best = min(losses)
    if best > threshold:
        print(f"[export_if_better] best val {best:.6g} > {threshold:g}; "
              f"keeping the committed release")
        return None
    print(f"[export_if_better] best val {best:.6g} <= {threshold:g}; "
          f"exporting")
    return export(exp_dir, device)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("exp_dir")
    parser.add_argument("threshold", type=float)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; raises without a "
                             "card unless 'cpu' is given)")
    args = parser.parse_args(argv)
    export_if_better(args.exp_dir, args.threshold, args.device)


if __name__ == "__main__":
    main()
