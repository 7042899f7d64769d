"""Seed an experiment's checkpoints/ from its release weights (JAX:
scripts/seed_checkpoint_from_release.py).

Writes the release weights, as float32, as `checkpoints/<exp>_<epoch>.msgpack`,
so that training's auto-resume continues from epoch `epoch + 1` with the
released parameters instead of restarting from `pretrain_path`.  The
optimizer starts fresh, which the resume path allows.  Does nothing when
the directory already has checkpoints.

    python -m acousticswarms_speech_tpu_torch.scripts.seed_checkpoint_from_release \
        <exp_dir> <epoch> [--device cpu]
"""
from __future__ import annotations

import argparse
import os

from ..training import checkpoints as ckpt
from ..training.experiment import load_model_from_exp


def seed(exp_dir: str, epoch: int, device=None) -> str | None:
    """The checkpoint path when it was written, else None."""
    exp_dir = exp_dir.rstrip("/")
    name = os.path.basename(exp_dir)
    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    if ckpt.latest_checkpoint(ckpt_dir, name) is not None:
        print(f"[seed] {ckpt_dir} already has checkpoints; nothing to do")
        return None
    # with no checkpoint, 'best' loads release/params_f16.msgpack as float32
    model = load_model_from_exp(exp_dir, mode="best", device=device)
    os.makedirs(ckpt_dir, exist_ok=True)
    out = os.path.join(ckpt_dir, f"{name}_{epoch}.msgpack")
    ckpt.save_params(out, model)
    print(f"[seed] wrote {out} (resume will start at epoch {epoch + 1})")
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("exp_dir")
    parser.add_argument("epoch", type=int)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; raises without a "
                             "card unless 'cpu' is given)")
    args = parser.parse_args(argv)
    seed(args.exp_dir, args.epoch, args.device)


if __name__ == "__main__":
    main()
