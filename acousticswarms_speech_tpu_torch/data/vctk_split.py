"""Speaker-level train/test/val split for a VCTK-style corpus (JAX package:
data/vctk_split.py, copied): a 70/20/10 split at speaker level written to
vctk_split.json next to the corpus root.

CLI:  python -m acousticswarms_speech_tpu_torch.data.vctk_split <corpus_dir>
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def split_speakers(corpus_dir: str, train: float = 0.7, test: float = 0.2,
                   seed: int = 0) -> dict:
    speakers = sorted(
        d for d in os.listdir(corpus_dir)
        if os.path.isdir(os.path.join(corpus_dir, d))
    )
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(speakers))
    n_train = int(round(train * len(speakers)))
    n_test = int(round(test * len(speakers)))
    return {
        "train": [speakers[i] for i in order[:n_train]],
        "test": [speakers[i] for i in order[n_train:n_train + n_test]],
        "val": [speakers[i] for i in order[n_train + n_test:]],
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("corpus_dir", type=str)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    split = split_speakers(args.corpus_dir, seed=args.seed)
    out = args.out or os.path.join(os.path.dirname(args.corpus_dir.rstrip("/")),
                                   "vctk_split.json")
    with open(out, "w") as f:
        json.dump(split, f, indent=4)
    print(f"wrote {out}: {len(split['train'])}/{len(split['test'])}/"
          f"{len(split['val'])} speakers")


if __name__ == "__main__":
    main()
