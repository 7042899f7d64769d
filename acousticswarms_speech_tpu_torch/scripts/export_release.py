"""Export an experiment's best checkpoint as float16 release weights,
`<exp>/release/params_f16.msgpack` (JAX: scripts/export_release.py).

Training checkpoints live in the gitignored `<exp>/checkpoints/`; the
git-tracked release weights keep evaluation and the benchmark reproducible
from a fresh clone, and float16 halves their size (loaders cast them back
to float32).  The file is flax's msgpack layout with the keys sorted at
every level, byte for byte what the JAX script writes for the same
parameters, so both packages load it.

    python -m acousticswarms_speech_tpu_torch.scripts.export_release \
        <exp_dir> [<exp_dir> ...] [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..models.msgpack_writer import write_msgpack
from ..training.checkpoints import params_tree
from ..training.experiment import load_model_from_exp


def _float16_sorted(tree: dict) -> dict:
    """The tree with sorted keys (the order in which the JAX script's
    tree_map rebuilds it) and float16 arrays."""
    return {k: (_float16_sorted(v) if isinstance(v, dict)
                else np.asarray(v, dtype=np.float16))
            for k, v in sorted(tree.items())}


def export(exp_dir: str, device=None) -> str:
    """Write the release file of `exp_dir`'s best checkpoint (by the
    sidecar's validation losses; the release itself when there is none);
    returns its path.  The network is loaded on `device` (default cuda)."""
    model = load_model_from_exp(exp_dir, mode="best", device=device)
    tree = _float16_sorted(params_tree(model.state_dict()))
    out_dir = os.path.join(exp_dir, "release")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "params_f16.msgpack")
    write_msgpack(out, tree)
    print(f"wrote {out} ({os.path.getsize(out) / 1e6:.1f} MB)")
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("exp_dirs", nargs="+")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; raises without a "
                             "card unless 'cpu' is given)")
    args = parser.parse_args(argv)
    for d in args.exp_dirs:
        export(d, args.device)


if __name__ == "__main__":
    main()
