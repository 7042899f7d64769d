"""Checkpoint save/load for params and training state (JAX:
training/checkpoints.py).

The layout is the JAX package's, so each package reads the other's files:
- per-epoch param files `<exp>_<epoch>.msgpack` in flax's layout (a nested
  map under "params", float32 arrays as msgpack ext type 1), written with
  the port's own encoder (models/msgpack_writer.py);
- the `state.msgpack.json` sidecar with the same keys (epoch, lr, loss
  histories, val_epochs, scheduler state), which selects the best
  checkpoint.

The JAX package's binary `state.msgpack` holds optax state, which the port
does not write.  The port's optimizer state goes to `optimizer.pt` beside
it (`torch.save` of the optimizer's `state_dict`); a name without "_" never
matches the `<exp>_*.pt` pattern under which either package looks for
reference torch checkpoints.
"""
from __future__ import annotations

import glob
import json
import os
import re
from typing import Mapping

import torch

from ..models.msgpack_reader import read_msgpack
from ..models.msgpack_writer import write_msgpack
from ..models.weights import from_jax_params

OPTIMIZER_FILE = "optimizer.pt"


def params_tree(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """A module's state_dict -> the flax variables tree {"params": {...}} of
    float32 numpy arrays (module names are the tree's keys joined by ".")."""
    tree: dict = {}
    for name, val in state_dict.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val.detach().to("cpu", torch.float32).numpy()
    return {"params": tree}


def save_params(path: str, model: torch.nn.Module) -> None:
    write_msgpack(path, params_tree(model.state_dict()))


def load_params(path: str) -> dict[str, torch.Tensor]:
    """A param file (the port's or the JAX package's) -> a state_dict."""
    return from_jax_params(read_msgpack(path))


def optimizer_path(state_path: str) -> str:
    return os.path.join(os.path.dirname(state_path), OPTIMIZER_FILE)


def save_state(path: str, optimizer: torch.optim.Optimizer | None,
               scheduler_state: dict, train_losses: list, val_losses: list,
               epoch: int, lr: float, val_epochs: list | None = None) -> None:
    """`path` is the JAX package's `state.msgpack` path: the sidecar goes to
    `path + ".json"`, the optimizer state (when given) to `optimizer.pt`
    beside it."""
    if val_epochs is None:
        # Contiguous history ending at `epoch` (the common case).
        val_epochs = list(range(epoch - len(val_losses) + 1, epoch + 1))
    if optimizer is not None:
        opt_path = optimizer_path(path)
        tmp = f"{opt_path}.tmp{os.getpid()}"
        torch.save({"optimizer": optimizer.state_dict(), "epoch": epoch,
                    "lr": lr}, tmp)
        os.replace(tmp, opt_path)
    with open(path + ".json", "w") as f:
        json.dump({"epoch": epoch, "lr": lr,
                   "train_losses": list(map(float, train_losses)),
                   "val_losses": list(map(float, val_losses)),
                   "val_epochs": list(map(int, val_epochs)),
                   "scheduler": scheduler_state}, f)


def load_optimizer_state(path: str, device=None) -> dict | None:
    """The optimizer state saved beside `path` (None if there is none)."""
    opt_path = optimizer_path(path)
    if not os.path.exists(opt_path):
        return None
    return torch.load(opt_path, map_location=device, weights_only=True)


def summary_val_epochs(summary: dict) -> list[int]:
    """Epoch number of each entry in summary['val_losses'].

    Older sidecars lack 'val_epochs'; their histories may have been
    truncated by a corrupt-state recovery while epoch numbering continued,
    so the i-th loss belongs to epoch `epoch - (n-1) + i`, anchored at the
    *last* entry, not to epoch i.
    """
    n = len(summary["val_losses"])
    epochs = summary.get("val_epochs")
    if epochs is not None and len(epochs) == n:
        return [int(e) for e in epochs]
    last = summary.get("epoch")
    if last is None:
        return list(range(n))
    return list(range(int(last) - n + 1, int(last) + 1))


def load_state_summary(path: str) -> dict | None:
    """Read the sidecar JSON written by save_state."""
    if not os.path.exists(path + ".json"):
        return None
    with open(path + ".json") as f:
        return json.load(f)


def find_checkpoints(checkpoints_dir: str, experiment_name: str):
    """(epoch, path) pairs of saved param checkpoints, sorted by epoch."""
    pattern = os.path.join(checkpoints_dir, f"{experiment_name}_*.msgpack")
    out = []
    for p in glob.glob(pattern):
        m = re.search(rf"{re.escape(experiment_name)}_([0-9]+)\.msgpack$", p)
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out)


def latest_checkpoint(checkpoints_dir: str, experiment_name: str):
    ckpts = find_checkpoints(checkpoints_dir, experiment_name)
    return ckpts[-1] if ckpts else None
