"""Experiment directories: description.json and checkpoint resolution (JAX:
training/experiment.py).

Counterpart of reference sep/helpers/utils.py:165-215 (`load_model_from_exp`
with 'best' / 'last' / 'new' modes), in the reference's layout:
`<exp>/description.json` plus `<exp>/checkpoints/` holding the per-epoch
param files and the state sidecar.  With no checkpoint, the git-tracked
float16 release weights (`<exp>/release/params_f16.msgpack`) are loaded.
Reference torch `.pt` checkpoints go through the converter
(models/convert.py) when the directory has no param file of the port's.
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

from ..device import resolve_device
from ..models.convert import load_converted, load_torch_checkpoint
from ..models.factory import create_model, init_model
from ..models.weights import load_release
from .checkpoints import (find_checkpoints, load_params, load_state_summary,
                          summary_val_epochs)


def best_checkpoint_path(summary: dict | None,
                         our_ckpts: list[tuple[int, str]]) -> str:
    """Pick the lowest-val-loss checkpoint from (epoch, path) pairs.

    Maps the argmin over the sidecar's val-loss history to a TRUE epoch
    number via summary_val_epochs: loss histories can start later than
    epoch 0 after a corrupt-state recovery."""
    if summary is not None and summary["val_losses"]:
        idx = int(np.argmin(summary["val_losses"]))
        best_epoch = summary_val_epochs(summary)[idx]
        by_epoch = dict(our_ckpts)
        return by_epoch.get(best_epoch, our_ckpts[-1][1])
    return our_ckpts[-1][1]


def read_description(exp_dir: str) -> dict:
    with open(os.path.join(exp_dir, "description.json"), "rb") as f:
        return json.load(f)


def build_from_description(exp_dir: str):
    """(model, description) of an experiment directory, the model with its
    constructor's initial weights."""
    desc = read_description(exp_dir)
    model = create_model(desc["model_name"], desc["model_params"])
    return model, desc


def load_model_from_exp(exp_dir: str, mode: str = "best", device=None,
                        dtype: torch.dtype = torch.float32,
                        strict_convert: bool = True) -> torch.nn.Module:
    """The experiment's network with its weights, in eval mode on `device`
    (default cuda).

    'best' loads the checkpoint with the lowest validation loss in the
    sidecar, 'last' the latest epoch; with no checkpoint both load the
    release weights, or fresh parameters (with a warning) when there is no
    release either.  'new' always starts fresh.  Checkpoints live in
    `<exp_dir>/checkpoints/`, named after the directory or after the
    description's `experiment_name`.  With only reference torch checkpoints
    (`<name>_<epoch>.pt`) there, the highest epoch is converted; a key the
    converter cannot place raises unless `strict_convert=False`.
    """
    device = resolve_device(device)
    desc = read_description(exp_dir)
    names = [os.path.basename(exp_dir.rstrip("/"))]
    if desc.get("experiment_name") and desc["experiment_name"] not in names:
        names.append(desc["experiment_name"])
    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    torch_ckpts = sorted(
        p for n in names
        for p in glob.glob(os.path.join(ckpt_dir, f"{n}_*.pt"))
    )
    our_ckpts = next(
        (c for n in names if (c := find_checkpoints(ckpt_dir, n))), []
    )

    if mode == "new" or (not torch_ckpts and not our_ckpts):
        release = os.path.join(exp_dir, "release", "params_f16.msgpack")
        if mode != "new" and os.path.exists(release):
            print(f"[experiment] loading release weights {release}")
            return load_release(exp_dir, device, dtype)
        if mode != "new":
            print("[WARNING] no checkpoint found, using fresh parameters")
        model = init_model(create_model(desc["model_name"],
                                        desc["model_params"]))
        return model.to(device=device, dtype=dtype).eval()

    if not our_ckpts:
        path = max(torch_ckpts,
                   key=lambda p: int(p.rsplit("_", 1)[1].split(".")[0]))
        model = init_model(create_model(desc["model_name"],
                                        desc["model_params"]))
        load_converted(model, load_torch_checkpoint(path), desc["model_name"],
                       strict_convert=strict_convert, source=path)
        return model.to(device=device, dtype=dtype).eval()
    state_path = os.path.join(ckpt_dir, "state.msgpack")
    summary = load_state_summary(state_path) if mode == "best" else None
    path = best_checkpoint_path(summary, our_ckpts)
    model = create_model(desc["model_name"], desc["model_params"])
    model.load_state_dict(load_params(path), strict=True)
    return model.to(device=device, dtype=dtype).eval()
