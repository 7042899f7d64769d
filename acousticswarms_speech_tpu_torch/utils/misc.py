"""Seeding, JSON helpers and device-accurate timing (JAX: utils/misc.py).

Counterpart of reference sep/helpers/utils.py:20-77.  `seed_all` seeds the
host RNGs the datasets and search heuristics draw from, and torch's.
"""
from __future__ import annotations

import json
import os
import random
import time
from typing import List

import numpy as np
import torch


def seed_all(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def read_json(path: str):
    assert os.path.exists(path), f"File not found: {path}"
    with open(path, "rb") as f:
        return json.load(f)


def write_json(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=4)


def read_metadata(dir_path: str) -> dict:
    metadata = read_json(os.path.join(dir_path, "metadata.json"))
    assert metadata, "Empty scene metadata"
    return metadata


def list_top_level_directories(path: str) -> List[str]:
    return sorted(a for a in os.listdir(path) if os.path.isdir(os.path.join(path, a)))


class Timer:
    """Wall-clock timer that waits for the device's queued work at start and
    stop, so that it times device work too.  `device` (default: the current
    CUDA device when one exists) selects what to synchronize; on the CPU
    there is nothing to wait for."""

    def __init__(self, device=None) -> None:
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self.t1 = 0.0

    def _barrier(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start_recording(self) -> None:
        self._barrier()
        self.t1 = time.perf_counter()

    def stop_recording(self) -> float:
        self._barrier()
        return time.perf_counter() - self.t1
