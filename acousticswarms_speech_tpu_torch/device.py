"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None,
                   mesh=None) -> torch.device:
    """`cuda` unless the caller names another device.  Raises, and never
    falls back to the CPU, when a CUDA device is asked for and none exists.

    With a `mesh` (parallel/mesh.py), the mesh's device, which `device`
    may name but not contradict."""
    if mesh is not None:
        want = mesh.device if device is None else torch.device(device)
        if want.type != mesh.device.type or want.index not in (
                None, mesh.device.index):
            raise ValueError(f"device {want} differs from the mesh's "
                             f"{mesh.device}")
        return mesh.device
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
