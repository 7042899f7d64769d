# Frozen copy of acousticswarms_speech_tpu_torch/models/common.py at commit 300ffdc,
# part of the benchmark's plain reference: it imports nothing of the port.
"""Input normalization shared by both networks (JAX: models/common.py).

Inputs are quantized to 16-bit, the per-item mean across microphones is the
normalization reference, and std uses Bessel's correction.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def normalize_input(data: torch.Tensor):
    """data: (B, M, T) -> (normalized, means (B,1,1), stds (B,1,1))."""
    data = torch.round(data * 2 ** 15) / 2 ** 15
    ref = data.mean(dim=1)  # (B, T): average across microphones
    means = ref.mean(dim=1)[:, None, None]
    stds = ref.std(dim=1, correction=1)[:, None, None]
    return (data - means) / stds, means, stds


def unnormalize_input(data: torch.Tensor, means, stds) -> torch.Tensor:
    return data * stds + means


def run_block(remat: bool, block: torch.nn.Module, *args, **kwargs):
    """`block(*args, **kwargs)`.  With `remat`, while training with
    gradients on, the block's activations are recomputed in the backward
    pass instead of kept (the JAX package's `nn.remat`)."""
    if remat and block.training and torch.is_grad_enabled():
        return checkpoint(block, *args, use_reentrant=False, **kwargs)
    return block(*args, **kwargs)
