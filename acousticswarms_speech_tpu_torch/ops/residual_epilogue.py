"""The epilogue of a dilated residual layer (models/modules.py
DilatedResidualLayer) after its convolution:

    out = LN_C(relu(z + conv_bias) + x) * norm_weight + norm_bias

with z the convolution without its bias, x the layer's input, both
(B, C, T), and LN_C ChannelLayerNorm's normalisation over C (population
variance, eps, statistics in float32).

`residual_epilogue_plain` is the composition of PyTorch operations the
layer ran before, and the test oracle.  `residual_epilogue_cuda` launches
the hand-written kernel K5 (csrc/residual_epilogue.cu, built by
runtime/build.py at the first CUDA call), which moves 12 bytes an element
where the composition moves 64 and gives the composition's bits on the
card.  The kernel has no backward; the layer decides which of the two runs.
"""
from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F

from ..runtime.build import Library


def channel_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over C of a (B, C, T) tensor, statistics and affine step in
    float32, the result in x's dtype (models/modules.py ChannelLayerNorm)."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=1, correction=0, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) \
        * weight.float()[None, :, None] + bias.float()[None, :, None]
    return out.to(x.dtype)


def residual_epilogue_plain(z: torch.Tensor, x: torch.Tensor,
                            conv_bias: torch.Tensor, norm_weight: torch.Tensor,
                            norm_bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LN_C(relu(z + conv_bias) + x) * norm_weight + norm_bias in PyTorch
    operations, on any device and dtype."""
    return channel_layer_norm(F.relu(z + conv_bias[:, None]) + x,
                              norm_weight, norm_bias, eps)


def _declare(lib) -> None:
    fn = lib.residual_epilogue_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.residual_epilogue_init.argtypes = []
    lib.residual_epilogue_init.restype = ctypes.c_int


# residual_epilogue_init sets the kernel's attributes on a device
_library = Library("residual_epilogue.cu", _declare,
                   init="residual_epilogue_init")

# The channels the kernel stages at most (csrc/residual_epilogue.cu
# kMaxChannels): 64 KB of shared memory a block at its smallest tile.
MAX_CHANNELS = 512


def residual_epilogue_cuda(z: torch.Tensor, x: torch.Tensor,
                           conv_bias: torch.Tensor, norm_weight: torch.Tensor,
                           norm_bias: torch.Tensor, eps: float) -> torch.Tensor:
    """K5 on z, x (B, C, T) and the three (C,) vectors, all float32,
    contiguous and on one CUDA device, C <= MAX_CHANNELS -> a new (B, C, T)
    tensor.  Launches on the current stream."""
    tensors = (z, x, conv_bias, norm_weight, norm_bias)
    if not all(t.is_cuda and t.device == z.device for t in tensors):
        raise ValueError("residual epilogue kernel: every tensor must be on "
                         "one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("residual epilogue kernel takes float32 tensors, got "
                        f"{[t.dtype for t in tensors]}")
    if (z.dim() != 3 or x.shape != z.shape
            or any(t.shape != (z.shape[1],) for t in tensors[2:])):
        raise ValueError("residual epilogue kernel shapes: z, x (B, C, T) and "
                         f"(C,) vectors, got {[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("residual epilogue kernel takes contiguous tensors")
    B, C, T = z.shape
    if C > MAX_CHANNELS:
        raise ValueError(f"residual epilogue kernel takes at most "
                         f"{MAX_CHANNELS} channels, got {C}")
    out = torch.empty((B, C, T), dtype=z.dtype, device=z.device)
    if z.numel() == 0:
        return out
    _library.launch("residual_epilogue_launch", residual_epilogue_cuda,
                    z.device, z.data_ptr(), x.data_ptr(), conv_bias.data_ptr(),
                    norm_weight.data_ptr(), norm_bias.data_ptr(),
                    out.data_ptr(), B, C, T, float(eps))
    return out


# calls that launched the kernel since the last reset
residual_epilogue_cuda.launches = 0
