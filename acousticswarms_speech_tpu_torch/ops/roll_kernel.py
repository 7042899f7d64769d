"""Load and launch the CUDA roll kernel (csrc/roll.cu), built by
runtime/build.py at the first CUDA call."""
from __future__ import annotations

import ctypes

import torch

from ..runtime.build import Library


def _declare(lib) -> None:
    fn = lib.roll_channels_batch_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int


_library = Library("roll.cu", _declare)
SOURCE = _library.source


def roll_channels_batch_cuda(mix: torch.Tensor,
                             shifts: torch.Tensor) -> torch.Tensor:
    """mix (M, T) float32, shifts (B, M) int32, both contiguous on one CUDA
    device -> (B, M, T), for any B * M.  Launches on the current stream."""
    if not (mix.is_cuda and shifts.is_cuda and mix.device == shifts.device):
        raise ValueError("roll kernel: mix and shifts must be on one CUDA device")
    if mix.dtype != torch.float32 or shifts.dtype != torch.int32:
        raise TypeError(f"roll kernel takes float32 mix and int32 shifts, got "
                        f"{mix.dtype} and {shifts.dtype}")
    if mix.dim() != 2 or shifts.dim() != 2 or shifts.shape[1] != mix.shape[0]:
        raise ValueError(f"roll kernel shapes: mix {tuple(mix.shape)}, "
                         f"shifts {tuple(shifts.shape)}")
    if not (mix.is_contiguous() and shifts.is_contiguous()):
        raise ValueError("roll kernel takes contiguous tensors")
    M, T = mix.shape
    B = shifts.shape[0]
    out = torch.empty((B, M, T), dtype=mix.dtype, device=mix.device)
    if B == 0 or T == 0:
        return out
    _library.launch("roll_channels_batch_launch", roll_channels_batch_cuda,
                    mix.device, mix.data_ptr(), shifts.data_ptr(),
                    out.data_ptr(), B, M, T)
    return out


# calls that launched the kernel since the last reset (a call of more than
# 65535 rows launches it once per 65535, csrc/roll.cu)
roll_channels_batch_cuda.launches = 0

