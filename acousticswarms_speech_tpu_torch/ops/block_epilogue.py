"""The epilogue of a U-Net block (models/modules.py EncoderBlock and
DecoderBlock) after its strided convolution or its upsampling:

    out = glu(GroupNorm(2)(pre(e)))

with e (B, 2C, T), pre(e) = e + bias[c] (the encoders' conv1 bias),
gate[b, c] * e (SpotNet's decoders' window-embedding gate) or e, GroupNorm
over the two halves of the channels (statistics and affine step in
float32) and GLU's a * sigmoid(b) over the halves: out (B, C, T).

`block_epilogue_plain` is the composition of PyTorch operations the blocks
ran before, and the test oracle.  `block_epilogue_cuda` launches the
hand-written kernel K6 (csrc/block_epilogue.cu, built by runtime/build.py
at the first CUDA call): a statistics pass and an apply pass that move 10
bytes an element of e where the composition moves about 30, and give the
composition's bits on the card.  The kernel has no backward; the blocks
decide which of the two runs.
"""
from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F

from ..runtime.build import Library

GROUPS = 2  # GroupNorm's groups in the blocks: the two halves GLU pairs


def group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
               bias: torch.Tensor, eps: float) -> torch.Tensor:
    """GroupNorm of a (B, C, ...) tensor, statistics and affine step in
    float32, the result in x's dtype (models/modules.py GroupNorm)."""
    return F.group_norm(x.float(), num_groups, weight.float(), bias.float(),
                        eps).to(x.dtype)


def glu(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


def block_epilogue_plain(e: torch.Tensor, norm_weight: torch.Tensor,
                         norm_bias: torch.Tensor, eps: float,
                         bias: torch.Tensor | None = None,
                         gate: torch.Tensor | None = None) -> torch.Tensor:
    """glu(GroupNorm(2)(pre(e))) in PyTorch operations, on any device and
    dtype: e (B, 2C, T); `bias` (2C,) is added, or `gate` (B, 2C)
    multiplies, before the norm."""
    if bias is not None:
        e = e + bias[:, None]
    if gate is not None:
        e = gate[:, :, None] * e
    return glu(group_norm(e, GROUPS, norm_weight, norm_bias, eps), dim=1)


def _declare(lib) -> None:
    fn = lib.block_epilogue_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int


_library = Library("block_epilogue.cu", _declare)

# Each (item, group) row's partial statistics, one a warp of GroupNorm's 512
# threads a row (csrc/block_epilogue.cu), 3 floats each.
PARTIALS = 16
_PLAIN, _BIAS, _GATE = 0, 1, 2


def block_epilogue_cuda(e: torch.Tensor, norm_weight: torch.Tensor,
                        norm_bias: torch.Tensor, eps: float,
                        bias: torch.Tensor | None = None,
                        gate: torch.Tensor | None = None) -> torch.Tensor:
    """K6 on e (B, 2C, T) with T > 1, the norm's (2C,) weight and bias, and
    at most one of `bias` (2C,) and `gate` (B, 2C), all float32, contiguous
    and on one CUDA device -> a new (B, C, T) tensor.  Launches on the
    current stream."""
    if bias is not None and gate is not None:
        raise ValueError("block epilogue kernel takes a bias or a gate, "
                         "not both")
    extra = bias if bias is not None else gate
    tensors = [t for t in (e, norm_weight, norm_bias, extra) if t is not None]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("block epilogue kernel takes float32 tensors, got "
                        f"{[t.dtype for t in tensors]}")
    shapes = [tuple(t.shape) for t in tensors]
    if e.dim() != 3 or e.shape[1] % GROUPS or e.shape[2] < 2:
        raise ValueError(f"block epilogue kernel shapes: e (B, 2C, T > 1), "
                         f"got {shapes[0]}")
    B, C2, T = e.shape
    if (norm_weight.shape != (C2,) or norm_bias.shape != (C2,)
            or (bias is not None and bias.shape != (C2,))
            or (gate is not None and gate.shape != (B, C2))):
        raise ValueError(f"block epilogue kernel shapes: e (B, 2C, T), (2C,) "
                         f"norm and bias, (B, 2C) gate; got {shapes}")
    if B > 65535 or (C2 // GROUPS) * T >= 2 ** 31:
        raise ValueError(f"block epilogue kernel shapes: B <= 65535 and "
                         f"C * T < 2^31, got {shapes[0]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("block epilogue kernel takes contiguous tensors")
    if not all(t.is_cuda and t.device == e.device for t in tensors):
        raise ValueError("block epilogue kernel: every tensor must be on one "
                         "CUDA device")
    out = torch.empty((B, C2 // GROUPS, T), dtype=e.dtype, device=e.device)
    if e.numel() == 0:
        return out
    partials = torch.empty(B * GROUPS * PARTIALS * 3, dtype=torch.float32,
                           device=e.device)
    mode = _BIAS if bias is not None else _GATE if gate is not None else _PLAIN
    _library.launch("block_epilogue_launch", block_epilogue_cuda, e.device,
                    e.data_ptr(), None if extra is None else extra.data_ptr(),
                    mode, norm_weight.data_ptr(), norm_bias.data_ptr(),
                    partials.data_ptr(), out.data_ptr(), B, C2 // GROUPS, T,
                    float(eps))
    return out


# calls that launched the kernel since the last reset
block_epilogue_cuda.launches = 0
