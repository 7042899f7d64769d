"""U-Net building blocks shared by SpotNet and SepNet (JAX: models/modules.py).

Attribute names follow the JAX package's parameter tree, so a flax tree
flattened with "." is this module tree's `state_dict` (models/weights.py).
All blocks take channel-first (B, C, T) activations.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.block_epilogue import (
    block_epilogue_cuda,
    block_epilogue_plain,
    glu,
    group_norm,
)
from ..ops.residual_epilogue import channel_layer_norm, residual_epilogue_cuda


def _on_kernel(x: torch.Tensor) -> bool:
    """Whether a block's epilogue runs its hand-written kernel: a float32
    input on a card with gradients off (the kernels have no backward)."""
    return (x.is_cuda and x.dtype == torch.float32
            and not torch.is_grad_enabled())


class ChannelLayerNorm(nn.Module):
    """LayerNorm over C of a (B, C, T) tensor, without transposing."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return channel_layer_norm(x, self.weight, self.bias, self.eps)


class Linear(nn.Linear):
    """nn.Linear that adds its bias to the rounded product, as the JAX
    package's Dense (`x @ w.T + b`) does in bfloat16.  The product and the
    bias add are two roundings there, and nn.Linear's fused one differs
    by an ulp, which attention scores amplify."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight) + self.bias


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with its statistics and affine step in float32 and the
    result cast back to the input's dtype, as the JAX package computes it
    (its bfloat16 configuration)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm with its statistics and affine step in float32 and the
    result cast back to the input's dtype, as the JAX package computes it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.num_groups, self.weight, self.bias,
                          self.eps)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scores: torch.Tensor | None = None,
              key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) [+ scores]) v over (B, H, T, d) heads, as the
    JAX package computes it in any dtype: the scores, the mask and the
    softmax in float32, the probabilities cast to v's dtype.  `scores` is
    an extra (B, H, T, T) float32 term added before the scale; `key_mask`
    (B, T) bool, False keys excluded."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if scores is not None:
        s = s + scores
    s = s / math.sqrt(q.shape[-1])
    if key_mask is not None:
        s = s.masked_fill(~key_mask[:, None, None, :], -1e30)
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)


class MultiheadAttention(nn.Module):
    """Self-attention with nn.MultiheadAttention's parameters
    (in_proj_weight (3E, E), in_proj_bias, out_proj) on (B, T, E)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, key_mask=None) -> torch.Tensor:
        B, T, E = x.shape
        H = self.num_heads
        qkv = F.linear(x, self.in_proj_weight) + self.in_proj_bias
        q, k, v = (t.reshape(B, T, H, E // H).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        out = attention(q, k, v, key_mask=key_mask)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, E))


class TransformerEncoderLayer(nn.Module):
    """The JAX TransformerEncoderLayer: post-norm, ReLU, no dropout, with
    nn.TransformerEncoderLayer's parameter names."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, x: torch.Tensor, key_mask=None) -> torch.Tensor:
        """x (B, T, E); `key_mask` (B, T) bool, False keys excluded."""
        x = self.norm1(x + self.self_attn(x, key_mask))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class TransformerEncoder(nn.Module):
    """Stack of post-norm ReLU encoder layers on (B, T, E)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layers_{i}", TransformerEncoderLayer(
                d_model, nhead, dim_feedforward))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
        return x


def conv1d_gemm(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """`F.conv1d(x, weight, bias, stride, padding)` (one group, no
    dilation) as one batched matrix product over the unfolded input:
    im2col to (B, C * k, L_out), then (O, C * k) @ that for each item, then
    the bias.  The same products as the convolution, each output summed
    over (c, j) in another order."""
    B = x.shape[0]
    O, C, k = weight.shape
    cols = F.unfold(x[:, :, None], (1, k), padding=(0, padding),
                    stride=(1, stride))
    y = torch.bmm(weight.reshape(O, C * k).expand(B, O, C * k), cols)
    return y if bias is None else y.add_(bias[:, None])


class GemmConv1d(nn.Conv1d):
    """nn.Conv1d (one group, no dilation, zero padding) as `conv1d_gemm`.
    In float32 with TF32 off, cuDNN runs the networks' input projection
    (kernel 1 from the microphones), reference bypass and mask encoder
    (kernel 33, stride 16) on its legacy `implicit_convolve_sgemm`: the
    mask encoder at about 15 TFLOP/s on an H100, where the product runs at
    about 49.  The unfolded input is k / stride times the input's size
    (2.1x for the mask encoder) and lives only inside the call."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if (self.groups != 1 or self.dilation != (1,)
                or self.padding_mode != "zeros"
                or isinstance(self.padding, str)):
            raise ValueError("GemmConv1d takes one group, no dilation and "
                             "a whole-number zero padding")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d_gemm(x, self.weight, self.bias, self.stride[0],
                           self.padding[0])


def conv_transpose1d_gemm(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """`F.conv_transpose1d(x, weight, bias, stride=k)` for a kernel k
    equal to its stride, where no two taps overlap:
    y[b, o, t * k + j] = bias[o] + sum_c weight[c, o, j] x[b, c, t].  One
    batched matrix product with rows (o, j), the bias a column against a
    row of ones, then one pass that interleaves the k rows of each o.  (The
    ones cost a copy of the input, which is 2-4x smaller than the output;
    starting the product from the broadcast bias, `baddbmm`, writes the
    output once more and was slower on an H100.)"""
    B, C, L = x.shape
    _, O, k = weight.shape
    w = torch.cat([weight.permute(1, 2, 0).reshape(O * k, C),
                   bias.repeat_interleave(k)[:, None]], 1)
    y = torch.bmm(w.expand(B, O * k, C + 1),
                  torch.cat([x, x.new_ones(B, 1, L)], 1))
    return y.view(B, O, k, L).transpose(2, 3).reshape(B, O, L * k)


class GemmConvTranspose1d(nn.ConvTranspose1d):
    """nn.ConvTranspose1d with kernel = stride and a bias (the decoders'
    upsampling) as `conv_transpose1d_gemm`: cuDNN's `dgrad_engine` with
    its bias pass took 1.03-2.1x as long on an H100 in float32 (10.1
    against 4.8 ms for SpotNet's last decoder at 64 candidates)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if (self.kernel_size != self.stride or self.padding != (0,)
                or self.output_padding != (0,) or self.groups != 1
                or self.dilation != (1,) or self.bias is None):
            raise ValueError("GemmConvTranspose1d takes kernel = stride, a "
                             "bias, one group and no padding or dilation")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose1d_gemm(x, self.weight, self.bias)


class DilatedResidualLayer(nn.Module):
    """Conv -> ReLU(+residual) -> LayerNorm over channels.

    A float32 CUDA input with gradients off runs the convolution without
    its bias and the rest, bias add included, in the fused kernel K5
    (ops/residual_epilogue.py): one pass over device memory instead of
    eight.  Every other call (CPU, meta, bfloat16, training) runs the
    composition below, which the kernel has no backward for."""

    def __init__(self, nchannels: int, ksize: int, dilation: int = 1):
        super().__init__()
        pad = (dilation * (ksize - 1) + 1) // 2
        self.conv = nn.Conv1d(nchannels, nchannels, ksize, dilation=dilation,
                              padding=pad)
        self.norm = ChannelLayerNorm(nchannels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _on_kernel(x):
            conv = self.conv
            z = F.conv1d(x, conv.weight, None, conv.stride, conv.padding,
                         conv.dilation)
            return residual_epilogue_cuda(z, x, conv.bias, self.norm.weight,
                                          self.norm.bias, self.norm.eps)
        return self.norm(F.relu(self.conv(x)) + x)


class DilatedResidualSequence(nn.Module):
    def __init__(self, nchannels: int, ksize: int, nlayers: int = 2,
                 dilation_factor: int = 2):
        super().__init__()
        self.nlayers = nlayers
        for i in range(nlayers):
            setattr(self, f"seq_{i}", DilatedResidualLayer(
                nchannels, ksize, dilation_factor ** i))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.nlayers):
            x = getattr(self, f"seq_{i}")(x)
        return x


class EncoderBlock(nn.Module):
    """Residual stack -> (optional window-embedding gate) -> strided conv ->
    GroupNorm -> GLU.

    A float32 CUDA input with gradients off runs the strided convolution
    without its bias and the rest, bias add included, in the fused kernel K6
    (ops/block_epilogue.py); every other call runs the composition."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, residual_layers: int,
                 residual_dilation_factor: int,
                 use_window_embedding: bool = False):
        super().__init__()
        self.res = DilatedResidualSequence(in_channels, kernel_size,
                                           residual_layers,
                                           residual_dilation_factor)
        self.embed1 = (nn.Conv1d(2, in_channels, 1) if use_window_embedding
                       else None)
        self.conv1 = nn.Conv1d(in_channels, 2 * out_channels, kernel_size,
                               stride=stride, padding=kernel_size // 2)
        self.norm1 = GroupNorm(2, 2 * out_channels)

    def forward(self, x: torch.Tensor, window_embedding=None) -> torch.Tensor:
        x = self.res(x)
        if self.embed1 is not None:
            x = self.embed1(window_embedding[:, :, None]) * x
        conv, norm = self.conv1, self.norm1
        if not _on_kernel(x):
            return block_epilogue_plain(conv(x), norm.weight, norm.bias,
                                        norm.eps)
        z = F.conv1d(x, conv.weight, None, conv.stride, conv.padding)
        epilogue = (block_epilogue_cuda if z.shape[-1] > 1
                    else block_epilogue_plain)
        return epilogue(z, norm.weight, norm.bias, norm.eps, bias=conv.bias)


class DecoderBlock(nn.Module):
    """skip-add -> ConvTranspose upsample -> (optional gate) -> GroupNorm ->
    GLU -> residual stack.

    The gate, GroupNorm and GLU run in the fused kernel K6
    (ops/block_epilogue.py) on a float32 CUDA input with gradients off, and
    as the composition on every other."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 kernel_size: int, residual_layers: int,
                 residual_dilation_factor: int,
                 use_window_embedding: bool = False):
        super().__init__()
        self.upsample_conv = GemmConvTranspose1d(in_channels, 2 * out_channels,
                                                 stride, stride=stride)
        self.embed1 = (nn.Conv1d(2, 2 * out_channels, 1)
                       if use_window_embedding else None)
        self.norm1 = GroupNorm(2, 2 * out_channels)
        self.res = DilatedResidualSequence(out_channels, kernel_size,
                                           residual_layers,
                                           residual_dilation_factor)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                window_embedding=None) -> torch.Tensor:
        x = self.upsample_conv(x + skip)
        gate = (None if self.embed1 is None
                else self.embed1(window_embedding[:, :, None])[:, :, 0])
        epilogue = (block_epilogue_cuda if _on_kernel(x) and x.shape[-1] > 1
                    else block_epilogue_plain)
        norm = self.norm1
        return self.res(epilogue(x, norm.weight, norm.bias, norm.eps,
                                 gate=gate))


def encoder_channel_plan(in_channels: int, channels: int, growth: float,
                         depth: int) -> list[tuple[int, int]]:
    """(in, out) channel pairs per encoder block."""
    plan = []
    c_in, c_out = in_channels, channels
    for _ in range(depth):
        plan.append((c_in, c_out))
        c_in = c_out
        c_out = int(growth * c_out)
    return plan


def decoder_channel_plan(in_channels: int, channels: int, growth: float,
                         depth: int) -> list[tuple[int, int]]:
    """(in, out) pairs for decoder blocks, in application (top-down) order."""
    plan = []
    c_in, c_out = in_channels, channels
    for _ in range(depth):
        plan.append((c_out, c_in))
        c_in = c_out
        c_out = int(growth * c_out)
    return plan[::-1]
