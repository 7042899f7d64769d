"""U-Net building blocks shared by SpotNet and SepNet (JAX: models/modules.py).

Attribute names follow the JAX package's parameter tree, so a flax tree
flattened with "." is this module tree's `state_dict` (models/weights.py).
All blocks take channel-first (B, C, T) activations.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class ChannelLayerNorm(nn.Module):
    """LayerNorm over C of a (B, C, T) tensor, without transposing."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=1, correction=0, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + self.eps) \
            * self.weight.float()[None, :, None] + self.bias.float()[None, :, None]
        return out.to(x.dtype)


def glu(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


class TransformerEncoder(nn.Module):
    """Stack of post-norm ReLU encoder layers on (B, T, E)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layers_{i}", transformer_layer(
                d_model, nhead, dim_feedforward))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
        return x


def transformer_layer(d_model: int, nhead: int,
                      dim_feedforward: int) -> nn.TransformerEncoderLayer:
    """The JAX TransformerEncoderLayer: post-norm, ReLU, no dropout."""
    return nn.TransformerEncoderLayer(
        d_model, nhead, dim_feedforward, dropout=0.0, activation="relu",
        batch_first=True, norm_first=False)


class DilatedResidualLayer(nn.Module):
    """Conv -> ReLU(+residual) -> LayerNorm over channels."""

    def __init__(self, nchannels: int, ksize: int, dilation: int = 1):
        super().__init__()
        pad = (dilation * (ksize - 1) + 1) // 2
        self.conv = nn.Conv1d(nchannels, nchannels, ksize, dilation=dilation,
                              padding=pad)
        self.norm = ChannelLayerNorm(nchannels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
    GroupNorm -> GLU."""

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
        self.norm1 = nn.GroupNorm(2, 2 * out_channels)

    def forward(self, x: torch.Tensor, window_embedding=None) -> torch.Tensor:
        x = self.res(x)
        if self.embed1 is not None:
            x = self.embed1(window_embedding[:, :, None]) * x
        return glu(self.norm1(self.conv1(x)), dim=1)


class DecoderBlock(nn.Module):
    """skip-add -> ConvTranspose upsample -> (optional gate) -> GroupNorm ->
    GLU -> residual stack."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 kernel_size: int, residual_layers: int,
                 residual_dilation_factor: int,
                 use_window_embedding: bool = False):
        super().__init__()
        self.upsample_conv = nn.ConvTranspose1d(in_channels, 2 * out_channels,
                                                stride, stride=stride)
        self.embed1 = (nn.Conv1d(2, 2 * out_channels, 1)
                       if use_window_embedding else None)
        self.norm1 = nn.GroupNorm(2, 2 * out_channels)
        self.res = DilatedResidualSequence(out_channels, kernel_size,
                                           residual_layers,
                                           residual_dilation_factor)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                window_embedding=None) -> torch.Tensor:
        x = self.upsample_conv(x + skip)
        if self.embed1 is not None:
            x = self.embed1(window_embedding[:, :, None]) * x
        return self.res(glu(self.norm1(x), dim=1))


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
