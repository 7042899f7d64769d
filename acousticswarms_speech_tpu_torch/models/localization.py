"""Spotforming network, SpotNet (JAX: models/localization.py).

A 1-D U-Net (encoder/decoder blocks with dilated residual stacks and GLU), a
Transformer bottleneck at T/256, a 2-dim one-hot window embedding gating
every block, and a learned-basis masking head against the reference channel.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .common import run_block
from .modules import (
    DecoderBlock,
    EncoderBlock,
    TransformerEncoder,
    decoder_channel_plan,
    encoder_channel_plan,
)


class SpotNet(nn.Module):
    def __init__(self, n_mics: int = 7, kernel_size: int = 7,
                 stride_list: Sequence[int] = (2, 2, 4, 4, 4),
                 channels: int = 64, growth: float = 2.0,
                 encoder_channels: int = 2048, encoder_kernel_size: int = 33,
                 encoder_stride: int = 16, residual_layers: int = 3,
                 residual_dilation_factor: int = 7, num_head: int = 8,
                 ffw_dim: int = 1024, num_transformer_layers: int = 2,
                 remat: bool = False):
        """`remat`: recompute the U-Net blocks' activations in the backward
        pass (training memory), as the JAX package's `remat` does."""
        super().__init__()
        self.n_mics = n_mics
        self.remat = remat
        self.stride_list = tuple(stride_list)
        self.stride_product = math.prod(self.stride_list)
        depth = len(self.stride_list)
        self.depth = depth

        self.preproc = nn.Conv1d(n_mics, channels, 1)
        enc_plan = encoder_channel_plan(channels, channels, growth, depth)
        for i, (c_in, c_out) in enumerate(enc_plan):
            setattr(self, f"encoder_{i}", EncoderBlock(
                c_in, c_out, kernel_size, self.stride_list[i], residual_layers,
                residual_dilation_factor, use_window_embedding=True))
        self.bottleneck = TransformerEncoder(enc_plan[-1][1], num_head,
                                             ffw_dim, num_transformer_layers)
        dec_plan = decoder_channel_plan(channels, channels, growth, depth)
        for i, (c_in, c_out) in enumerate(dec_plan):
            setattr(self, f"decoder_{i}", DecoderBlock(
                c_in, c_out, self.stride_list[depth - 1 - i], kernel_size,
                residual_layers, residual_dilation_factor,
                use_window_embedding=True))
        pad = encoder_kernel_size // 2
        self.reference_bypass = nn.Conv1d(1, encoder_channels,
                                          encoder_kernel_size,
                                          stride=encoder_stride, padding=pad)
        self.mask_encoder = nn.Conv1d(channels, encoder_channels,
                                      encoder_kernel_size,
                                      stride=encoder_stride, padding=pad)
        self.output_decoder = nn.ConvTranspose1d(
            encoder_channels, 1, encoder_kernel_size,
            stride=encoder_kernel_size // 2)

    def forward(self, mix: torch.Tensor,
                window_embedding: torch.Tensor) -> torch.Tensor:
        """mix: (B, M, T) normalized input; window_embedding: (B, 2).
        Returns (B, 1, T)."""
        input_length = mix.shape[-1]
        sp = self.stride_product
        T = ((input_length - 1) // sp + 1) * sp
        mix = F.pad(mix, (T - input_length, 0))  # left pad to a multiple
        ref = mix[:, 0:1]

        x = self.preproc(mix)
        skips = [x]
        for i in range(self.depth):
            x = run_block(self.remat, getattr(self, f"encoder_{i}"), x,
                          window_embedding)
            skips.append(x)
        x = self.bottleneck(x.transpose(1, 2)).transpose(1, 2)
        for i in range(self.depth):
            x = run_block(self.remat, getattr(self, f"decoder_{i}"), x,
                          skips[-(i + 1)], window_embedding)

        y = F.relu(self.reference_bypass(ref))
        mask = F.relu(self.mask_encoder(x))
        out = self.output_decoder(y * mask)
        out = out[..., 9:-8]  # trim transposed-conv edge samples
        return out[..., -input_length:]
