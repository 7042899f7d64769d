"""Speaker separation network, SepNet (JAX: models/separation.py).

Per-speaker shifted copies of the M-channel mixture go through a shared
U-Net encoder (speakers folded into the batch axis), a bottleneck that
alternates an intra-speaker Conformer over time with inter-speaker attention
across the speaker axis, a shared decoder, and a learned-basis masking head
against the reference channel.  Speakers beyond `num_speakers` are masked
out of the inter-speaker attention and zeroed in the output.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .common import run_block
from .conformer import ConformerLayer
from .modules import (
    DecoderBlock,
    EncoderBlock,
    decoder_channel_plan,
    encoder_channel_plan,
    transformer_layer,
)


class SepNet(nn.Module):
    def __init__(self, n_mics: int = 7, max_speakers: int = 6,
                 kernel_size: int = 5, stride_list: Sequence[int] = (2, 2, 4, 4),
                 channels: int = 64, growth: float = 2.0,
                 encoder_channels: int = 4096, encoder_kernel_size: int = 33,
                 encoder_stride: int = 16, residual_layers: int = 3,
                 residual_dilation_factor: int = 2, num_head: int = 8,
                 ffw_dim: int = 1024, bottleneck_layers: int = 3,
                 bottleneck_ksize: int = 31, remat: bool = False):
        """`remat`: recompute the activations of the U-Net blocks and the
        bottleneck layers in the backward pass (training memory), as the
        JAX package's `remat` does."""
        super().__init__()
        self.n_mics = n_mics
        self.remat = remat
        self.max_speakers = max_speakers
        self.stride_list = tuple(stride_list)
        self.stride_product = math.prod(self.stride_list)
        depth = len(self.stride_list)
        self.depth = depth
        self.bottleneck_layers = bottleneck_layers

        self.preproc = nn.Conv1d(n_mics, channels, 1)
        enc_plan = encoder_channel_plan(channels, channels, growth, depth)
        for i, (c_in, c_out) in enumerate(enc_plan):
            setattr(self, f"encoder_{i}", EncoderBlock(
                c_in, c_out, kernel_size, self.stride_list[i], residual_layers,
                residual_dilation_factor))
        C = enc_plan[-1][1]
        for l in range(bottleneck_layers):
            setattr(self, f"bottleneck_{l}_intra", ConformerLayer(
                C, ffw_dim, num_head, bottleneck_ksize))
            setattr(self, f"bottleneck_{l}_inter", transformer_layer(
                C, num_head, ffw_dim))
        dec_plan = decoder_channel_plan(channels, channels, growth, depth)
        for i, (c_in, c_out) in enumerate(dec_plan):
            setattr(self, f"decoder_{i}", DecoderBlock(
                c_in, c_out, self.stride_list[depth - 1 - i], kernel_size,
                residual_layers, residual_dilation_factor))
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
                num_speakers: torch.Tensor) -> torch.Tensor:
        """mix: (B, S*M, T) normalized; num_speakers: (B,) int.
        Returns (B, max(S, max_speakers), T) with absent speakers zeroed."""
        B, SM, input_length = mix.shape
        S = SM // self.n_mics
        sp = self.stride_product
        T = ((input_length - 1) // sp + 1) * sp
        mix = F.pad(mix, (T - input_length, 0))
        ref = mix[:, 0:1]  # reference channel of speaker 0
        spk_valid = (torch.arange(S, device=mix.device)[None, :]
                     < num_speakers.to(mix.device)[:, None])  # (B, S)

        x = self.preproc(mix.reshape(B * S, self.n_mics, T))
        skips = [x]
        for i in range(self.depth):
            x = run_block(self.remat, getattr(self, f"encoder_{i}"), x)
            skips.append(x)

        C, Tb = x.shape[1], x.shape[2]
        pad_mask = ~spk_valid.repeat_interleave(Tb, dim=0)  # (B*Tb, S)
        for l in range(self.bottleneck_layers):
            # intra: a Conformer over time for each speaker
            x = run_block(self.remat, getattr(self, f"bottleneck_{l}_intra"),
                          x.transpose(1, 2)).transpose(1, 2)
            # inter: attention across the speaker axis at each time step
            y = x.reshape(B, S, C, Tb).permute(0, 3, 1, 2).reshape(B * Tb, S, C)
            y = run_block(self.remat, getattr(self, f"bottleneck_{l}_inter"),
                          y, src_key_padding_mask=pad_mask)
            x = y.reshape(B, Tb, S, C).permute(0, 2, 3, 1).reshape(B * S, C, Tb)

        for i in range(self.depth):
            x = run_block(self.remat, getattr(self, f"decoder_{i}"), x,
                          skips[-(i + 1)])

        y = F.relu(self.reference_bypass(ref))  # (B, F, T/16)
        mask = F.relu(self.mask_encoder(x))     # (B*S, F, T/16)
        Fc, Tl = y.shape[1], y.shape[2]
        masked = (y[:, None] * mask.reshape(B, S, Fc, Tl)).reshape(B * S, Fc, Tl)
        out = self.output_decoder(masked).reshape(B, S, -1)[..., 9:-8]
        out = out[..., -input_length:]
        if S < self.max_speakers:
            out = F.pad(out, (0, 0, 0, self.max_speakers - S))
            spk_valid = F.pad(spk_valid, (0, self.max_speakers - S))
        return out * spk_valid[:, :, None]
