# Frozen copy of acousticswarms_speech_tpu_torch/models/conformer.py at commit 300ffdc,
# part of the benchmark's plain reference: it imports nothing of the port.
"""Conformer layer with Transformer-XL relative-position attention
(JAX: models/conformer.py).

    x = x + 0.5 * FFN(LN(x))
    x = x + RelPosMHSA(LN(x))
    x = x + ConvModule(LN(x))   # pointwise->GLU->depthwise(k)->LN->SiLU->pointwise
    x = LN(x + 0.5 * FFN(LN(x)))

Score: (q + u)·k^T + rel_shift((q + v)·r^T), with a learned projection of
sinusoidal relative-position encodings and per-head biases u, v.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .modules import LayerNorm, Linear, attention, glu


def rel_pos_encoding(T: int, d_model: int) -> np.ndarray:
    """(2T-1, d_model) sinusoidal encodings; row r encodes relative position
    T-1-r.  Built in float64 on the host, as the JAX package does."""
    pos = np.arange(T - 1, -T, -1, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                 * -(math.log(10000.0) / d_model))
    pe = np.zeros((2 * T - 1, d_model))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe.astype(np.float32)


class RelPosMHAXL(nn.Module):
    """Multi-head self-attention with Transformer-XL relative positions on
    (B, T, E)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        hd = embed_dim // num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.linear_pos_weight = nn.Parameter(torch.empty(embed_dim, embed_dim))
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, hd))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, hd))
        self.out_proj = Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.xavier_uniform_(self.linear_pos_weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        E, H = self.embed_dim, self.num_heads
        hd = E // H
        B, T, _ = x.shape
        qkv = F.linear(x, self.in_proj_weight) + self.in_proj_bias
        q, k, v = qkv.chunk(3, dim=-1)
        q = q.reshape(B, T, H, hd)
        k = k.reshape(B, T, H, hd).transpose(1, 2)
        v = v.reshape(B, T, H, hd).transpose(1, 2)

        # the table in the weights' dtype; the scores in float32
        pe = torch.from_numpy(rel_pos_encoding(T, E)).to(
            x.device, self.linear_pos_weight.dtype)
        r = F.linear(pe, self.linear_pos_weight).reshape(2 * T - 1, H, hd)
        q_u = (q + self.pos_bias_u).transpose(1, 2)  # (B, H, T, hd)
        q_v = (q + self.pos_bias_v).transpose(1, 2)

        bd_full = torch.einsum("bhqd,rhd->bhqr", q_v.float(),
                               r.float())  # (B, H, T, 2T-1)
        # bd[..., i, j] = bd_full[..., i, (T-1) - i + j], by the pad-and-
        # reshape skew of Transformer-XL
        bd = F.pad(bd_full, (1, 0)).reshape(B, H, T * 2 * T)[:, :, T:] \
            .reshape(B, H, T, 2 * T - 1)[:, :, :, :T]
        out = attention(q_u, k, v, scores=bd).transpose(1, 2).reshape(B, T, E)
        return self.out_proj(out)


class ConformerFFN(nn.Module):
    def __init__(self, d_model: int, d_ffn: int):
        super().__init__()
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.silu(self.linear1(x)))


class ConformerConvModule(nn.Module):
    def __init__(self, d_model: int, kernel_size: int):
        super().__init__()
        self.pointwise1 = nn.Conv1d(d_model, 2 * d_model, 1)
        self.depthwise = nn.Conv1d(d_model, d_model, kernel_size,
                                   padding=(kernel_size - 1) // 2,
                                   groups=d_model)
        self.norm = LayerNorm(d_model)
        self.pointwise2 = nn.Conv1d(d_model, d_model, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, C)."""
        x = glu(self.pointwise1(x.transpose(1, 2)), dim=1)
        x = self.depthwise(x).transpose(1, 2)
        x = F.silu(self.norm(x))
        return self.pointwise2(x.transpose(1, 2)).transpose(1, 2)


class ConformerLayer(nn.Module):
    """One speechbrain-style ConformerEncoder(num_layers=1) block: the
    layer's own final norm and then the encoder-level norm (eps 1e-6)."""

    def __init__(self, d_model: int, d_ffn: int, num_heads: int,
                 kernel_size: int, encoder_norm: bool = True):
        super().__init__()
        self.norm_ffn1 = LayerNorm(d_model)
        self.ffn1 = ConformerFFN(d_model, d_ffn)
        self.norm_mhsa = LayerNorm(d_model)
        self.mhsa = RelPosMHAXL(d_model, num_heads)
        self.norm_conv = LayerNorm(d_model)
        self.conv = ConformerConvModule(d_model, kernel_size)
        self.norm_ffn2 = LayerNorm(d_model)
        self.ffn2 = ConformerFFN(d_model, d_ffn)
        self.norm_final = LayerNorm(d_model)
        self.norm_enc = LayerNorm(d_model, eps=1e-6) if encoder_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + 0.5 * self.ffn1(self.norm_ffn1(x))
        x = x + self.mhsa(self.norm_mhsa(x))
        x = x + self.conv(self.norm_conv(x))
        x = x + 0.5 * self.ffn2(self.norm_ffn2(x))
        x = self.norm_final(x)
        if self.norm_enc is not None:
            x = self.norm_enc(x)
        return x
