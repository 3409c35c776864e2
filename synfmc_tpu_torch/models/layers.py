"""Foundational layers shared by the UNet, VAE and pose encoder.

Activations are channel-last (NHWC) tensors with frames folded into the
batch axis, as in the JAX package.  A convolution reads its NHWC input
through a permuted view, which is an NCHW tensor in ``channels_last`` memory
order, so cuDNN runs it channels-last and the output permutes back to NHWC
without a copy.  Parameter names follow the diffusers/reference names.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from synfmc_tpu_torch.ops.norms import group_norm, layer_norm


def timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers ``Timesteps`` with
    flip_sin_to_cos, freq_shift 0, max period 1e4): (B,) -> (B, dim) fp32 [cos, sin]."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                 device=timesteps.device)
    args = timesteps.float()[:, None] * torch.exp(exponent / half)[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def sinusoidal_positional_encoding(max_len: int, d_model: int) -> torch.Tensor:
    """Fixed temporal PE table: pe[p, 2i] = sin, pe[p, 2i+1] = cos.  (max_len, d_model) fp32."""
    if d_model % 2:
        raise ValueError("temporal PE requires even d_model")
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                         * (-math.log(10000.0) / d_model))
    pe = torch.zeros(max_len, d_model)
    pe[:, 0::2] = torch.sin(position * div_term[None, :])
    pe[:, 1::2] = torch.cos(position * div_term[None, :])
    return pe


class TimestepEmbedding(nn.Module):
    """linear_1 -> silu -> linear_2."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample):
        return self.linear_2(F.silu(self.linear_1(sample)))


class GroupNorm(nn.Module):
    """GroupNorm over NHWC (or (N, S, C)) with an optional fused activation."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5,
                 act: Optional[str] = None):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.num_groups, eps=self.eps, act=self.act)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics."""

    def __init__(self, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, eps=self.eps)


class Conv2d(nn.Conv2d):
    """nn.Conv2d on NHWC tensors (a channels-last view in, NHWC view out)."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def conv3x3(cin: int, cout: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, 3, stride=stride, padding=1)


class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D: norm1+silu -> conv1 -> (+time proj) -> norm2+silu
    -> conv2 -> + shortcut."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: Optional[int] = None,
                 eps: float = 1e-6, groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, groups, eps, act="silu")
        self.conv1 = conv3x3(in_channels, out_channels)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels) if temb_channels else None
        self.norm2 = GroupNorm(out_channels, groups, eps, act="silu")
        self.conv2 = conv3x3(out_channels, out_channels)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None:
            if temb is None:
                raise ValueError("ResnetBlock2D configured with a time embedding")
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Strided 3x3 conv downsample."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = conv3x3(channels, out_channels, stride=2)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest x2 + 3x3 conv."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = conv3x3(channels, out_channels)

    def forward(self, x):
        x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        return self.conv(x.permute(0, 2, 3, 1))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact (erf) GELU


class FeedForward(nn.Module):
    """GEGLU feed-forward: net.0 = GEGLU, net.1 = dropout (inert), net.2 = Linear."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Dropout(0.0), nn.Linear(inner, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x
