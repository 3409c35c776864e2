"""AutoencoderKL (SD1.5 VAE), NHWC, diffusers names.

block_out_channels (128, 256, 512, 512), 2 resnets per encoder level and 3
per decoder level, GN(32, eps 1e-6), single-head mid-block attention,
quant/post_quant 1x1 convs, scaling factor 0.18215.  Serving uses
``decode``; training encodes each frame to a sampled latent with ``encode``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from synfmc_tpu_torch.models.layers import (
    Conv2d,
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    Upsample2D,
    conv3x3,
)
from synfmc_tpu_torch.ops.attention import dot_product_attention

SD_VAE_SCALING = 0.18215
LATENT_CHANNELS = 4


class VAEAttention(nn.Module):
    """Single-head mid-block attention: GN -> qkv (bias) -> attn -> proj -> + residual."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm(channels, 32, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        n, h, w, c = x.shape
        y = self.group_norm(x).reshape(n, h * w, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        out = dot_product_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                                    scale=c ** -0.5)[:, :, 0]
        return self.to_out[0](out).reshape(n, h, w, c) + x


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(channels, channels) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Level(nn.Module):
    def __init__(self, cin: int, ch: int, num_layers: int, resample: Optional[str]):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(cin if j == 0 else ch, ch)
                                      for j in range(num_layers)])
        if resample == "down":
            self.downsamplers = nn.ModuleList([Downsample2D(ch, ch)])
        elif resample == "up":
            self.upsamplers = nn.ModuleList([Upsample2D(ch, ch)])
        self.resample = resample

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.resample == "down":
            x = self.downsamplers[0](x)
        elif self.resample == "up":
            x = self.upsamplers[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512)):
        super().__init__()
        chs = list(block_out_channels)
        self.conv_in = conv3x3(3, chs[0])
        ins = [chs[0]] + chs[:-1]
        self.down_blocks = nn.ModuleList([
            _Level(ins[i], ch, 2, "down" if i != len(chs) - 1 else None)
            for i, ch in enumerate(chs)])
        self.mid_block = VAEMidBlock(chs[-1])
        self.conv_norm_out = GroupNorm(chs[-1], 32, eps=1e-6, act="silu")
        self.conv_out = conv3x3(chs[-1], 2 * LATENT_CHANNELS)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        return self.conv_out(self.conv_norm_out(self.mid_block(x)))


class Decoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512)):
        super().__init__()
        rev = list(reversed(block_out_channels))
        self.conv_in = conv3x3(LATENT_CHANNELS, rev[0])
        self.mid_block = VAEMidBlock(rev[0])
        ins = [rev[0]] + rev[:-1]
        self.up_blocks = nn.ModuleList([
            _Level(ins[i], ch, 3, "up" if i != len(rev) - 1 else None)
            for i, ch in enumerate(rev)])
        self.conv_norm_out = GroupNorm(rev[-1], 32, eps=1e-6, act="silu")
        self.conv_out = conv3x3(rev[-1], 3)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512)):
        super().__init__()
        self.encoder = Encoder(block_out_channels)
        self.decoder = Decoder(block_out_channels)
        self.quant_conv = Conv2d(2 * LATENT_CHANNELS, 2 * LATENT_CHANNELS, 1)
        self.post_quant_conv = Conv2d(LATENT_CHANNELS, LATENT_CHANNELS, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.post_quant_conv.weight.dtype

    def encode_moments(self, x):
        """(N, H, W, 3) in [-1, 1] -> (mean, logvar), each (N, H/8, W/8, 4)."""
        mean, logvar = self.quant_conv(self.encoder(x.to(self.dtype))).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x, eps: Optional[torch.Tensor] = None):
        """(N, H, W, 3) in [-1, 1] -> (N, H/8, W/8, 4) latents times the scaling
        factor: the sampled latent mean + exp(logvar / 2) * eps when ``eps``
        (a standard-normal draw of the latent's shape) is given, else the mean."""
        mean, logvar = self.encode_moments(x)
        if eps is not None:
            mean = mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)
        return mean * SD_VAE_SCALING

    def decode(self, z):
        """(N, h, w, 4) scaled latents -> (N, 8h, 8w, 3); divides the scaling factor."""
        return self.decoder(self.post_quant_conv((z / SD_VAE_SCALING).to(self.dtype)))
