"""CMC camera encoder: Plücker video -> 4 multi-scale pose feature maps.

PixelUnshuffle(8) -> conv_in -> 4 stages of [AdapterResnetBlock + temporal
attention] x nums_rb, with 2x2 average-pool downsampling between stages.
NHWC video in and out; frames folded into the batch for convs, (b*h*w, f, c)
tokens for the temporal attention.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from synfmc_tpu_torch.models.layers import Conv2d, conv3x3
from synfmc_tpu_torch.models.motion_module import TemporalTransformerBlock
from synfmc_tpu_torch.ops.pixel import pixel_unshuffle


class AdapterResnetBlock(nn.Module):
    """down (avg-pool 2x2) -> in_conv (only when channels change) ->
    block1(3x3) -> ReLU -> block2(ksize) -> + residual."""

    def __init__(self, in_channels: int, out_channels: int, down: bool = False, ksize: int = 3):
        super().__init__()
        self.down = down
        p = ksize // 2
        self.in_conv = (Conv2d(in_channels, out_channels, ksize, padding=p)
                        if in_channels != out_channels else None)
        self.block1 = conv3x3(out_channels, out_channels)
        self.block2 = Conv2d(out_channels, out_channels, ksize, padding=p)

    def forward(self, x):
        if self.down:
            x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        if self.in_conv is not None:
            x = self.in_conv(x)
        return self.block2(torch.relu(self.block1(x))) + x


class CameraPoseEncoder(nn.Module):
    """Plücker (B, F, H, W, 6) -> list of 4 (B, F, H/8/2^i, W/8/2^i, C_i)."""

    def __init__(self, downscale_factor: int = 8,
                 channels: Sequence[int] = (320, 640, 1280, 1280), nums_rb: int = 2,
                 ksize: int = 1, temporal_attention_nhead: int = 8,
                 temporal_pe_max_len: int = 16):
        super().__init__()
        self.downscale_factor = downscale_factor
        chs = list(channels)
        self.encoder_conv_in = conv3x3(6 * downscale_factor ** 2, chs[0])  # Plücker: 6 channels
        self.encoder_down_conv_blocks = nn.ModuleList()
        self.encoder_down_attention_blocks = nn.ModuleList()
        prev = chs[0]
        for i, ch in enumerate(chs):
            convs, attns = nn.ModuleList(), nn.ModuleList()
            for j in range(nums_rb):
                convs.append(AdapterResnetBlock(prev, ch, down=(j == 0 and i != 0), ksize=ksize))
                attns.append(TemporalTransformerBlock(
                    ch, temporal_attention_nhead, ch // temporal_attention_nhead,
                    num_attention_blocks=1, temporal_pe_max_len=temporal_pe_max_len))
                prev = ch
            self.encoder_down_conv_blocks.append(convs)
            self.encoder_down_attention_blocks.append(attns)

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder_conv_in.weight.dtype

    def forward(self, plucker) -> list[torch.Tensor]:
        b, f, h, w, c = plucker.shape
        x = pixel_unshuffle(plucker.to(self.dtype).reshape(b * f, h, w, c), self.downscale_factor)
        x = self.encoder_conv_in(x)
        features = []
        for convs, attns in zip(self.encoder_down_conv_blocks, self.encoder_down_attention_blocks):
            for conv, attn in zip(convs, attns):
                x = conv(x)
                _, hh, ww, cc = x.shape
                tokens = x.reshape(b, f, hh, ww, cc).permute(0, 2, 3, 1, 4).reshape(b * hh * ww, f, cc)
                tokens = attn(tokens)
                x = tokens.reshape(b, hh, ww, f, cc).permute(0, 3, 1, 2, 4).reshape(b * f, hh, ww, cc)
            features.append(x.reshape(b, f, *x.shape[1:]))
        return features
