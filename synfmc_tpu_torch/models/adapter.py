"""OMC object-pose encoder (the reference's ``Adapter``).

PixelUnshuffle(8) on the 13-channel masked-pose raster -> 1x1 zero conv in
-> 3x3 conv_in -> 4 stages of ``nums_rb`` AdapterResnetBlocks (2x2 average
pool on the first block of stages 1-3) -> a 1x1 zero conv out per stage ->
multiply by the mask, nearest-resized to the stage.  Channel-last
(N, H, W, C) with frames folded into the batch; callers reshape the four
feature maps back to video (``utils.traj_features.traj_features_from_adapter``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from synfmc_tpu_torch.models.layers import Conv2d, conv3x3
from synfmc_tpu_torch.models.pose_encoder import AdapterResnetBlock
from synfmc_tpu_torch.ops.pixel import nearest_resize, pixel_unshuffle

RASTER_CHANNELS = 13  # 12 pose values and the mask
DOWNSCALE = 8  # the latents' factor: obj.yaml's cin 832 = 13 * 8 * 8
KSIZE = 3


class ObjectAdapter(nn.Module):
    """(N, H, W, 13) raster and (N, H, W, 1) mask -> 4 (N, H/8/2^i, W/8/2^i, C_i)."""

    def __init__(self, channels: Sequence[int] = (320, 640, 1280, 1280), nums_rb: int = 2,
                 use_pre_zero_conv: bool = True, use_post_zero_conv: bool = True):
        super().__init__()
        chs = list(channels)
        cin = RASTER_CHANNELS * DOWNSCALE ** 2
        self.zero_conv_in = Conv2d(cin, cin, 1) if use_pre_zero_conv else None
        self.conv_in = conv3x3(cin, chs[0])
        body, prev = [], chs[0]
        for i, ch in enumerate(chs):
            for j in range(nums_rb):
                body.append(AdapterResnetBlock(prev, ch, down=(i != 0 and j == 0), ksize=KSIZE))
                prev = ch
        self.body = nn.ModuleList(body)
        self.nums_rb = nums_rb
        self.zero_conv_out_list = (nn.ModuleList([Conv2d(ch, ch, 1) for ch in chs])
                                   if use_post_zero_conv else None)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> list[torch.Tensor]:
        x = pixel_unshuffle(x.to(self.dtype), DOWNSCALE)
        if self.zero_conv_in is not None:
            x = self.zero_conv_in(x)
        x = self.conv_in(x)
        features = []
        n_stages = len(self.body) // self.nums_rb
        for i in range(n_stages):
            for block in self.body[i * self.nums_rb:(i + 1) * self.nums_rb]:
                x = block(x)
            if self.zero_conv_out_list is not None:
                x = self.zero_conv_out_list[i](x)
            if mask is not None:
                x = x * nearest_resize(mask, x.shape[1], x.shape[2]).to(x.dtype)
            features.append(x)
        return features
