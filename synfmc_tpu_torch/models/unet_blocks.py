"""3D UNet blocks (NHWC video, frames folded into the batch for spatial ops).

Per layer: ResnetBlock2D -> SpatialTransformer (cross-attention blocks) ->
motion module, the reference op order.  Traj features are residuals added to
a down block's output before its downsample.  The time embedding and the
text context are repeated frame-major (``repeat_interleave``), as the JAX
package's ``jnp.repeat(..., f, axis=0)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from synfmc_tpu_torch.models.attention import SpatialTransformer
from synfmc_tpu_torch.models.layers import Downsample2D, ResnetBlock2D, Upsample2D
from synfmc_tpu_torch.models.motion_module import VanillaTemporalModule


def fold(x):
    """(b, f, h, w, c) -> (b*f, h, w, c)"""
    b, f, h, w, c = x.shape
    return x.reshape(b * f, h, w, c)


def unfold(x, f: int):
    n, h, w, c = x.shape
    return x.reshape(n // f, f, h, w, c)


def _motion(channels: int, motion: Optional[dict]):
    return VanillaTemporalModule(channels, **motion) if motion is not None else None


def _spatial(ch, attn_heads, cross_attention_dim, lora_rank, lora_scale):
    return SpatialTransformer(ch, attn_heads, ch // attn_heads,
                              cross_attention_dim=cross_attention_dim,
                              lora_rank=lora_rank, lora_scale=lora_scale)


class CrossAttnDownBlock3D(nn.Module):
    """``motion`` is the motion-module kwargs, or None for no motion modules."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 num_layers: int = 2, attn_heads: int = 8, cross_attention_dim: int = 768,
                 add_downsample: bool = True, motion: Optional[dict] = None,
                 lora_rank: int = 0, lora_scale: float = 1.0):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels, temb_channels)
            for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            _spatial(out_channels, attn_heads, cross_attention_dim, lora_rank, lora_scale)
            for _ in range(num_layers)])
        self.motion_modules = nn.ModuleList(
            [_motion(out_channels, motion) for _ in range(num_layers)]) if motion else None
        self.downsamplers = nn.ModuleList(
            [Downsample2D(out_channels, out_channels)]) if add_downsample else None

    def forward(self, x, temb_rep, ctx_rep, pose_feature=None, traj_feature=None,
                run_downsample: bool = True):
        """``run_downsample=False`` (DeepCache's shallow step) skips the
        downsampler, whose output feeds only the deeper levels."""
        f = x.shape[1]
        outputs = []
        for i, (res, attn) in enumerate(zip(self.resnets, self.attentions)):
            x = unfold(attn(res(fold(x), temb_rep), ctx_rep), f)
            if self.motion_modules is not None:
                x = self.motion_modules[i](x, pose_feature=pose_feature)
            outputs.append(x)
        if traj_feature is not None:
            x = x + traj_feature.to(x.dtype)
            outputs[-1] = x
        if self.downsamplers is not None and run_downsample:
            x = unfold(self.downsamplers[0](fold(x)), f)
            outputs.append(x)
        return x, outputs


class DownBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 num_layers: int = 2, add_downsample: bool = False,
                 motion: Optional[dict] = None):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels, temb_channels)
            for i in range(num_layers)])
        self.motion_modules = nn.ModuleList(
            [_motion(out_channels, motion) for _ in range(num_layers)]) if motion else None
        self.downsamplers = nn.ModuleList(
            [Downsample2D(out_channels, out_channels)]) if add_downsample else None

    def forward(self, x, temb_rep, pose_feature=None):
        """Takes no traj feature: the reference's plain 4th block never adds one."""
        f = x.shape[1]
        outputs = []
        for i, res in enumerate(self.resnets):
            x = unfold(res(fold(x), temb_rep), f)
            if self.motion_modules is not None:
                x = self.motion_modules[i](x, pose_feature=pose_feature)
            outputs.append(x)
        if self.downsamplers is not None:
            x = unfold(self.downsamplers[0](fold(x)), f)
            outputs.append(x)
        return x, outputs


class UNetMidBlock3DCrossAttn(nn.Module):
    def __init__(self, channels: int, temb_channels: int, attn_heads: int = 8,
                 cross_attention_dim: int = 768, motion: Optional[dict] = None,
                 lora_rank: int = 0, lora_scale: float = 1.0):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, temb_channels) for _ in range(2)])
        self.attentions = nn.ModuleList([
            _spatial(channels, attn_heads, cross_attention_dim, lora_rank, lora_scale)])
        self.motion_modules = nn.ModuleList([_motion(channels, motion)]) if motion else None

    def forward(self, x, temb_rep, ctx_rep, pose_feature=None):
        f = x.shape[1]
        x = unfold(self.resnets[0](fold(x), temb_rep), f)
        x = unfold(self.attentions[0](fold(x), ctx_rep), f)
        if self.motion_modules is not None:
            x = self.motion_modules[0](x, pose_feature=pose_feature)
        return unfold(self.resnets[1](fold(x), temb_rep), f)


class CrossAttnUpBlock3D(nn.Module):
    """``skip_channels``: channels of the skips this block pops, in pop order."""

    def __init__(self, prev_channels: int, out_channels: int, skip_channels: Sequence[int],
                 temb_channels: int, attn_heads: int = 8, cross_attention_dim: int = 768,
                 add_upsample: bool = True, motion: Optional[dict] = None,
                 lora_rank: int = 0, lora_scale: float = 1.0):
        super().__init__()
        n = len(skip_channels)
        self.resnets = nn.ModuleList([
            ResnetBlock2D((prev_channels if i == 0 else out_channels) + skip_channels[i],
                          out_channels, temb_channels)
            for i in range(n)])
        self.attentions = nn.ModuleList([
            _spatial(out_channels, attn_heads, cross_attention_dim, lora_rank, lora_scale)
            for _ in range(n)])
        self.motion_modules = nn.ModuleList(
            [_motion(out_channels, motion) for _ in range(n)]) if motion else None
        self.upsamplers = nn.ModuleList(
            [Upsample2D(out_channels, out_channels)]) if add_upsample else None

    def forward(self, x, skips, temb_rep, ctx_rep, pose_feature=None):
        f = x.shape[1]
        for i, (res, attn) in enumerate(zip(self.resnets, self.attentions)):
            x = torch.cat([x, skips.pop()], dim=-1)
            x = unfold(attn(res(fold(x), temb_rep), ctx_rep), f)
            if self.motion_modules is not None:
                x = self.motion_modules[i](x, pose_feature=pose_feature)
        if self.upsamplers is not None:
            x = unfold(self.upsamplers[0](fold(x)), f)
        return x


class UpBlock3D(nn.Module):
    def __init__(self, prev_channels: int, out_channels: int, skip_channels: Sequence[int],
                 temb_channels: int, add_upsample: bool = True, motion: Optional[dict] = None):
        super().__init__()
        n = len(skip_channels)
        self.resnets = nn.ModuleList([
            ResnetBlock2D((prev_channels if i == 0 else out_channels) + skip_channels[i],
                          out_channels, temb_channels)
            for i in range(n)])
        self.motion_modules = nn.ModuleList(
            [_motion(out_channels, motion) for _ in range(n)]) if motion else None
        self.upsamplers = nn.ModuleList(
            [Upsample2D(out_channels, out_channels)]) if add_upsample else None

    def forward(self, x, skips, temb_rep, pose_feature=None):
        f = x.shape[1]
        for i, res in enumerate(self.resnets):
            x = torch.cat([x, skips.pop()], dim=-1)
            x = unfold(res(fold(x), temb_rep), f)
            if self.motion_modules is not None:
                x = self.motion_modules[i](x, pose_feature=pose_feature)
        if self.upsamplers is not None:
            x = unfold(self.upsamplers[0](fold(x)), f)
        return x
