"""The inflated 3D UNet with camera (pose) and object (traj) conditioning.

synfmc_tpu/models/unet3d.py:UNet3D, with DeepCache's shallow step, and the
SD1.5 constants: 4 latent channels, 2 layers per block, GroupNorm(32).
Quirk preserved: the plain 4th down block never receives traj features.  The decoder's motion modules take the pose features
too.  ``conv_norm_out`` uses eps 1e-5; resnet, transformer and motion GNs
use 1e-6.  Video layout (B, F, H, W, C).

Frame-parallel: ``set_frame_shard(axis)`` hands the mesh's ``sp`` axis to
the motion modules and nothing else (GroupNorm, convs and spatial attention
work frame by frame, so a rank's frames need no collective there); the
sample, traj features and skips then hold the rank's frames, the pose
features all frames.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
from torch import nn

from synfmc_tpu_torch.models.layers import GroupNorm, TimestepEmbedding, conv3x3, timestep_embedding
from synfmc_tpu_torch.models.motion_module import TemporalTransformer3D
from synfmc_tpu_torch.models.unet_blocks import (
    CrossAttnDownBlock3D,
    CrossAttnUpBlock3D,
    DownBlock3D,
    UNetMidBlock3DCrossAttn,
    UpBlock3D,
    fold,
    unfold,
)

LATENT_CHANNELS = 4
LAYERS_PER_BLOCK = 2


def lora_rank_for(hidden_size: int, lora_rank_cfg: int) -> int:
    """Reference rank rule: rank = cfg if cfg > 16 else hidden // cfg."""
    if lora_rank_cfg <= 0:
        return 0
    return lora_rank_cfg if lora_rank_cfg > 16 else hidden_size // lora_rank_cfg


class UNet3D(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
                 attn_heads: int = 8, cross_attention_dim: int = 768,
                 use_motion_module: bool = False,
                 motion_module_mid_block: bool = False,
                 motion_module_resolutions: Sequence[int] = (1, 2, 4, 8),
                 motion_num_heads: int = 8, motion_transformer_blocks: int = 1,
                 motion_attention_blocks: int = 2, motion_pe_max_len: int = 32,
                 motion_lora_rank: int = 0,
                 motion_lora_scale: float = 1.0, camera_cond: bool = False,
                 pose_cond_blocks: Sequence[int] = (0,), pose_scale: float = 1.0,
                 lora_rank: int = 0, lora_scale: float = 1.0):
        super().__init__()
        chs = list(block_out_channels)
        n = len(chs)
        self.block_out_channels = tuple(chs)
        temb_dim = chs[0] * 4
        pose_blocks = tuple(pose_cond_blocks) if camera_cond else ()

        def motion(res: Optional[int]):
            """Motion-module kwargs at resolution ``res`` (None: not gated by
            resolution), or None where there is no motion module."""
            if not use_motion_module or (res is not None and res not in tuple(motion_module_resolutions)):
                return None
            return dict(num_attention_heads=motion_num_heads,
                        num_transformer_blocks=motion_transformer_blocks,
                        num_attention_blocks=motion_attention_blocks,
                        temporal_pe_max_len=motion_pe_max_len,
                        pose_cond_blocks=pose_blocks,
                        pose_scale=pose_scale, lora_rank=motion_lora_rank,
                        lora_scale=motion_lora_scale)

        self.time_embedding = TimestepEmbedding(chs[0], temb_dim)
        self.conv_in = conv3x3(LATENT_CHANNELS, chs[0])

        skip_chs = [chs[0]]
        self.down_blocks = nn.ModuleList()
        prev = chs[0]
        for i, ch in enumerate(chs):
            if i < n - 1:
                self.down_blocks.append(CrossAttnDownBlock3D(
                    prev, ch, temb_dim, LAYERS_PER_BLOCK, attn_heads, cross_attention_dim,
                    add_downsample=True, motion=motion(2 ** i),
                    lora_rank=lora_rank_for(ch, lora_rank), lora_scale=lora_scale))
                skip_chs += [ch] * (LAYERS_PER_BLOCK + 1)
            else:
                self.down_blocks.append(DownBlock3D(
                    prev, ch, temb_dim, LAYERS_PER_BLOCK, add_downsample=False,
                    motion=motion(2 ** i)))
                skip_chs += [ch] * LAYERS_PER_BLOCK
            prev = ch

        mid_motion = motion(None) if motion_module_mid_block else None
        self.mid_block = UNetMidBlock3DCrossAttn(
            chs[-1], temb_dim, attn_heads=attn_heads, cross_attention_dim=cross_attention_dim,
            motion=mid_motion, lora_rank=lora_rank_for(chs[-1], lora_rank),
            lora_scale=lora_scale)

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(chs))
        prev = chs[-1]
        for i, ch in enumerate(rev):
            pops = [skip_chs.pop() for _ in range(LAYERS_PER_BLOCK + 1)]
            mm = motion(2 ** (n - 1 - i))
            if i == 0:
                self.up_blocks.append(UpBlock3D(prev, ch, pops, temb_dim,
                                                add_upsample=i < n - 1, motion=mm))
            else:
                self.up_blocks.append(CrossAttnUpBlock3D(
                    prev, ch, pops, temb_dim, attn_heads, cross_attention_dim,
                    add_upsample=i < n - 1, motion=mm,
                    lora_rank=lora_rank_for(ch, lora_rank), lora_scale=lora_scale))
            prev = ch
        assert not skip_chs

        self.conv_norm_out = GroupNorm(chs[0], 32, eps=1e-5, act="silu")
        self.conv_out = conv3x3(chs[0], LATENT_CHANNELS)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def set_frame_shard(self, axis) -> None:
        """Run frame-parallel over ``axis`` (a ``parallel.mesh.Axis``; None
        or a line of one: on whole clips)."""
        axis = axis if axis is not None and axis.size > 1 else None
        for m in self.modules():
            if isinstance(m, TemporalTransformer3D):
                m.shard = axis

    @property
    def frame_shard(self):
        return next((m.shard for m in self.modules() if isinstance(m, TemporalTransformer3D)),
                    None)

    @contextlib.contextmanager
    def frame_shard_as(self, axis):
        """``set_frame_shard(axis)`` for the block, the previous axis after."""
        before = self.frame_shard
        self.set_frame_shard(axis)
        try:
            yield self
        finally:
            self.set_frame_shard(before)

    def forward(self, sample, timesteps, encoder_hidden_states,
                pose_features: Optional[Sequence[torch.Tensor]] = None,
                traj_features: Optional[Sequence[torch.Tensor]] = None,
                deep_cache: Optional[torch.Tensor] = None, return_deep: bool = False):
        """sample (B, F, H, W, 4); timesteps (B,) or scalar; context (B, 77, X);
        pose/traj features: lists of 4 (B, F, H/2^i, W/2^i, C_i).  Returns eps,
        or (eps, deep) with ``return_deep``: deep is up_blocks[2]'s output
        (B, F, H, W, C_1), DeepCache's cache point.  Given a ``deep_cache``,
        only the shallow level runs (conv_in, down_blocks[0] without its
        downsampler, up_blocks[3] on the cache and the level's skips,
        conv_norm_out, conv_out)."""
        n = len(self.block_out_channels)
        b, f = sample.shape[:2]
        dtype = self.dtype
        pose_features = list(pose_features) if pose_features is not None else [None] * n
        traj_features = list(traj_features) if traj_features is not None else [None] * n

        t = torch.as_tensor(timesteps, device=sample.device).reshape(-1).expand(b)
        temb = self.time_embedding(timestep_embedding(t, self.block_out_channels[0]).to(dtype))
        temb_rep = temb.repeat_interleave(f, dim=0)
        ctx_rep = encoder_hidden_states.to(dtype).repeat_interleave(f, dim=0)

        x = unfold(self.conv_in(fold(sample.to(dtype))), f)
        if deep_cache is not None:
            if n != 4:
                raise ValueError("deep_cache needs the 4-level SD1.5 topology")
            _, outs = self.down_blocks[0](x, temb_rep, ctx_rep, pose_feature=pose_features[0],
                                          traj_feature=traj_features[0], run_downsample=False)
            skips = [x] + outs
            x = self.up_blocks[3](deep_cache.to(dtype), skips, temb_rep, ctx_rep,
                                  pose_feature=pose_features[0])
            assert not skips, f"{len(skips)} unconsumed skip connections"
            eps = unfold(self.conv_out(self.conv_norm_out(fold(x))), f)
            return (eps, deep_cache) if return_deep else eps

        skips = [x]
        for i, blk in enumerate(self.down_blocks):
            if isinstance(blk, CrossAttnDownBlock3D):
                x, outs = blk(x, temb_rep, ctx_rep, pose_feature=pose_features[i],
                              traj_feature=traj_features[i])
            else:
                x, outs = blk(x, temb_rep, pose_feature=pose_features[i])
            skips.extend(outs)

        x = self.mid_block(x, temb_rep, ctx_rep, pose_feature=pose_features[-1])

        deep = None
        for i, blk in enumerate(self.up_blocks):
            pose = pose_features[-(i + 1)]
            if isinstance(blk, CrossAttnUpBlock3D):
                x = blk(x, skips, temb_rep, ctx_rep, pose_feature=pose)
            else:
                x = blk(x, skips, temb_rep, pose_feature=pose)
            if i == n - 2:
                deep = x
        assert not skips, f"{len(skips)} unconsumed skip connections"

        eps = unfold(self.conv_out(self.conv_norm_out(fold(x))), f)
        return (eps, deep) if return_deep else eps


def unet_config_from_yaml(unet_additional_kwargs: dict | None, lora_rank: int = 0,
                          lora_scale: float = 1.0, camera_cond: bool = False,
                          **overrides) -> dict:
    """Map reference YAML unet_additional_kwargs to UNet3D keyword arguments."""
    kw = dict(unet_additional_kwargs or {})
    mm = dict(kw.get("motion_module_kwargs", {}) or {})
    cfg = dict(
        use_motion_module=bool(kw.get("use_motion_module", False)),
        motion_module_mid_block=bool(kw.get("motion_module_mid_block", False)),
        motion_module_resolutions=tuple(kw.get("motion_module_resolutions", (1, 2, 4, 8))),
        motion_num_heads=int(mm.get("num_attention_heads", 8)),
        motion_transformer_blocks=int(mm.get("num_transformer_block", 1)),
        motion_attention_blocks=len(mm.get("attention_block_types",
                                           ["Temporal_Self", "Temporal_Self"])),
        motion_pe_max_len=int(mm.get("temporal_position_encoding_max_len", 32)),
        lora_rank=int(lora_rank),
        lora_scale=float(lora_scale),
        camera_cond=camera_cond,
    )
    cfg.update(overrides)
    return cfg
