"""AnimateDiff-style temporal transformer (motion module).

Video activations are NHWC ``(b, f, h, w, c)``; temporal attention runs on
``(b*h*w, f, c)`` token groups.  The permutes to and from that layout are
real copies here (as in the reference).  Pose conditioning installs the
qkv merge in the attention blocks listed by ``pose_cond_blocks``.

Frame-parallel (``shard``: the mesh's ``sp`` axis, set through
``UNet3D.set_frame_shard``): a rank holds ``f/S`` frames, and the two
permutes become the exchange of ``parallel/collectives.py``, so that the
rank's rows of token groups carry all ``f`` frames (the temporal encoding
sees global frame indices).  The pose features arrive whole on every rank:
their tokens are sliced by the rank's rows, not exchanged.
"""

from __future__ import annotations

from typing import Optional, Sequence

from torch import nn

from synfmc_tpu_torch.models.attention import Attention
from synfmc_tpu_torch.models.layers import FeedForward, GroupNorm, LayerNorm
from synfmc_tpu_torch.parallel.collectives import frames_to_rows, row_splits, rows_to_frames


class TemporalTransformerBlock(nn.Module):
    """Attention blocks (Temporal_Self) + GEGLU feed-forward on (N, F, C) tokens."""

    def __init__(self, dim: int, num_attention_heads: int, attention_head_dim: int,
                 num_attention_blocks: int = 2, temporal_pe_max_len: int = 32,
                 pose_cond_blocks: Sequence[int] = (), pose_scale: float = 1.0,
                 lora_rank: int = 0, lora_scale: float = 1.0):
        super().__init__()
        self.pose_cond_blocks = tuple(pose_cond_blocks)
        self.attention_blocks = nn.ModuleList([
            Attention(dim, num_attention_heads, attention_head_dim,
                      pose_cond="qkv" if i in self.pose_cond_blocks else "none",
                      pose_scale=pose_scale, lora_rank=lora_rank, lora_scale=lora_scale,
                      temporal_pe_max_len=temporal_pe_max_len)
            for i in range(num_attention_blocks)
        ])
        self.norms = nn.ModuleList([LayerNorm(dim) for _ in range(num_attention_blocks)])
        self.ff_norm = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, pose_feature=None):
        for i, (attn, norm) in enumerate(zip(self.attention_blocks, self.norms)):
            pose_here = pose_feature if i in self.pose_cond_blocks else None
            x = x + attn(norm(x), pose_feature=pose_here)
        return x + self.ff(self.ff_norm(x))


class TemporalTransformer3D(nn.Module):
    """GN -> proj_in -> temporal blocks -> proj_out -> + residual on (b, f, h, w, c)."""

    def __init__(self, channels: int, num_attention_heads: int = 8,
                 num_transformer_blocks: int = 1, num_attention_blocks: int = 2,
                 temporal_pe_max_len: int = 32, pose_cond_blocks: Sequence[int] = (),
                 pose_scale: float = 1.0, lora_rank: int = 0, lora_scale: float = 1.0):
        super().__init__()
        self.norm = GroupNorm(channels, 32, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            TemporalTransformerBlock(
                channels, num_attention_heads, channels // num_attention_heads,
                num_attention_blocks=num_attention_blocks,
                temporal_pe_max_len=temporal_pe_max_len, pose_cond_blocks=pose_cond_blocks,
                pose_scale=pose_scale, lora_rank=lora_rank, lora_scale=lora_scale)
            for _ in range(num_transformer_blocks)
        ])
        self.proj_out = nn.Linear(channels, channels)
        self.shard = None  # the mesh's sp axis when frame-parallel

    def forward(self, x, pose_feature=None):
        b, f, h, w, c = x.shape
        residual = x
        y = self.norm(x.reshape(b * f, h, w, c)).reshape(b, f, h, w, c)
        shard: Optional[object] = self.shard
        if shard is None:
            frames, rows = f, slice(None)
            y = y.permute(0, 2, 3, 1, 4).reshape(b * h * w, f, c)
        else:
            splits = row_splits(b * h * w, shard.size)
            lo = sum(splits[:shard.index])
            frames, rows = f * shard.size, slice(lo, lo + splits[shard.index])
            y = frames_to_rows(y, shard.group, shard.index, splits)
        y = self.proj_in(y)
        pose_tokens = None
        if pose_feature is not None:
            if tuple(pose_feature.shape[:4]) != (b, frames, h, w):
                raise ValueError(f"pose feature shape {tuple(pose_feature.shape)} != activation "
                                 f"{(b, frames, h, w)}")
            pc = pose_feature.shape[-1]
            pose_tokens = pose_feature.permute(0, 2, 3, 1, 4).reshape(b * h * w, frames, pc)[rows]
        for blk in self.transformer_blocks:
            y = blk(y, pose_feature=pose_tokens)
        y = self.proj_out(y)
        if shard is None:
            y = y.reshape(b, h, w, f, c).permute(0, 3, 1, 2, 4)
        else:
            y = rows_to_frames(y, shard.group, shard.index, splits, (b, f, h, w, c))
        return y + residual


class VanillaTemporalModule(nn.Module):
    """The reference's motion-module wrapper: parameters under ``temporal_transformer``."""

    def __init__(self, channels: int, **kwargs):
        super().__init__()
        self.temporal_transformer = TemporalTransformer3D(channels, **kwargs)

    def forward(self, x, pose_feature=None):
        return self.temporal_transformer(x, pose_feature=pose_feature)
