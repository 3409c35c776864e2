"""Attention modules: the reference's processor behaviors as one
parameterized module, plus the spatial transformer stack.

``lora_rank > 0`` adds LoRA branches and ``pose_cond != 'none'`` adds the
pose-merge projection; both live under ``.processor`` as in the reference
state dicts.  ``temporal_pe_max_len > 0`` adds the fixed sinusoidal PE to the
input tokens before any pose merge.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from synfmc_tpu_torch.models.layers import (
    Conv2d,
    FeedForward,
    GroupNorm,
    LayerNorm,
    sinusoidal_positional_encoding,
)
from synfmc_tpu_torch.ops.attention import dot_product_attention


class LoRADense(nn.Module):
    """diffusers LoRALinearLayer: up(down(x))."""

    def __init__(self, in_features: int, out_features: int, rank: int):
        super().__init__()
        self.down = nn.Linear(in_features, rank, bias=False)
        self.up = nn.Linear(rank, out_features, bias=False)

    def forward(self, x):
        return self.up(self.down(x))


_MERGES = {"qkv": "qkv_merge", "q": "q_merge", "kv": "kv_merge"}


class Attention(nn.Module):
    """Multi-head attention with optional LoRA and pose-merge conditioning.

    pose_cond: 'none' | 'qkv' (self-attention, q=k=v conditioned) | 'q' | 'kv'.
    A pose-conditioned module called without a pose feature runs vanilla.
    """

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None, lora_rank: int = 0,
                 lora_scale: float = 1.0,
                 pose_cond: str = "none", pose_scale: float = 1.0,
                 temporal_pe_max_len: int = 0, rescale_output_factor: float = 1.0):
        super().__init__()
        if pose_cond not in ("none", *_MERGES):
            raise ValueError(f"unknown pose_cond {pose_cond!r}")
        if pose_cond == "qkv" and cross_attention_dim is not None:
            raise ValueError("pose 'qkv' merge is self-attention only")
        self.heads, self.dim_head = heads, dim_head
        self.lora_scale, self.pose_cond, self.pose_scale = lora_scale, pose_cond, pose_scale
        self.rescale_output_factor = rescale_output_factor
        inner = heads * dim_head
        kv_dim = cross_attention_dim or query_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])
        proc = {}
        if pose_cond != "none":
            width = kv_dim if pose_cond == "kv" else query_dim
            proc[_MERGES[pose_cond]] = nn.Linear(width, width)
        if lora_rank > 0:
            proc["to_q_lora"] = LoRADense(query_dim, inner, lora_rank)
            proc["to_k_lora"] = LoRADense(kv_dim, inner, lora_rank)
            proc["to_v_lora"] = LoRADense(kv_dim, inner, lora_rank)
            proc["to_out_lora"] = LoRADense(inner, query_dim, lora_rank)
        self.processor = nn.ModuleDict(proc)
        self.lora = lora_rank > 0
        if temporal_pe_max_len > 0:
            self.register_buffer(
                "pe", sinusoidal_positional_encoding(temporal_pe_max_len, query_dim),
                persistent=False)
        else:
            self.pe = None

    def forward(self, hidden_states, encoder_hidden_states=None, pose_feature=None):
        b, seq, _ = hidden_states.shape
        if self.pe is not None:
            hidden_states = hidden_states + self.pe[None, :seq].to(hidden_states.dtype)
        x = hidden_states
        ctx = encoder_hidden_states if encoder_hidden_states is not None else x
        if self.pose_cond == "none" or pose_feature is None:
            q_in, kv_in = x, ctx
        elif self.pose_cond == "qkv":
            q_in = kv_in = self.processor["qkv_merge"](x + pose_feature) * self.pose_scale + x
        elif self.pose_cond == "q":
            q_in = self.processor["q_merge"](x + pose_feature) * self.pose_scale + x
            kv_in = ctx
        else:  # 'kv'
            kv_in = self.processor["kv_merge"](ctx + pose_feature) * self.pose_scale + ctx
            q_in = x

        q, k, v = self.to_q(q_in), self.to_k(kv_in), self.to_v(kv_in)
        if self.lora:
            p = self.processor
            q = q + self.lora_scale * p["to_q_lora"](q_in)
            k = k + self.lora_scale * p["to_k_lora"](kv_in)
            v = v + self.lora_scale * p["to_v_lora"](kv_in)
        q = q.reshape(b, seq, self.heads, self.dim_head)
        k = k.reshape(b, -1, self.heads, self.dim_head)
        v = v.reshape(b, -1, self.heads, self.dim_head)
        attn = dot_product_attention(q, k, v, scale=self.dim_head ** -0.5)
        attn = attn.reshape(b, seq, self.heads * self.dim_head)
        out = self.to_out[0](attn)
        if self.lora:
            out = out + self.lora_scale * self.processor["to_out_lora"](attn)
        if self.rescale_output_factor != 1.0:
            out = out / self.rescale_output_factor
        return out


class BasicTransformerBlock(nn.Module):
    """Self-attention, cross-attention, GEGLU feed-forward (pre-LN residuals)."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_attention_dim: int = 768,
                 lora_rank: int = 0, lora_scale: float = 1.0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head, lora_rank=lora_rank, lora_scale=lora_scale)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head, cross_attention_dim=cross_attention_dim,
                               lora_rank=lora_rank, lora_scale=lora_scale)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), encoder_hidden_states=context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """diffusers Transformer2DModel (use_linear_projection=False):
    GroupNorm -> 1x1 proj_in -> tokens -> blocks -> 1x1 proj_out -> + residual.
    Input NHWC with frames folded into the batch."""

    def __init__(self, in_channels: int, heads: int, dim_head: int,
                 cross_attention_dim: int = 768, lora_rank: int = 0, lora_scale: float = 1.0):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(in_channels, 32, eps=1e-6)
        self.proj_in = Conv2d(in_channels, inner, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, cross_attention_dim, lora_rank, lora_scale)
        ])
        self.proj_out = Conv2d(inner, in_channels, 1)

    def forward(self, x, context):
        n, h, w, _ = x.shape
        residual = x
        y = self.proj_in(self.norm(x))
        inner = y.shape[-1]
        y = y.reshape(n, h * w, inner)
        for blk in self.transformer_blocks:
            y = blk(y, context)
        return self.proj_out(y.reshape(n, h, w, inner)) + residual
