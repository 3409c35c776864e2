"""Attention compute core: the single dispatch point for all attention.

Same routing rules as synfmc_tpu/ops/attention.py:dot_product_attention,
with "running on the TPU" read as "the tensors lie on a GPU or CPU" -- the
router takes the same decision on both, and the kernel wrappers run their
plain versions for CPU tensors:

- flash (K1): self-attention with S >= 256, no mask, Sq == Sk;
- temporal (K2): self-attention with S <= 64 over N >= 8 rows, N % 8 == 0;
- plain: everything else, the head-merged path with fp32 logits, an
  additive mask and probabilities cast to v's type.

The TPU gates' VMEM-budget terms are dropped (the kernels stream or tile on
their own); the kernels' own limits (head dim a multiple of 8, D <= 256,
F <= 64) are added.

Layout: (batch, seq, heads, head_dim).
"""

from __future__ import annotations

from typing import Optional

import torch

from synfmc_tpu_torch.ops.flash_attention import flash_attention, flash_supported
from synfmc_tpu_torch.ops.temporal_attention import temporal_attention, temporal_supported

_FLASH_MIN_SEQ = 256
_TEMPORAL_MAX_SEQ = 64


def plain_attention(q, k, v, scale: float, mask=None) -> torch.Tensor:
    """Head-merged attention (_xla_attention): fp32 logits, additive mask,
    probabilities cast to v's type before PV."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qt = q.transpose(1, 2).reshape(b * h, sq, d)
    kt = k.transpose(1, 2).reshape(b * h, sk, d)
    vt = v.transpose(1, 2).reshape(b * h, sk, d)
    logits = torch.bmm(qt.float(), kt.float().transpose(1, 2)) * scale
    if mask is not None:
        logits = logits + torch.broadcast_to(mask.float(), (b, h, sq, sk)).reshape(b * h, sq, sk)
    probs = torch.softmax(logits, dim=-1)
    out = torch.bmm(probs.to(v.dtype), vt)
    return out.reshape(b, h, sq, d).transpose(1, 2)


def route(q, k, mask=None) -> str:
    """Which path dot_product_attention takes: 'flash', 'temporal' or 'plain'."""
    if mask is not None or q.shape[1] != k.shape[1]:
        return "plain"
    b, s, h, d = q.shape
    if s >= _FLASH_MIN_SEQ and flash_supported(q):
        return "flash"
    if s <= _TEMPORAL_MAX_SEQ and temporal_supported(q.reshape(b, s, h * d), h):
        return "temporal"
    return "plain"


def dot_product_attention(q, k, v, scale: Optional[float] = None, mask=None) -> torch.Tensor:
    """Multi-head scaled dot-product attention on (B, S, H, D) -> (B, Sq, H, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    path = route(q, k, mask)
    if path == "plain":
        return plain_attention(q, k, v, scale, mask)
    b, s, h, d = q.shape
    kernel = flash_attention if path == "flash" else temporal_attention
    out = kernel(q.reshape(b, s, h * d), k.reshape(b, s, h * d), v.reshape(b, s, h * d), scale, h)
    return out.reshape(b, s, h, d)
