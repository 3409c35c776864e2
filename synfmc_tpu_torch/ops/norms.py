"""Normalization ops (channel-last).

``group_norm`` is the single entry point for every GroupNorm of the stack
(UNet resnets, transformer and motion-module input norms, VAE blocks), with
an optional fused activation.  A slab K3 takes goes through the fused
wrapper, which runs CUDA kernel K3 on a GPU tensor and the plain version on a
CPU one; a slab it does not take (C > 6144 or S*C >= 2**31) goes to the plain
version on either device, as the JAX package's group_norm is XLA's.  The route
depends on the shape alone: an x off 16 bytes is copied, not routed away.
``layer_norm`` stays plain PyTorch, as the JAX package left it to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from synfmc_tpu_torch.ops import _library
from synfmc_tpu_torch.ops.fused_groupnorm import (
    fused_group_norm,
    group_norm_plain,
    group_norm_supported,
)


def group_norm(x, scale, bias, num_groups: int, eps: float = 1e-5,
               act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm over the trailing channel axis of (N, ..., C)."""
    x = x.contiguous()
    n, c = x.shape[0], x.shape[-1]
    if not group_norm_supported(x.numel() // max(n * c, 1), c):
        return group_norm_plain(x, scale, bias, num_groups, eps, act)
    if not _library.tracing() and x.data_ptr() % 16:  # a traced call: K3's launch copies it
        x = x.clone()
    return fused_group_norm(x, scale, bias, num_groups, eps=eps, act=act)


def layer_norm(x, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing axis.  PyTorch's kernel keeps the
    statistics and the affine in fp32 for bf16 input and rounds once at the
    end, which is ops/norms.py:layer_norm's math without two cast passes."""
    return F.layer_norm(x, (x.shape[-1],), scale.to(x.dtype), bias.to(x.dtype), eps)
