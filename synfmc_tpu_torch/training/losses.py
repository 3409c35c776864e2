"""Training losses (synfmc_tpu/training/losses.py).

- epsilon-prediction MSE in fp32;
- the masked loss: the union object mask nearest-resized to the latent
  size, inverted for stage 2 (the loss then weighs the background),
  total = mask_w * mask_loss + sd_w * sd_loss;
- the MotionDirector appearance-debias loss against a per-sample anchor frame.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from synfmc_tpu_torch.ops.pixel import nearest_resize


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred.float() - target.float()) ** 2)


def masked_diffusion_loss(pred, target, obj_union_mask: Optional[torch.Tensor],
                          invert_mask: bool, mask_loss_weight: float,
                          sd_loss_weight: float) -> tuple[torch.Tensor, dict]:
    """pred/target: (B, F, h, w, C) latents; obj_union_mask: (B, F, H, W, 1)
    binary union of object masks at pixel resolution, or None."""
    sd_loss = mse(pred, target)
    if obj_union_mask is None:
        return sd_loss, {"sd_loss": sd_loss}
    b, f, h, w, _ = pred.shape
    m = obj_union_mask.reshape(b * f, *obj_union_mask.shape[2:])
    m = nearest_resize(m, h, w).reshape(b, f, h, w, 1).float()
    if invert_mask:
        m = 1.0 - m
    mask_loss = mse(pred.float() * m, target.float() * m)
    loss = mask_loss_weight * mask_loss + sd_loss_weight * sd_loss
    return loss, {"sd_loss": sd_loss, "mask_loss": mask_loss}


def appearance_debias_loss(pred, target, anchor_frames: torch.Tensor,
                           anchor_source: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE of sqrt(2)*pred - anchor against sqrt(2)*target - anchor, the anchor
    being frame ``anchor_frames[b]`` of each sample's target (B,).  A
    frame-parallel rank passes its frames as pred / target and the whole
    clip's target as ``anchor_source``: the anchor index is global."""
    source = target if anchor_source is None else anchor_source
    b = target.shape[0]
    idx = anchor_frames.to(target.device).long()
    anchor = source[torch.arange(b, device=target.device), idx][:, None]
    s2 = math.sqrt(2.0)
    return mse(s2 * pred - anchor, s2 * target - anchor)
