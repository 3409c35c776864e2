"""OMC trajectory features: padded per-object poses and masks -> the
ObjectAdapter's input -> four traj feature videos.

The semantics of synfmc_tpu/utils/traj_features.py (the reference's
``get_traj_features_v2``), a plain loop over the object axis:
- the pose raster is the object's 12 pose values times its mask value,
  taken where the mask is > 0; at overlapping pixels the last object wins;
  all-zero padding objects leave no mark;
- the 13-channel feature (raster + mask) has whole-sample CFG dropout, then
  is multiplied by the mask again.
"""

from __future__ import annotations

from typing import Optional

import torch


def rasterize_traj_features(obj_info: torch.Tensor, obj_masks: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """obj_info (B, F, O, 12), obj_masks (B, F, O, H, W) in [0, 1] ->
    traj (B, F, H, W, 12) and mask (B, F, H, W, 1)."""
    b, f, o, h, w = obj_masks.shape
    traj = obj_info.new_zeros((b, f, h, w, 12))
    mask = obj_info.new_zeros((b, f, h, w, 1))
    for i in range(o):
        m = obj_masks[:, :, i, :, :, None].to(obj_info.dtype)
        hit = m > 0
        traj = torch.where(hit, obj_info[:, :, i, None, None, :] * m, traj)
        mask = torch.where(hit, m, mask)
    return traj, mask


def build_adapter_inputs(obj_info: torch.Tensor, obj_masks: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         cfg_dropout_ratio: float = 0.0,
                         uniforms: Optional[torch.Tensor] = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Raster + mask concatenated, whole samples dropped with probability
    ``cfg_dropout_ratio`` (their (B,) uniforms given, or drawn from
    ``generator``), re-masked: features (B*F, H, W, 13) and mask (B*F, H, W, 1)."""
    traj, mask = rasterize_traj_features(obj_info, obj_masks)
    features = torch.cat([traj, mask], dim=-1)
    if uniforms is None and generator is not None and cfg_dropout_ratio > 0:
        uniforms = torch.rand((features.shape[0],), generator=generator, device=generator.device)
    if uniforms is not None and cfg_dropout_ratio > 0:
        keep = uniforms > cfg_dropout_ratio
        features = features * keep.to(features.device, features.dtype)[:, None, None, None, None]
    features = features * mask
    b, f, h, w, c = features.shape
    return features.reshape(b * f, h, w, c), mask.reshape(b * f, h, w, 1)


def traj_features_from_adapter(adapter, features: torch.Tensor, mask: torch.Tensor,
                               num_frames: int) -> list[torch.Tensor]:
    """Run the ObjectAdapter and reshape each scale to (B, F, h, w, C)."""
    return [ft.reshape(ft.shape[0] // num_frames, num_frames, *ft.shape[1:])
            for ft in adapter(features, mask)]
