"""Plücker-ray embedding of camera trajectories, computed on the device.

Per-frame intrinsics K = (fx, fy, cx, cy) and camera-to-world matrices give
per-pixel Plücker coordinates [o x d, d] (6 channels).  All in fp32; the
rotation is applied as an elementwise multiply-sum, so no TF32 matrix
product can round the pose signal.
"""

from __future__ import annotations

from typing import Optional

import torch


def plucker_embedding(intrinsics: torch.Tensor, c2w: torch.Tensor, height: int,
                      width: int, flip_flag: Optional[torch.Tensor] = None) -> torch.Tensor:
    """intrinsics (B, F, 4), c2w (B, F, 4, 4) -> (B, F, height, width, 6) fp32.

    ``flip_flag`` (B,) bool: horizontally flipped samples use mirrored pixel
    x coordinates, W - 0.5 - arange(W) (the reference ray_condition's flip)."""
    intrinsics = intrinsics.float()
    c2w = c2w.float()
    dev = c2w.device
    b, f = intrinsics.shape[:2]
    i = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, None, None, :]  # x
    if flip_flag is not None:
        mirrored = width - 0.5 - torch.arange(width, dtype=torch.float32, device=dev)
        flip = torch.as_tensor(flip_flag, device=dev).bool()[:, None, None, None]
        i = torch.where(flip, mirrored[None, None, None, :], i)
    j = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)[:, None]  # y
    fx, fy, cx, cy = [intrinsics[..., k][..., None, None] for k in range(4)]  # (B,F,1,1)
    shape = (b, f, height, width)
    xs = torch.broadcast_to((i - cx) / fx, shape)
    ys = torch.broadcast_to((j[None, None] - cy) / fy, shape)
    directions = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    directions = directions / torch.linalg.vector_norm(directions, dim=-1, keepdim=True)
    rot = c2w[..., :3, :3]  # (B,F,3,3)
    # rays_d[..., k] = sum_c dir[..., c] * rot[..., k, c]
    rays_d = (directions[..., None, :] * rot[:, :, None, None, :, :]).sum(-1)
    rays_o = torch.broadcast_to(c2w[..., :3, 3][:, :, None, None, :], rays_d.shape)
    rays_dxo = torch.linalg.cross(rays_o, rays_d, dim=-1)
    return torch.cat([rays_dxo, rays_d], dim=-1)
