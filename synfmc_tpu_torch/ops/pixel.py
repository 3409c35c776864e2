"""Pixel ops (NHWC): unshuffle with torch.nn.PixelUnshuffle's channel order
(out channel index = c*r*r + i*r + j), so ported conv weights line up, and
the nearest resize of the loss masks."""

from __future__ import annotations

import torch


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/f, W/f, C*f*f)."""
    n, h, w, c = x.shape
    if h % factor or w % factor:
        raise ValueError(f"({h}, {w}) not divisible by {factor}")
    x = x.reshape(n, h // factor, factor, w // factor, factor, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (N, H/f, W/f, C, i, j)
    return x.reshape(n, h // factor, w // factor, c * factor * factor)


def nearest_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest-neighbour resize of (N, H, W, C), F.interpolate(mode='nearest')'s
    index rule: source index floor(i * in / out)."""
    n, h, w, c = x.shape
    rows = (torch.arange(out_h, device=x.device) * (h / out_h)).long()
    cols = (torch.arange(out_w, device=x.device) * (w / out_w)).long()
    return x[:, rows][:, :, cols]
