"""Trainable/frozen partition per training stage (synfmc_tpu/training/params.py).

The JAX package's path rules, read on the port's diffusers-style parameter
names ('.'-joined, e.g. ``down_blocks.0.motion_modules.0.temporal_transformer
.transformer_blocks.0.attention_blocks.0.processor.qkv_merge.weight``).
Frozen parameters get ``requires_grad=False``, so autograd forms no weight
gradient for them, as ``jax.value_and_grad`` over the trainable subtree
does not.
"""

from __future__ import annotations

from typing import Callable

import torch

NamePredicate = Callable[[str], bool]


def stage1_lora_trainable(name: str) -> bool:
    """Stage 1: the LoRA branches only."""
    return "lora" in name


def stage2_cmc_unet_trainable(name: str) -> bool:
    """Stage 2 UNet subset: 'merge' in the name and 'lora' not in it (the
    pose encoder trains fully)."""
    return "merge" in name and "lora" not in name


def stage3_mm_trainable(name: str) -> bool:
    """train_mm: norm / proj_in / proj_out of every temporal transformer."""
    if "motion_modules" not in name:
        return False
    parts = name.split(".")
    owner = parts[-2] if len(parts) > 1 else name
    return owner in ("norm", "proj_in", "proj_out")


def stage3_unet_trainable(name: str, train_cm: bool = False, train_mm: bool = False,
                          train_image_lora: bool = False) -> bool:
    """Stage 3 UNet subset (the ObjectAdapter trains fully): the pose merges
    with ``train_cm``, the motion modules' norm / proj_in / proj_out with
    ``train_mm``, the image LoRA with ``train_image_lora``."""
    return ((train_cm and stage2_cmc_unet_trainable(name))
            or (train_mm and stage3_mm_trainable(name))
            or (train_image_lora and "lora" in name))


def partition_params(module: torch.nn.Module, predicate: NamePredicate,
                     prefix: str = "") -> dict[str, torch.nn.Parameter]:
    """Mark ``module``'s parameters trainable where ``predicate(name)`` holds
    and frozen elsewhere; returns the trainable ones by ``prefix + name``."""
    trainable = {}
    for name, p in module.named_parameters():
        keep = predicate(name)
        p.requires_grad_(keep)
        if keep:
            trainable[prefix + name] = p
    return trainable


def count_params(params) -> int:
    return sum(p.numel() for p in params)
