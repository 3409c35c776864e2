"""Load a diffusers-layout SD1.5 directory into the port's modules.

The counterpart of synfmc_tpu/interop/sd_loader.py: ``pretrained_model_path``
(configs/cam.yaml:2) names a directory with unet/, vae/, text_encoder/ and
tokenizer/ subfolders; weights are ``.safetensors`` (read by this package's
own reader) or ``.bin`` (``torch.load``).
"""

from __future__ import annotations

import os

import torch

from synfmc_tpu_torch.interop.safetensors import load_file
from synfmc_tpu_torch.training.checkpoint import load_into_module, torch_load_state_dict

WEIGHT_FILES = (
    "diffusion_pytorch_model.safetensors",
    "diffusion_pytorch_model.bin",
    "model.safetensors",
    "pytorch_model.bin",
)


def load_weights(folder: str) -> dict[str, torch.Tensor]:
    """The first of ``WEIGHT_FILES`` present in ``folder``."""
    for name in WEIGHT_FILES:
        path = os.path.join(folder, name)
        if os.path.exists(path):
            return load_file(path) if name.endswith(".safetensors") else torch_load_state_dict(path)
    raise FileNotFoundError(f"no weight file found in {folder} (tried {list(WEIGHT_FILES)})")


def load_sd15(models: dict, sd_dir: str, unet_subfolder: str = "unet") -> dict:
    """Fill ``models["unet"]`` (its spatial part), ``models["vae"]`` and
    ``models["text"]`` from an SD1.5 directory, in place.

    The UNet load is non-strict (motion modules, pose merges and LoRA
    branches are not part of SD1.5 and keep their values) but every SD1.5
    tensor must land in it; the VAE and the text encoder load strictly, each
    only when its subfolder exists."""
    load_into_module(models["unet"], load_weights(os.path.join(sd_dir, unet_subfolder)), "unet")
    for key, sub in (("vae", "vae"), ("text", "text_encoder")):
        folder = os.path.join(sd_dir, sub)
        if os.path.isdir(folder) and key in models:
            load_into_module(models[key], load_weights(folder), key, strict=True)
    return models
