"""Config -> AnimationPipeline with seeded random weights.

Builds the camera-conditioned (cam stage) or camera- and object-conditioned
(obj stage) pipeline from a reference-format YAML config (configs/cam.yaml,
configs/obj.yaml keys: unet_additional_kwargs, lora_rank, lora_scale,
attention_processor_kwargs, pose_encoder_kwargs, omcm_config,
noise_scheduler_kwargs, mixed_precision_training) plus the optional
``model_overrides`` that shrink every module for tests.  Real checkpoints
load afterwards through ``interop.torch_port.load_jax_params`` or
``load_state_dict``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from synfmc_tpu_torch.data.tokenizer import HashTokenizer
from synfmc_tpu_torch.device import resolve_device
from synfmc_tpu_torch.diffusion.scheduler import DiffusionSchedule
from synfmc_tpu_torch.models.adapter import ObjectAdapter
from synfmc_tpu_torch.models.clip_text import CLIPTextModel
from synfmc_tpu_torch.models.pose_encoder import CameraPoseEncoder
from synfmc_tpu_torch.models.unet3d import UNet3D, unet_config_from_yaml
from synfmc_tpu_torch.models.vae import AutoencoderKL
from synfmc_tpu_torch.pipelines.animation import AnimationPipeline

SD15_TEXT = dict(vocab_size=49408, hidden_size=768, num_layers=12, num_heads=12)
STAGES = ("cam", "obj")


def load_config(config) -> dict:
    """A config dict, or the path of a YAML file."""
    if isinstance(config, dict):
        return config
    import yaml

    with open(config) as fh:
        return yaml.safe_load(fh)


def _attn_block_indices(v) -> tuple:
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return tuple(int(x) for x in str(v).split(","))


def build_models(config: dict, stage: str = "cam") -> dict:
    """The stage's modules from a config dict: unet, vae, text, pose_encoder,
    and for the obj stage the ObjectAdapter of ``omcm_config.params``."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r} (want one of {STAGES})")
    ov = dict(config.get("model_overrides") or {})
    chs = tuple(ov.get("block_out_channels", (320, 640, 1280, 1280)))
    xdim = int(ov.get("cross_attention_dim", 768))
    heads = int(ov.get("attn_heads", 8))
    apk = dict(config.get("attention_processor_kwargs") or {})
    unet_kwargs = unet_config_from_yaml(
        config.get("unet_additional_kwargs"),
        lora_rank=int(config.get("lora_rank", 0)),
        lora_scale=float(config.get("lora_scale", 1.0)),
        camera_cond=True,
        motion_lora_rank=int(config.get("motion_lora_rank", 0)),
        motion_lora_scale=float(config.get("motion_lora_scale", 1.0)),
        pose_scale=float(apk.get("scale", 1.0)),
        pose_cond_blocks=_attn_block_indices(apk.get("temporal_attn_names", "0")),
    )
    unet = UNet3D(block_out_channels=chs, attn_heads=heads, cross_attention_dim=xdim,
                  **unet_kwargs)
    vae = AutoencoderKL(block_out_channels=tuple(ov.get("vae_channels", (128, 256, 512, 512))))
    text_kwargs = dict(SD15_TEXT)
    text_kwargs.update(ov.get("text", {}))
    if "text" not in ov:
        text_kwargs["hidden_size"] = xdim
    text = CLIPTextModel(**text_kwargs)
    pk = dict(config.get("pose_encoder_kwargs") or {})
    pose_chs = chs if "block_out_channels" in ov else tuple(pk.get("channels", chs))
    pose = CameraPoseEncoder(
        downscale_factor=int(pk.get("downscale_factor", 8)),
        channels=pose_chs,
        nums_rb=int(pk.get("nums_rb", 2)),
        ksize=int(pk.get("ksize", 1)),
        temporal_attention_nhead=int(pk.get("temporal_attention_nhead", 8)),
        temporal_pe_max_len=int(pk.get("temporal_position_encoding_max_len", 16)),
    )
    models = {"unet": unet, "vae": vae, "text": text, "pose_encoder": pose}
    if stage == "obj":
        ok = dict((config.get("omcm_config") or {}).get("params") or {})
        models["adapter"] = ObjectAdapter(
            channels=tuple(ov.get("pose_channels", chs)),
            nums_rb=int(ok.get("nums_rb", 2)),
            use_pre_zero_conv=bool(ok.get("use_pre_zero_conv", True)),
            use_post_zero_conv=bool(ok.get("use_post_zero_conv", True)),
        )
    return models


@torch.no_grad()
def init_random_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Seeded random weights: matrices and conv kernels N(0, 1/fan_in), norm
    scales 1, biases 0, token embeddings N(0, 1), position embeddings N(0, 0.01).
    LoRA and pose-merge projections and the adapter's zero convs get random
    (not zero) weights, so the conditioning paths change the output."""
    for name, p in module.named_parameters():
        if p.dim() == 1:
            p.fill_(1.0 if name.endswith("weight") else 0.0)
            continue
        if name.endswith("position_embedding.weight"):
            std = 0.01
        elif name.endswith("token_embedding.weight"):
            std = 1.0
        else:
            std = 1.0 / math.sqrt(p[0].numel())
        noise = torch.randn(p.shape, generator=generator, device=generator.device)
        p.copy_(noise * std)
    return module


def build_pipeline(config, *, stage: str = "cam", device=None,
                   dtype: Optional[torch.dtype] = None, seed: int = 42) -> AnimationPipeline:
    """The ``stage``'s ("cam" or "obj") AnimationPipeline with random weights
    made from ``seed``.

    ``device`` defaults to ``cuda`` (raises without a GPU); ``dtype`` defaults
    to bf16 when the config sets ``mixed_precision_training`` (the default),
    else fp32."""
    config = load_config(config)
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if config.get("mixed_precision_training", True) else torch.float32
    with torch.device(dev):
        models = build_models(config, stage)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for module in models.values():
        init_random_(module, gen)
        module.to(dtype=dtype, memory_format=torch.channels_last)
    return AnimationPipeline(
        unet=models["unet"], vae=models["vae"], text_encoder=models["text"],
        tokenizer=HashTokenizer(),
        schedule=DiffusionSchedule.from_config(**(config.get("noise_scheduler_kwargs") or {})),
        pose_encoder=models["pose_encoder"], adapter=models.get("adapter"), device=dev,
    )
