"""Config -> checkpoint files -> AnimationPipeline, for the entry points
(scripts/generate.py, scripts/serve.py).

The counterpart of synfmc_tpu/pipelines/factory.py:build_pipeline.  Builds
the camera-conditioned (cam stage) or camera- and object-conditioned (obj
stage) pipeline from a reference-format YAML config (configs/cam.yaml,
configs/obj.yaml keys: unet_additional_kwargs, lora_rank, lora_scale,
attention_processor_kwargs, pose_encoder_kwargs, omcm_config,
noise_scheduler_kwargs, mixed_precision_training and the checkpoint paths)
plus the optional ``model_overrides`` that shrink every module for tests.

Weights start as the JAX package's do: seeded random, with its structural
zeros (``init_structural_zeros_``), so a partial load computes what the JAX
package computes; then the configured checkpoints load over them
(``training.pretrained.load_pretrained``), the OMC bundle last.
"""

from __future__ import annotations

import logging
import math
import re
from typing import Optional

import torch

from synfmc_tpu_torch.config import load_config
from synfmc_tpu_torch.data.tokenizer import load_tokenizer
from synfmc_tpu_torch.device import resolve_device
from synfmc_tpu_torch.diffusion.scheduler import DiffusionSchedule
from synfmc_tpu_torch.models.adapter import ObjectAdapter
from synfmc_tpu_torch.models.clip_text import CLIPTextModel
from synfmc_tpu_torch.models.pose_encoder import CameraPoseEncoder
from synfmc_tpu_torch.models.unet3d import UNet3D, unet_config_from_yaml
from synfmc_tpu_torch.models.vae import AutoencoderKL
from synfmc_tpu_torch.parallel.mesh import serving_mesh
from synfmc_tpu_torch.pipelines.animation import AnimationPipeline
from synfmc_tpu_torch.training.checkpoint import load_into_module, torch_load_state_dict
from synfmc_tpu_torch.training.pretrained import load_pretrained, validate_pretrained_paths

SD15_TEXT = dict(vocab_size=49408, hidden_size=768, num_layers=12, num_heads=12)
STAGES = ("lora", "cam", "obj")
logger = logging.getLogger(__name__)


def _attn_block_indices(v) -> tuple:
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return tuple(int(x) for x in str(v).split(","))


def build_models(config: dict, stage: str = "cam") -> dict:
    """The stage's modules from a config dict, as synfmc_tpu/training/
    trainers.py:build_models makes them: unet, vae, text; for cam and obj a
    camera-conditioned UNet and the pose encoder, for obj also the
    ObjectAdapter of ``omcm_config.params``.  The lora stage's UNet has no
    motion modules and no pose merges (an image model)."""
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
        camera_cond=stage in ("cam", "obj"),
        motion_lora_rank=int(config.get("motion_lora_rank", 0)),
        motion_lora_scale=float(config.get("motion_lora_scale", 1.0)),
        pose_scale=float(apk.get("scale", 1.0)),
        pose_cond_blocks=_attn_block_indices(apk.get("temporal_attn_names", "0")),
    )
    if stage == "lora":
        unet_kwargs["use_motion_module"] = False
    unet = UNet3D(block_out_channels=chs, attn_heads=heads, cross_attention_dim=xdim,
                  **unet_kwargs)
    vae = AutoencoderKL(block_out_channels=tuple(ov.get("vae_channels", (128, 256, 512, 512))))
    text_kwargs = dict(SD15_TEXT)
    text_kwargs.update(ov.get("text", {}))
    if "text" not in ov:
        text_kwargs["hidden_size"] = xdim
    text = CLIPTextModel(**text_kwargs)
    models = {"unet": unet, "vae": vae, "text": text}
    if stage in ("cam", "obj"):
        pk = dict(config.get("pose_encoder_kwargs") or {})
        pose_chs = chs if "block_out_channels" in ov else tuple(pk.get("channels", chs))
        models["pose_encoder"] = CameraPoseEncoder(
            downscale_factor=int(pk.get("downscale_factor", 8)),
            channels=pose_chs,
            nums_rb=int(pk.get("nums_rb", 2)),
            ksize=int(pk.get("ksize", 1)),
            temporal_attention_nhead=int(pk.get("temporal_attention_nhead", 8)),
            temporal_pe_max_len=int(pk.get("temporal_position_encoding_max_len", 16)),
        )
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
    Every matrix is random, the groups ``init_structural_zeros_`` zeroes
    included, so every conditioning path changes the output."""
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


# The JAX package's zero-initialised parameters: the LoRA up-projections
# (synfmc_tpu/models/attention.py:38-40), the pose merges (:91-114) and the
# ObjectAdapter's zero convs (models/adapter.py:47,64); with
# motion_module_kwargs.zero_initialize also each motion module's proj_out
# (models/motion_module.py:128-129).
_STRUCTURAL_ZEROS = re.compile(
    r"(\.processor\.to_(q|k|v|out)_lora\.up\.weight"
    r"|\.processor\.(qkv|q|kv)_merge\.(weight|bias)"
    r"|^(zero_conv_in|zero_conv_out_list\.\d+)\.(weight|bias))$")
_MOTION_PROJ_OUT = re.compile(r"motion_modules\.\d+\.temporal_transformer\.proj_out\.(weight|bias)$")


@torch.no_grad()
def init_structural_zeros_(models: dict, config: dict) -> dict:
    """Zero the groups the JAX package initialises to zero, in place."""
    mm = (config.get("unet_additional_kwargs") or {}).get("motion_module_kwargs") or {}
    zero_proj_out = bool(mm.get("zero_initialize", False))
    for module in models.values():
        for name, p in module.named_parameters():
            if _STRUCTURAL_ZEROS.search(name) or (zero_proj_out and _MOTION_PROJ_OUT.search(name)):
                p.zero_()
    return models


def init_models(config: dict, stage: str, seed: int, device) -> dict:
    """The stage's modules on ``device`` in fp32, as the JAX package starts
    them: seeded random weights from one generator in build order (unet,
    vae, text, pose encoder, adapter), then its structural zeros."""
    with torch.device(device):
        models = build_models(config, stage)
    gen = torch.Generator(device=device).manual_seed(seed)
    for module in models.values():
        init_random_(module, gen)
    return init_structural_zeros_(models, config)


def cast_models_(models: dict, dtype: torch.dtype) -> dict:
    """Every module to ``dtype`` and channels-last, in place."""
    for module in models.values():
        module.to(dtype=dtype, memory_format=torch.channels_last)
    return models


def randomize_pipeline_(pipe: AnimationPipeline, seed: int) -> AnimationPipeline:
    """``init_random_`` over every module of ``pipe`` from one generator seeded
    with ``seed``, in build order (unet, vae, text, pose encoder, adapter):
    seeded weights with every conditioning path live, for smoke runs and
    tests that drive those paths without checkpoints."""
    gen = torch.Generator(device=pipe.device).manual_seed(seed)
    for module in (pipe.unet, pipe.vae, pipe.text_encoder, pipe.pose_encoder, pipe.adapter):
        if module is not None:
            init_random_(module, gen)
    return pipe


def build_pipeline(config, *, stage: Optional[str] = None, seed: int = 42,
                   video_length: int = 16, lora_ckpt: Optional[str] = None,
                   cm_ckpt: Optional[str] = None, omcm_ckpt: Optional[str] = None,
                   allow_untrained_cm: bool = False, data_parallel: int = 0,
                   frame_parallel: int = 0, batch: int = 1, device=None,
                   dtype: Optional[torch.dtype] = None) -> tuple[AnimationPipeline, dict]:
    """Build an AnimationPipeline from a reference-format config (a dict or a
    YAML path) and its checkpoint files.  Returns ``(pipe, info)``; info
    holds ``stage``, ``sample_size`` (train_data.params.sample_size),
    ``models``, ``schedule`` and ``meta`` (load_pretrained's).

    ``stage`` defaults to "obj" with an ``omcm_ckpt``, else "cam";
    ``lora_ckpt`` and ``cm_ckpt`` override the config's ``lora_ckpt`` and
    ``pretrained_cm_path``; the obj stage needs a CMC file unless
    ``allow_untrained_cm``.  ``seed`` makes the weights no file covers.
    ``video_length`` is the JAX package's keyword (its parameter init takes
    shapes from it; the port's modules take any).  The mesh, as
    synfmc_tpu/pipelines/factory.py builds it: ``frame_parallel`` S > 0
    makes a ``data`` = 2 x ``batch`` by ``sp`` = S serving mesh (the CFG pair
    rides ``data``), else ``data_parallel`` N > 0 a ``data`` = N one; it
    needs a process group of exactly that many ranks (``parallel.mesh.
    init_distributed`` under ``python -m torch.distributed.run``) and raises
    otherwise.  ``device`` defaults to ``cuda`` (raises without a GPU;
    under a process group the rank's device); ``dtype`` to bf16 when the
    config sets ``mixed_precision_training`` (the default), else fp32."""
    mesh = None
    if frame_parallel:
        if data_parallel not in (0, 2 * batch):
            raise ValueError(f"frame_parallel puts the CFG pair on the data axis: data_parallel "
                             f"must be 0 or 2 * batch = {2 * batch}, got {data_parallel}")
        mesh = serving_mesh(2 * batch, frame_parallel)
    elif data_parallel:
        mesh = serving_mesh(data_parallel)
    config = dict(load_config(config))
    if lora_ckpt:
        config["lora_ckpt"] = lora_ckpt
    if cm_ckpt:
        config["pretrained_cm_path"] = cm_ckpt
    if allow_untrained_cm:
        config["allow_untrained_cm"] = True
    if stage is None:
        stage = "obj" if omcm_ckpt else "cam"
    if omcm_ckpt and stage != "obj":
        raise ValueError(f"an OMC bundle needs stage='obj', not {stage!r}")
    validate_pretrained_paths(config, stage)
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if config.get("mixed_precision_training", True) else torch.float32
    models = init_models(config, stage, seed, dev)
    cast_models_(models, dtype)
    models, meta = load_pretrained(models, config, stage, logger)
    if omcm_ckpt:
        bundle = torch_load_state_dict(omcm_ckpt)
        load_into_module(models["adapter"], bundle["omcm_state_dict"], "adapter")
        logger.info(f"loaded OMC adapter from {omcm_ckpt}")
    schedule = DiffusionSchedule.from_config(**(config.get("noise_scheduler_kwargs") or {}))
    tokenizer = load_tokenizer(config.get("pretrained_model_path"),
                               strict=bool(config.get("strict_pretrained", False)))
    pipe = AnimationPipeline(
        unet=models["unet"], vae=models["vae"], text_encoder=models["text"],
        tokenizer=tokenizer, schedule=schedule, pose_encoder=models.get("pose_encoder"),
        adapter=models.get("adapter"), device=dev, mesh=mesh,
    )
    sample_size = tuple((config.get("train_data") or {}).get("params", {})
                        .get("sample_size", (256, 384)))
    info = dict(stage=stage, sample_size=sample_size, models=models, schedule=schedule,
                meta=meta)
    return pipe, info
