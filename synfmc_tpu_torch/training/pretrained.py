"""Pretrained weights for a stage's modules, from the config's checkpoint paths.

The counterpart of synfmc_tpu/training/trainers.py:load_pretrained (:227)
and validate_pretrained_paths (:308), loading in place into the port's
modules: the SD1.5 directory, the AnimateDiff motion modules, the stage-1
LoRA bundle, the stage-2 CMC bundle and, for the obj stage, the OMC bundle
of ``omcm_config.pretrained``.

Path rules, as in the JAX package: a '[path to ...]' placeholder or an empty
value is skipped quietly; a configured path that does not exist is logged
at ERROR, and is fatal under ``strict_pretrained: true``.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from synfmc_tpu_torch.config import is_placeholder_path
from synfmc_tpu_torch.interop.sd_loader import load_sd15
from synfmc_tpu_torch.training.checkpoint import load_into_module, torch_load_state_dict

logger = logging.getLogger(__name__)


def _real_path(p) -> bool:
    return bool(p) and os.path.exists(str(p))


def load_pretrained(models: dict, config: dict, stage: str,
                    log: Optional[logging.Logger] = None) -> tuple[dict, dict]:
    """Load every configured checkpoint into ``models`` (keys unet, vae,
    text, pose_encoder and, for the obj stage, adapter).  Returns ``(models,
    meta)``; meta holds ``omcm_global_step`` when an OMC bundle loaded."""
    log = log or logger
    meta: dict = {}
    strict = bool(config.get("strict_pretrained", False))

    def real(p) -> bool:
        if not p:
            return False
        if _real_path(p):
            return True
        if is_placeholder_path(p):
            return False
        msg = (f"configured checkpoint path does not exist: {str(p)!r} — "
               f"the affected weights stay at their initial values")
        if strict:
            raise FileNotFoundError(f"strict_pretrained: {msg}")
        log.error(msg + " (set strict_pretrained: true to make this fatal)")
        return False

    sd_path = config.get("pretrained_model_path")
    if real(sd_path):
        load_sd15(models, str(sd_path), config.get("unet_subfolder", "unet"))
        log.info(f"loaded SD1.5 weights from {sd_path}")
    mm_path = config.get("motion_module_ckpt")
    if real(mm_path):
        sd = torch_load_state_dict(str(mm_path))
        load_into_module(models["unet"], sd.get("state_dict", sd), "unet")
        log.info(f"loaded AnimateDiff motion modules from {mm_path}")
    lora_path = config.get("lora_ckpt")
    if real(lora_path):
        bundle = torch_load_state_dict(str(lora_path))
        load_into_module(models["unet"], bundle["lora_state_dict"], "unet")
        log.info(f"loaded stage-1 LoRA from {lora_path}")
    cm_path = config.get("pretrained_cm_path")
    if real(cm_path):
        bundle = torch_load_state_dict(str(cm_path))
        load_into_module(models["pose_encoder"], bundle["pose_encoder_state_dict"],
                         "pose_encoder")
        load_into_module(models["unet"], bundle["attention_processor_state_dict"], "unet")
        if "mm_state_dict" in bundle:
            # the reference's stage 3 reads only the pose encoder and the
            # attention processors of a CMC bundle (train_cam_obj_ctrl.py:283-292)
            log.info("stage-2 bundle carries mm_state_dict (train_mm run); the "
                     "reference stage-3 load path ignores it — matching that")
        log.info(f"loaded stage-2 CMC from {cm_path}")
    if stage == "obj":
        om_path = (config.get("omcm_config") or {}).get("pretrained")
        if real(om_path):
            bundle = torch_load_state_dict(str(om_path))
            load_into_module(models["adapter"], bundle["omcm_state_dict"], "adapter")
            meta["omcm_global_step"] = int(bundle.get("global_step", 0))
            log.info(f"loaded pretrained OMC adapter from {om_path} "
                     f"(global_step {meta['omcm_global_step']})")
    return models, meta


def validate_pretrained_paths(config: dict, stage: str) -> None:
    """Fail before any model is built when the obj stage has no trained CMC
    checkpoint (train_cam_obj_ctrl.py:280); ``allow_untrained_cm`` opts out."""
    cm_path = config.get("pretrained_cm_path")
    if stage == "obj" and not _real_path(cm_path) and not config.get("allow_untrained_cm", False):
        raise FileNotFoundError(
            f"stage 3 requires a trained stage-2 CMC checkpoint; "
            f"pretrained_cm_path={cm_path!r} does not exist "
            f"(set allow_untrained_cm: true to bypass in smoke tests)")
