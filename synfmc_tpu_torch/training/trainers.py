"""The stage-2 trainer entry point (synfmc_tpu/training/trainers.py:train,
its cam-stage part).

``train("cam", config, batches, max_steps)`` builds the cam-stage modules
from a reference-format YAML config with seeded random weights, marks the
stage-2 trainable set (pose-merge projections of the UNet, the whole pose
encoder; with ``train_mm`` also the motion modules' norm / proj_in /
proj_out), and takes ``max_steps`` clip + AdamW steps on raw batches in the
collate format of the JAX package's ``UnrealTrajVideoDataset``, read from an
iterable.  It runs on the GPU unless ``device="cpu"`` is asked for.

Not ported yet: the data loader, checkpoints and resume, validation
renders, gradient accumulation and rematerialisation, stages 1 and 3, and
the multi-device mesh.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from synfmc_tpu_torch.config import load_config
from synfmc_tpu_torch.data.tokenizer import HashTokenizer
from synfmc_tpu_torch.device import resolve_device
from synfmc_tpu_torch.diffusion.scheduler import DiffusionSchedule
from synfmc_tpu_torch.pipelines.factory import build_models, init_random_
from synfmc_tpu_torch.training.optim import make_optimizer
from synfmc_tpu_torch.training.params import (
    count_params,
    partition_params,
    stage2_cmc_unet_trainable,
    stage3_mm_trainable,
)
from synfmc_tpu_torch.training.steps import (
    CamDraws,
    StepConfig,
    TrainState,
    draw_cam,
    init_train_state,
    make_cam_train_step,
)

logger = logging.getLogger(__name__)

_UNSUPPORTED = {
    "gradient_accumulation_steps": 1,
    "gradient_checkpointing": False,
}


def step_config(config: dict) -> StepConfig:
    """The stage-2 StepConfig the JAX trainer derives from a config (the loss
    mask inverted: stage 2 weighs the background)."""
    sample_size = tuple((config.get("train_data") or {}).get("params", {})
                        .get("sample_size", (256, 384)))
    ratio = (float(config.get("cfg_random_null_text_ratio", 0.1))
             if config.get("cfg_random_null_text", True) else 0.0)
    return StepConfig(
        cfg_random_null_text_ratio=ratio,
        apply_masked_loss=bool(config.get("apply_masked_loss", False)),
        invert_loss_mask=True,
        mask_loss_weight=float(config.get("mask_loss_weight", 1.0)),
        sd_loss_weight=float(config.get("sd_loss_weight", 1.0)),
        appearance_debias=float(config.get("appearance_debias", 0.0)),
        sample_height=int(sample_size[0]),
        sample_width=int(sample_size[1]),
    )


def host_batch(raw: dict, tokenizer, device) -> dict:
    """A collated raw batch (numpy arrays, caption lists) -> the step's tensors."""
    t = lambda x: torch.as_tensor(np.asarray(x), device=device)
    batch = {
        "pixel_values": t(raw["pixel_values"]).float(),
        "input_ids": t(tokenizer(raw["captions"])).long(),
        "background_ids": t(tokenizer(raw["background_captions"])).long(),
        "null_ids": t(tokenizer([""])[0]).long(),
        "camera_rt": t(raw["camera_rt"]).float(),
        "intrinsics": t(raw["intrinsics"]).float(),
        "obj_union_mask": t(raw["obj_union_mask"]).float(),
    }
    if "flip_flag" in raw:
        batch["flip_flag"] = t(raw["flip_flag"]).bool()
    return batch


def _checksum(params) -> float:
    return float(sum(p.detach().double().abs().sum() for p in params))


def train(stage: str, config, batches: Iterable[dict], max_steps: int, device=None,
          seed: Optional[int] = None,
          on_step: Optional[Callable[[TrainState, dict, CamDraws], None]] = None) -> dict:
    """Run ``max_steps`` stage-2 steps; returns summary metrics.

    ``config``: a config dict or YAML path (configs/cam.yaml).  ``batches``:
    an iterable of collated raw batches.  ``seed`` defaults to the config's
    ``global_seed``: it makes the weights and, with the step index alone,
    each step's draws.  ``on_step(state, metrics, draws)`` is called after
    every step.  The result holds the per-step losses and wall times, the
    trainable and frozen parameter counts, and checksums (sum of |w|) of the
    trainable and frozen weights before and after training.
    """
    if stage != "cam":
        raise NotImplementedError(f"stage {stage!r} is not ported yet (only 'cam')")
    config = load_config(config)
    for key, default in _UNSUPPORTED.items():
        if config.get(key, default) not in (default, None):
            raise NotImplementedError(f"{key}={config[key]!r} is not ported yet")
    dev = resolve_device(device)
    seed = int(config.get("global_seed", 42)) if seed is None else int(seed)
    dtype = torch.bfloat16 if config.get("mixed_precision_training", True) else torch.float32

    with torch.device(dev):
        models = build_models(config)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name in ("unet", "vae", "text", "pose_encoder"):
        init_random_(models[name], gen)
    train_mm = bool(config.get("train_mm", False))
    unet_rule = lambda n: stage2_cmc_unet_trainable(n) or (train_mm and stage3_mm_trainable(n))
    trainable = {**partition_params(models["unet"], unet_rule, "unet."),
                 **partition_params(models["pose_encoder"], lambda n: True, "pose_encoder.")}
    for name in ("vae", "text"):
        partition_params(models[name], lambda n: False)
    # fp32 masters taken before the cast; an fp32 model's tensors are their own masters
    masters = ({n: p.detach().clone() for n, p in trainable.items()}
               if dtype != torch.float32 else None)
    for m in models.values():
        m.to(dtype=dtype, memory_format=torch.channels_last)
    frozen = [p for m in models.values() for p in m.parameters() if not p.requires_grad]

    schedule = DiffusionSchedule.from_config(**(config.get("noise_scheduler_kwargs") or {}))
    cfg = step_config(config)
    tx = make_optimizer(
        float(config.get("learning_rate", 1e-4)),
        adam_beta1=float(config.get("adam_beta1", 0.9)),
        adam_beta2=float(config.get("adam_beta2", 0.999)),
        adam_epsilon=float(config.get("adam_epsilon", 1e-8)),
        adam_weight_decay=float(config.get("adam_weight_decay", 1e-2)),
        max_grad_norm=float(config.get("max_grad_norm", 1.0)),
        lr_scheduler=str(config.get("lr_scheduler", "constant")),
        lr_warmup_steps=int(config.get("lr_warmup_steps", 0)),
        max_train_steps=max_steps,
    )
    state = init_train_state(trainable, tx, masters)
    step_fn = make_cam_train_step(models["unet"], models["pose_encoder"], models["vae"],
                                  models["text"], schedule, cfg)
    n_train, n_frozen = count_params(trainable.values()), count_params(frozen)
    logger.info(f"stage=cam device={dev} dtype={dtype} trainable params: {n_train / 1e6:.2f}M; "
                f"frozen: {n_frozen / 1e6:.2f}M")
    checksums = {"trainable": [_checksum(trainable.values())], "frozen": [_checksum(frozen)]}

    tokenizer = HashTokenizer()
    step_gen = torch.Generator(device=dev)
    losses, step_s, last = [], [], {}
    it = iter(batches)
    t_start = time.perf_counter()
    for step in range(max_steps):
        t0 = time.perf_counter()
        batch = host_batch(next(it), tokenizer, dev)
        step_gen.manual_seed(seed * 1_000_003 + step)  # step k's draws: a function of (seed, k)
        draws = draw_cam(step_gen, batch, cfg, schedule)
        state, metrics = step_fn(state, batch, draws)
        last = {k: float(v) for k, v in metrics.items()}  # waits for the step
        step_s.append(time.perf_counter() - t0)
        losses.append(last["loss"])
        logger.info(f"step {state.step}/{max_steps} loss {last['loss']:.4f} "
                    f"lr {state.optimizer.schedule(state.step - 1):.2e} iter {step_s[-1]:.3f}s")
        if on_step is not None:
            on_step(state, metrics, draws)
    checksums["trainable"].append(_checksum(trainable.values()))
    checksums["frozen"].append(_checksum(frozen))
    return {**last, "steps": state.step, "losses": losses, "step_s": step_s,
            "wall_s": time.perf_counter() - t_start, "trainable_params": n_train,
            "frozen_params": n_frozen, "checksums": checksums}
