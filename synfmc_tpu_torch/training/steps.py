"""The stage-2 (CMC) train step (synfmc_tpu/training/steps.py).

One step: background-caption swap and per-sample text and camera CFG
dropout, the frozen VAE encode of every frame to a sampled latent, noise and
timesteps, CLIP text encode, Plücker rays, then the pose encoder and UNet
forward and backward for the masked diffusion loss, then clip + AdamW.

The random draws are split from the math: :func:`draw_cam` makes every draw
of a step (the JAX package's key streams 0-5 and 7) into one
:class:`CamDraws` record, and the grads function takes that record, so both
frameworks can be handed the same draws.

Mixed precision: the model holds the trainable tensors in its working type
(bf16) and :class:`TrainState` keeps fp32 masters that the optimizer
updates and copies back.  Gradients are taken on the bf16 copies and cast
to fp32 before the clip, which is numerically what flax does with fp32
params under ``dtype=bf16``.  In an fp32 model the masters are the model's
own tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from synfmc_tpu_torch.diffusion.scheduler import DiffusionSchedule
from synfmc_tpu_torch.geometry.plucker import plucker_embedding
from synfmc_tpu_torch.training.losses import appearance_debias_loss, masked_diffusion_loss


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static stage-2 hyperparameters (from the YAML config)."""

    cfg_random_null_text_ratio: float = 0.1
    background_caption_prob: float = 0.4
    apply_masked_loss: bool = False
    invert_loss_mask: bool = True
    mask_loss_weight: float = 1.0
    sd_loss_weight: float = 0.6
    appearance_debias: float = 0.0
    sample_height: int = 256
    sample_width: int = 384


@dataclasses.dataclass
class CamDraws:
    """Every random draw of one stage-2 step."""

    use_background: torch.Tensor  # () bool: swap in the background captions (whole batch)
    text_drop: torch.Tensor       # (B,) bool: null text
    camera_drop: torch.Tensor     # (B,) bool: zero camera
    vae_eps: torch.Tensor         # (B*F, H/8, W/8, 4) standard normal for the VAE sample
    noise: torch.Tensor           # (B, F, H/8, W/8, 4) diffusion noise
    timesteps: torch.Tensor       # (B,) int64 in [0, T)
    anchor: torch.Tensor          # (B,) int64 appearance-debias anchor frame

    def to(self, device) -> "CamDraws":
        return CamDraws(**{f.name: getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)})


def draw_cam(generator: torch.Generator, batch: dict, cfg: StepConfig,
             schedule: DiffusionSchedule) -> CamDraws:
    """The draws of one step from ``generator`` (on its device)."""
    b, f, h, w = batch["pixel_values"].shape[:4]
    dev = generator.device
    uniform = lambda *shape: torch.rand(shape, generator=generator, device=dev)
    normal = lambda *shape: torch.randn(shape, generator=generator, device=dev)
    return CamDraws(
        use_background=uniform() < cfg.background_caption_prob,
        text_drop=uniform(b) < cfg.cfg_random_null_text_ratio,
        camera_drop=uniform(b) < cfg.cfg_random_null_text_ratio,
        vae_eps=normal(b * f, h // 8, w // 8, 4),
        noise=normal(b, f, h // 8, w // 8, 4),
        timesteps=schedule.sample_timesteps(generator, b),
        anchor=torch.randint(0, f, (b,), generator=generator, device=dev),
    )


def rt_to_c2w(rt: torch.Tensor) -> torch.Tensor:
    """(B, F, 12) relative camera rows -> homogeneous (B, F, 4, 4)."""
    b, f = rt.shape[:2]
    m = rt.reshape(b, f, 3, 4)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=m.dtype, device=m.device)
    return torch.cat([m, bottom.expand(b, f, 1, 4)], dim=2)


def _select_text(batch: dict, draws: CamDraws, cfg: StepConfig) -> torch.Tensor:
    """Background-caption swap (whole batch), then per-sample null dropout."""
    ids = batch["input_ids"]
    if "background_ids" in batch:
        ids = torch.where(draws.use_background, batch["background_ids"], ids)
    if cfg.cfg_random_null_text_ratio > 0:
        ids = torch.where(draws.text_drop[:, None], batch["null_ids"][None, :], ids)
    return ids


def encode_latents(vae, pixels: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """(B, F, H, W, 3) in [-1, 1] -> (B, F, H/8, W/8, 4) sampled, scaled latents."""
    b, f = pixels.shape[:2]
    z = vae.encode(pixels.reshape(b * f, *pixels.shape[2:]), eps)
    return z.reshape(b, f, *z.shape[1:])


def make_cam_grads_fn(unet, pose_encoder, vae, text_encoder, schedule: DiffusionSchedule,
                      cfg: StepConfig = StepConfig(apply_masked_loss=True)) -> Callable:
    """Stage 2 (CMC): ``grads_fn(trainable, batch, draws) -> (grads, metrics)``.

    ``trainable`` maps names to the model tensors that train (the others have
    ``requires_grad=False``); ``grads`` maps the same names to their
    gradients, in the tensors' own type.  batch: pixel_values (B, F, H, W, 3),
    input_ids / background_ids (B, 77), null_ids (77,), camera_rt (B, F, 12),
    intrinsics (B, F, 4), obj_union_mask (B, F, H, W, 1), optional flip_flag (B,).
    """

    def grads_fn(trainable: dict, batch: dict, draws: CamDraws):
        with torch.no_grad():
            ids = _select_text(batch, draws, cfg)
            rt = batch["camera_rt"]
            if cfg.cfg_random_null_text_ratio > 0:  # camera CFG dropout -> zeros
                rt = rt * (1.0 - draws.camera_drop[:, None, None].to(rt.dtype))
            latents = encode_latents(vae, batch["pixel_values"], draws.vae_eps)
            noise = draws.noise.to(latents.dtype)
            t = draws.timesteps
            noisy = schedule.add_noise(latents, noise, t)
            context = text_encoder(ids)
            plucker = plucker_embedding(batch["intrinsics"], rt_to_c2w(rt), cfg.sample_height,
                                        cfg.sample_width, flip_flag=batch.get("flip_flag"))
        for p in trainable.values():
            p.grad = None
        pose_feats = pose_encoder(plucker)
        pred = unet(noisy, t, context, pose_features=pose_feats)
        loss, metrics = masked_diffusion_loss(
            pred, noise, batch.get("obj_union_mask") if cfg.apply_masked_loss else None,
            cfg.invert_loss_mask, cfg.mask_loss_weight, cfg.sd_loss_weight)
        if cfg.appearance_debias > 0:
            loss = loss + cfg.appearance_debias * appearance_debias_loss(pred, noise, draws.anchor)
        loss.backward()
        grads = {name: p.grad for name, p in trainable.items()}
        return grads, {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}}

    return grads_fn


@dataclasses.dataclass
class TrainState:
    step: int
    trainable: dict        # name -> model tensor (the working copy)
    masters: dict          # name -> fp32 master (the same tensor in an fp32 model)
    optimizer: object      # optim.ClipAdamW over the masters


def init_train_state(trainable: dict, tx: Callable,
                     masters: Optional[dict] = None) -> TrainState:
    """``tx``: optim.make_optimizer's factory.  ``masters`` (fp32, by name)
    defaults to fp32 copies of the trainable tensors, or those tensors
    themselves when they are fp32 already."""
    if masters is None:
        masters = {n: p if p.dtype == torch.float32 else p.detach().float().clone()
                   for n, p in trainable.items()}
    return TrainState(step=0, trainable=trainable, masters=masters,
                      optimizer=tx([masters[n] for n in trainable]))


@torch.no_grad()
def apply_grads(state: TrainState, grads: dict) -> TrainState:
    """Clip + AdamW on the fp32 masters, then copy them into the model."""
    state.optimizer.step([grads[n].float() for n in state.trainable])
    for n, p in state.trainable.items():
        master = state.masters[n]
        if master is not p:
            p.copy_(master)
            master.grad = None
    state.step += 1
    return state


def step_from_grads(grads_fn: Callable) -> Callable:
    """grads_fn -> ``step_fn(state, batch, draws) -> (state, metrics)``."""

    def step_fn(state: TrainState, batch: dict, draws: CamDraws):
        grads, metrics = grads_fn(state.trainable, batch, draws)
        return apply_grads(state, grads), metrics

    return step_fn


def make_cam_train_step(unet, pose_encoder, vae, text_encoder, schedule: DiffusionSchedule,
                        cfg: StepConfig = StepConfig(apply_masked_loss=True)) -> Callable:
    return step_from_grads(make_cam_grads_fn(unet, pose_encoder, vae, text_encoder, schedule, cfg))
