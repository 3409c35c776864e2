"""Text- and camera-conditioned CFG video generation.

The exact path of synfmc_tpu/pipelines/animation.py: CLIP text encode
(batch order [uncond, cond]), the pose encoder run once per request and its
features shared by both CFG branches, the DDIM loop over the UNet on the
stacked pair, and the frame-wise VAE decode.  Traj features ride the cond
branch only (uncond zeroed) and are gated off when t < omcm_min_step.  The
CFG combine runs in the UNet's type, the DDIM update in fp32.

Not ported yet, and refused when asked for: multidiff windows, DeepCache,
CFG-cache, DPM-Solver++ and the multi-device mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from synfmc_tpu_torch.device import resolve_device
from synfmc_tpu_torch.diffusion.scheduler import DiffusionSchedule


@dataclasses.dataclass
class AnimationPipeline:
    unet: torch.nn.Module
    vae: torch.nn.Module
    text_encoder: torch.nn.Module
    tokenizer: Callable
    schedule: DiffusionSchedule
    pose_encoder: Optional[torch.nn.Module] = None
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for m in (self.unet, self.vae, self.text_encoder, self.pose_encoder):
            if m is not None:
                m.to(self.device).eval()

    @torch.inference_mode()
    def encode_prompt(self, prompts, negative_prompts=None) -> torch.Tensor:
        """(2B, 77, hidden) text embeddings, uncond first."""
        if isinstance(prompts, str):
            prompts = [prompts]
        if negative_prompts is None:
            negative_prompts = [""] * len(prompts)
        elif isinstance(negative_prompts, str):
            negative_prompts = [negative_prompts] * len(prompts)
        ids = torch.as_tensor(self.tokenizer(list(negative_prompts) + list(prompts)),
                              device=self.device)
        return self.text_encoder(ids)

    @torch.inference_mode()
    def encode_pose(self, plucker: torch.Tensor) -> list[torch.Tensor]:
        if self.pose_encoder is None:
            raise ValueError("pipeline built without a pose encoder")
        return self.pose_encoder(plucker.to(self.device))

    @torch.inference_mode()
    def __call__(self, prompts, video_length: int = 16, height: int = 256, width: int = 384,
                 num_inference_steps: int = 25, guidance_scale: float = 8.0,
                 negative_prompts=None, generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None, plucker: Optional[torch.Tensor] = None,
                 traj_features: Optional[Sequence[torch.Tensor]] = None,
                 omcm_min_step: int = 700, multidiff_total_steps: int = 1,
                 deepcache_interval: int = 1, cfg_cache_interval: int = 1,
                 solver: str = "ddim", decode: bool = True,
                 on_step: Optional[Callable[[int, int], None]] = None):
        """Returns (B, F, H, W, 3) in [0, 1] when ``decode`` else the final latents.
        ``on_step(idx, t)`` is called after each denoise step."""
        if multidiff_total_steps != 1:
            raise NotImplementedError("multidiff windows are not ported yet")
        if deepcache_interval != 1 or cfg_cache_interval != 1:
            raise NotImplementedError("DeepCache and CFG-cache are not ported yet")
        if solver != "ddim":
            raise NotImplementedError(f"solver {solver!r} is not ported yet (only 'ddim')")
        context = self.encode_prompt(prompts, negative_prompts)
        batch = context.shape[0] // 2
        if latents is None:
            if generator is None:
                raise ValueError("need a generator or explicit latents")
            latents = torch.randn((batch, video_length, height // 8, width // 8, 4),
                                  generator=generator, device=generator.device,
                                  dtype=torch.float32) * self.schedule.init_noise_sigma
        latents = latents.to(self.device, torch.float32)
        pose_features = self.encode_pose(plucker) if plucker is not None else None
        if traj_features is not None:
            traj_features = [t.to(self.device) for t in traj_features]
        latents = denoise_loop(self.unet, self.schedule, latents, context,
                               pose_features=pose_features, traj_features=traj_features,
                               num_inference_steps=num_inference_steps,
                               guidance_scale=guidance_scale, omcm_min_step=omcm_min_step,
                               on_step=on_step)
        if not decode:
            return latents
        return decode_latents(self.vae, latents)


@torch.inference_mode()
def denoise_loop(unet, schedule: DiffusionSchedule, latents: torch.Tensor, context: torch.Tensor,
                 pose_features=None, traj_features=None, num_inference_steps: int = 25,
                 guidance_scale: float = 8.0, omcm_min_step: int = 700,
                 on_step: Optional[Callable[[int, int], None]] = None) -> torch.Tensor:
    """Exact CFG DDIM loop; ``on_step(idx, t)`` is called after each step."""
    dtype = unet.dtype
    pose_cfg = None
    if pose_features is not None:
        pose_cfg = [torch.cat([p, p], dim=0).to(dtype) for p in pose_features]
    traj_cfg = None
    if traj_features is not None:
        traj_cfg = [torch.cat([torch.zeros_like(tr), tr], dim=0).to(dtype) for tr in traj_features]
    for idx, t in enumerate(schedule.ddim_timesteps(num_inference_steps).tolist()):
        latent_in = torch.cat([latents, latents], dim=0)
        traj_t = None
        if traj_cfg is not None:
            traj_t = traj_cfg if t >= omcm_min_step else [torch.zeros_like(tr) for tr in traj_cfg]
        t_vec = torch.full((latent_in.shape[0],), t, dtype=torch.int64, device=latents.device)
        eps = unet(latent_in, t_vec, context, pose_features=pose_cfg, traj_features=traj_t)
        uncond, cond = eps.chunk(2, dim=0)
        eps_cfg = uncond + guidance_scale * (cond - uncond)
        latents = schedule.ddim_step(eps_cfg, t, latents, num_inference_steps)
        if on_step is not None:
            on_step(idx, t)
    return latents


@torch.inference_mode()
def decode_latents(vae, latents: torch.Tensor) -> torch.Tensor:
    """Frame-wise VAE decode -> (B, F, H, W, 3) in [0, 1]; /0.18215 inside ``vae.decode``."""
    b, f, h, w, c = latents.shape
    frames = latents.reshape(b * f, h, w, c)
    images = torch.stack([vae.decode(frames[i:i + 1])[0] for i in range(b * f)])
    images = (images / 2.0 + 0.5).clamp(0.0, 1.0)
    return images.reshape(b, f, *images.shape[1:])
