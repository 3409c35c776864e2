"""Text-, camera- and object-conditioned CFG video generation.

The sampler of synfmc_tpu/pipelines/animation.py in eager PyTorch: CLIP text
encode (batch order [uncond, cond]), the pose encoder run once per request
and its features shared by both CFG branches, the object adapter run once
per request on the rasterized trajectories, the denoise loop over the UNet on
the stacked pair, and the VAE decode, ``decode_chunk`` frames a call.  Traj
features ride the cond branch only (uncond zeroed) and are gated off when
t < omcm_min_step.  The CFG combine runs in the UNet's type, the solver's
update in fp32.

Modes of ``denoise_loop``, as in the JAX package:
- ``solver``: "ddim" (exact) or "dpmpp_2m" (DPM-Solver++(2M) on the same
  timesteps; it also carries the previous step's x0 prediction);
- ``deepcache_interval`` k > 1: every k-th step runs the full UNet and keeps
  up_blocks[2]'s output; the others run only the shallow level on it;
- ``cfg_cache_interval`` k > 1: every k-th step runs the full CFG pair and
  keeps the uncond eps; the others run the cond branch alone at batch B;
- both ("turbo", equal intervals): cached steps run the shallow level on the
  cond branch, the deep cache kept at batch B;
- ``multidiff_total_steps`` M > 1: M overlapping windows of ``window_length``
  frames, each with its slice of the pose features and no traj features, eps
  averaged over the windows that cover a frame.
The cache modes need M = 1, and traj features need M = 1.  The JAX package's
multi-device mesh is not part of this port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from synfmc_tpu_torch.device import resolve_device
from synfmc_tpu_torch.diffusion.scheduler import DiffusionSchedule
from synfmc_tpu_torch.utils.traj_features import traj_features_from_adapter

SOLVERS = ("ddim", "dpmpp_2m")


@dataclasses.dataclass
class AnimationPipeline:
    unet: torch.nn.Module
    vae: torch.nn.Module
    text_encoder: torch.nn.Module
    tokenizer: Callable
    schedule: DiffusionSchedule
    pose_encoder: Optional[torch.nn.Module] = None
    adapter: Optional[torch.nn.Module] = None
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for m in (self.unet, self.vae, self.text_encoder, self.pose_encoder, self.adapter):
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
    def encode_traj(self, traj_raster: torch.Tensor, mask: torch.Tensor,
                    num_frames: int) -> list[torch.Tensor]:
        """OMC raster (B*F, H, W, 13) and mask (B*F, H, W, 1), as
        ``utils.traj_features.build_adapter_inputs`` makes them -> 4 traj
        feature videos (B, F, H/8/2^i, W/8/2^i, C_i)."""
        if self.adapter is None:
            raise ValueError("pipeline built without an object adapter")
        return traj_features_from_adapter(self.adapter, traj_raster.to(self.device),
                                          mask.to(self.device), num_frames)

    @torch.inference_mode()
    def __call__(self, prompts, video_length: int = 16, height: int = 256, width: int = 384,
                 num_inference_steps: int = 25, guidance_scale: float = 8.0,
                 negative_prompts=None, generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None, plucker: Optional[torch.Tensor] = None,
                 traj_features: Optional[Sequence[torch.Tensor]] = None,
                 omcm_min_step: int = 700, multidiff_total_steps: int = 1,
                 multidiff_overlaps: int = 12, deepcache_interval: int = 1,
                 cfg_cache_interval: int = 1, solver: str = "ddim", decode: bool = True,
                 decode_chunk: int = 1, on_step: Optional[Callable[[int, int], None]] = None):
        """Returns (B, F_total, H, W, 3) in [0, 1] when ``decode`` else the
        final latents; F_total = M (F - overlap) + overlap for M =
        ``multidiff_total_steps`` windows of F = ``video_length`` frames.
        ``plucker`` covers all F_total frames.  ``on_step(idx, t)`` is called
        after each denoise step."""
        check_modes(multidiff_total_steps, deepcache_interval, cfg_cache_interval, solver,
                    traj_features is not None)
        context = self.encode_prompt(prompts, negative_prompts)
        batch = context.shape[0] // 2
        total_frames = (multidiff_total_steps * (video_length - multidiff_overlaps)
                        + multidiff_overlaps)
        if latents is None:
            if generator is None:
                raise ValueError("need a generator or explicit latents")
            latents = torch.randn((batch, total_frames, height // 8, width // 8, 4),
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
                               window_length=video_length,
                               multidiff_total_steps=multidiff_total_steps,
                               multidiff_overlaps=multidiff_overlaps,
                               deepcache_interval=deepcache_interval,
                               cfg_cache_interval=cfg_cache_interval, solver=solver,
                               on_step=on_step)
        if not decode:
            return latents
        return decode_latents(self.vae, latents, decode_chunk=decode_chunk)


def check_modes(multidiff_total_steps: int, deepcache_interval: int, cfg_cache_interval: int,
                solver: str, omc: bool) -> None:
    """Raise ValueError for a combination the JAX sampler refuses."""
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r} (want one of {SOLVERS})")
    if multidiff_total_steps < 1 or deepcache_interval < 1 or cfg_cache_interval < 1:
        raise ValueError("multidiff_total_steps and the cache intervals must be >= 1")
    if (deepcache_interval > 1 or cfg_cache_interval > 1) and multidiff_total_steps != 1:
        raise ValueError("the cache modes require multidiff_total_steps == 1")
    if deepcache_interval > 1 and cfg_cache_interval > 1 and deepcache_interval != cfg_cache_interval:
        raise ValueError("DeepCache with CFG-cache (turbo) needs equal intervals, got "
                         f"{deepcache_interval} and {cfg_cache_interval}")
    if omc and multidiff_total_steps != 1:
        raise ValueError("object conditioning requires multidiff_total_steps == 1")


@torch.inference_mode()
def denoise_loop(unet, schedule: DiffusionSchedule, latents: torch.Tensor, context: torch.Tensor,
                 pose_features=None, traj_features=None, num_inference_steps: int = 25,
                 guidance_scale: float = 8.0, omcm_min_step: int = 700, window_length: int = 16,
                 multidiff_total_steps: int = 1, multidiff_overlaps: int = 12,
                 deepcache_interval: int = 1, cfg_cache_interval: int = 1,
                 solver: str = "ddim",
                 on_step: Optional[Callable[[int, int], None]] = None) -> torch.Tensor:
    """CFG denoise loop over the DDIM timesteps (modes: the module docstring);
    ``on_step(idx, t)`` is called after each step."""
    check_modes(multidiff_total_steps, deepcache_interval, cfg_cache_interval, solver,
                traj_features is not None)
    stride = window_length - multidiff_overlaps
    if multidiff_total_steps > 1 and (
            stride < 1 or latents.shape[1] != multidiff_total_steps * stride + multidiff_overlaps):
        raise ValueError(f"{multidiff_total_steps} windows of {window_length} frames overlapping "
                         f"by {multidiff_overlaps} do not tile {latents.shape[1]} frames")
    dtype = unet.dtype
    b = latents.shape[0]
    timesteps = schedule.ddim_timesteps(num_inference_steps).tolist()
    tables = schedule.dpmpp_2m_tables(num_inference_steps) if solver == "dpmpp_2m" else None

    pose_cfg = pose_b = None
    if pose_features is not None:
        pose_b = [p.to(dtype) for p in pose_features]
        pose_cfg = [torch.cat([p, p], dim=0) for p in pose_b]
    traj_cfg = traj_b = None
    if traj_features is not None:
        traj_b = [tr.to(dtype) for tr in traj_features]
        traj_cfg = [torch.cat([torch.zeros_like(tr), tr], dim=0) for tr in traj_b]

    def gated(traj, t):
        if traj is None or t >= omcm_min_step:
            return traj
        return [torch.zeros_like(tr) for tr in traj]

    def pair(x, t, pose, traj, **kw):
        """The UNet on the CFG pair [x, x] with the full context."""
        t_vec = torch.full((2 * x.shape[0],), t, dtype=torch.int64, device=x.device)
        return unet(torch.cat([x, x], dim=0), t_vec, context, pose_features=pose,
                    traj_features=traj, **kw)

    def combine(uncond, cond):
        return uncond + guidance_scale * (cond - uncond)

    m_prev = torch.zeros_like(latents) if solver == "dpmpp_2m" else None

    def solver_step(eps_cfg, t, idx):
        nonlocal latents, m_prev
        if solver == "ddim":
            latents = schedule.ddim_step(eps_cfg, t, latents, num_inference_steps)
        else:
            latents, m_prev = schedule.dpmpp_2m_step(eps_cfg, idx, latents, m_prev, tables)

    use_deep, use_cfg = deepcache_interval > 1, cfg_cache_interval > 1
    k = max(deepcache_interval, cfg_cache_interval)
    ctx_cond = context[b:]
    deep = uncond = None  # step 0 refreshes both before any cached step reads them
    for idx, t in enumerate(timesteps):
        if (use_deep or use_cfg) and idx % k != 0:
            if use_cfg:  # the cond branch alone at batch B, the uncond eps reused
                t_vec = torch.full((b,), t, dtype=torch.int64, device=latents.device)
                cond = unet(latents.to(dtype), t_vec, ctx_cond, pose_features=pose_b,
                            traj_features=gated(traj_b, t), deep_cache=deep)
            else:  # DeepCache: the shallow level on the pair
                uncond, cond = pair(latents.to(dtype), t, pose_cfg, gated(traj_cfg, t),
                                    deep_cache=deep).chunk(2, dim=0)
            eps = combine(uncond, cond)
        elif use_deep or use_cfg:  # refresh: the full pair, recording the caches
            out = pair(latents.to(dtype), t, pose_cfg, gated(traj_cfg, t), return_deep=use_deep)
            if use_deep:
                out, deep = out
                if use_cfg:
                    deep = deep[b:]
            uncond, cond = out.chunk(2, dim=0)
            eps = combine(uncond, cond)
        elif multidiff_total_steps == 1:
            eps = combine(*pair(latents, t, pose_cfg, gated(traj_cfg, t)).chunk(2, dim=0))
        else:
            eps_acc = torch.zeros_like(latents)
            count = torch.zeros_like(latents)
            for w in range(multidiff_total_steps):
                win = slice(w * stride, w * stride + window_length)
                pose_w = None if pose_cfg is None else [p[:, win] for p in pose_cfg]
                eps_acc[:, win] += combine(*pair(latents[:, win], t, pose_w, None).chunk(2, dim=0))
                count[:, win] += 1.0
            eps = eps_acc / count.clamp_min(1.0)
        solver_step(eps, t, idx)
        if on_step is not None:
            on_step(idx, t)
    return latents


@torch.inference_mode()
def decode_latents(vae, latents: torch.Tensor, decode_chunk: int = 1) -> torch.Tensor:
    """VAE decode -> (B, F, H, W, 3) in [0, 1]; /0.18215 inside ``vae.decode``.
    Decodes k frames a call, k the largest divisor of B*F that is at most
    ``decode_chunk`` (the VAE is frame-independent, so k changes no value)."""
    b, f, h, w, c = latents.shape
    frames = latents.reshape(b * f, h, w, c)
    k = max(1, min(decode_chunk, b * f))
    while (b * f) % k:
        k -= 1
    images = torch.cat([vae.decode(frames[i:i + k]) for i in range(0, b * f, k)])
    images = (images / 2.0 + 0.5).clamp(0.0, 1.0)
    return images.reshape(b, f, *images.shape[1:])
