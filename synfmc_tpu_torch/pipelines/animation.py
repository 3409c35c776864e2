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
The cache modes need M = 1, and traj features need M = 1.

Mesh modes (``mesh``: a ``parallel.mesh`` serving mesh, one process a GPU),
as the JAX package's:
- data-parallel (``sp`` = 1): the prompt batch splits over ``data`` (batch %
  data == 0); each rank runs its prompts end to end, the text and pose
  encoders included, and the results are gathered along the batch;
- frame-parallel (``sp`` = S > 1, ``data`` = 2 x batch): the CFG pair rides
  ``data`` (rank d holds row d of the stacked [uncond, cond] batch) and the
  frames ride ``sp``; the pose features are computed whole on every rank,
  the traj features sliced to the rank's row and frames; each step the UNet
  runs on one row's f/S frames, the motion modules exchange over ``sp``, the
  pair meets through an all-gather over ``data`` for the CFG combine, and
  every rank of an ``sp`` line then holds the same latents.  CFG-cache's
  cached steps run the cond rows alone: an uncond rank gives its row of the
  last refresh's uncond eps to the gather instead of running the UNet.  The
  decode is frame-sharded over ``sp``, then gathered.  Multidiff windows
  raise (the JAX sampler's assert).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from synfmc_tpu_torch.device import resolve_device
from synfmc_tpu_torch.diffusion.scheduler import DiffusionSchedule
from synfmc_tpu_torch.parallel.collectives import all_gather
from synfmc_tpu_torch.parallel.mesh import shard
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
    mesh: Optional[object] = None  # a parallel.mesh serving mesh, or None

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
        after each denoise step.  Under a mesh every rank returns the whole
        result (module docstring)."""
        check_modes(multidiff_total_steps, deepcache_interval, cfg_cache_interval, solver,
                    traj_features is not None)
        if isinstance(prompts, str):
            prompts = [prompts]
        total_frames = (multidiff_total_steps * (video_length - multidiff_overlaps)
                        + multidiff_overlaps)
        if latents is None:
            if generator is None:
                raise ValueError("need a generator or explicit latents")
            latents = torch.randn((len(prompts), total_frames, height // 8, width // 8, 4),
                                  generator=generator, device=generator.device,
                                  dtype=torch.float32) * self.schedule.init_noise_sigma
        kw = dict(num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
                  omcm_min_step=omcm_min_step, window_length=video_length,
                  multidiff_total_steps=multidiff_total_steps,
                  multidiff_overlaps=multidiff_overlaps, deepcache_interval=deepcache_interval,
                  cfg_cache_interval=cfg_cache_interval, solver=solver, on_step=on_step)
        if mesh_mode(self.mesh) == "data":
            # this rank's prompts end to end, the results gathered along the batch
            data = self.mesh.axis("data")
            part = shard(len(prompts), data, "prompts")
            if not isinstance(negative_prompts, (str, type(None))):
                negative_prompts = list(negative_prompts)[part]
            local = lambda x: None if x is None else x[part]
            out = self._generate(prompts[part], negative_prompts, local(latents), local(plucker),
                                 None if traj_features is None else [t[part] for t in traj_features],
                                 None, decode, decode_chunk, kw)
            return all_gather(out, data.group, 0)
        return self._generate(prompts, negative_prompts, latents, plucker, traj_features,
                              self.mesh, decode, decode_chunk, kw)

    def _generate(self, prompts, negative_prompts, latents, plucker, traj_features, mesh,
                  decode, decode_chunk, kw):
        context = self.encode_prompt(prompts, negative_prompts)
        latents = latents.to(self.device, torch.float32)
        pose_features = self.encode_pose(plucker) if plucker is not None else None
        if traj_features is not None:
            traj_features = [t.to(self.device) for t in traj_features]
        latents = denoise_loop(self.unet, self.schedule, latents, context,
                               pose_features=pose_features, traj_features=traj_features,
                               mesh=mesh, **kw)
        if not decode:
            return latents
        return decode_latents(self.vae, latents, decode_chunk=decode_chunk, mesh=mesh)


def mesh_mode(mesh) -> Optional[str]:
    """None without a mesh, "frames" with an sp axis > 1, else "data"."""
    if mesh is None:
        return None
    return "frames" if mesh.count("sp") > 1 else "data"


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


def _gate(traj, on: bool):
    """Traj features while the OMC gate is open, zeros after."""
    if traj is None or on:
        return traj
    return [torch.zeros_like(tr) for tr in traj]


class _Stacked:
    """The CFG pair on one process: the UNet on [x, x] at batch 2B with the
    context [uncond, cond]; pose features shared by both branches, traj
    features on the cond branch alone."""

    def __init__(self, unet, context, pose_features, traj_features):
        dtype = unet.dtype
        self.unet, self.context, self.b = unet, context, context.shape[0] // 2
        self.pose_b = None if pose_features is None else [p.to(dtype) for p in pose_features]
        self.pose_cfg = (None if self.pose_b is None
                         else [torch.cat([p, p], dim=0) for p in self.pose_b])
        self.traj_b = None if traj_features is None else [tr.to(dtype) for tr in traj_features]
        self.traj_cfg = (None if self.traj_b is None
                         else [torch.cat([torch.zeros_like(tr), tr], dim=0) for tr in self.traj_b])

    def pair(self, x, t, traj_on: bool, pose=None, **kw):
        """eps of [uncond, cond] (2B); with ``return_deep`` also the deep
        tensor; ``pose`` replaces the pose features (a multidiff window)."""
        t_vec = torch.full((2 * x.shape[0],), t, dtype=torch.int64, device=x.device)
        return self.unet(torch.cat([x, x], dim=0), t_vec, self.context,
                         pose_features=self.pose_cfg if pose is None else pose,
                         traj_features=_gate(self.traj_cfg, traj_on), **kw)

    def cond(self, x, t, traj_on: bool, deep, uncond):
        """The cond branch alone at batch B (``uncond`` is not needed here)."""
        t_vec = torch.full((self.b,), t, dtype=torch.int64, device=x.device)
        return self.unet(x, t_vec, self.context[self.b:], pose_features=self.pose_b,
                         traj_features=_gate(self.traj_b, traj_on), deep_cache=deep)

    def cond_deep(self, deep):
        """The part of a refresh's deep tensor that cond-only steps read."""
        return deep[self.b:]


class _Split:
    """Frame-parallel: this rank computes row ``data.index`` of the stacked
    pair on its frames, and the rows meet through an all-gather over
    ``data``.  ``x`` is the (B, f/S) latents every rank of the line holds."""

    def __init__(self, unet, context, pose_features, traj_features, data, frames: slice):
        dtype = unet.dtype
        self.unet, self.data, self.b = unet, data, context.shape[0] // 2
        self.row = data.index
        self.p = self.row % self.b  # the prompt of this rank's row
        self.is_cond = self.row >= self.b
        self.context = context[self.row:self.row + 1]
        one = slice(self.p, self.p + 1)
        self.pose = None if pose_features is None else [p.to(dtype)[one] for p in pose_features]
        self.traj = None
        if traj_features is not None:
            self.traj = [tr.to(dtype)[one, frames] for tr in traj_features]
            if not self.is_cond:
                self.traj = [torch.zeros_like(tr) for tr in self.traj]

    def _eps(self, x, t, traj_on: bool, **kw):
        t_vec = torch.full((1,), t, dtype=torch.int64, device=x.device)
        return self.unet(x[self.p:self.p + 1], t_vec, self.context, pose_features=self.pose,
                         traj_features=_gate(self.traj, traj_on), **kw)

    def pair(self, x, t, traj_on: bool, pose=None, return_deep: bool = False, **kw):
        out = self._eps(x, t, traj_on, return_deep=return_deep, **kw)
        eps, deep = out if return_deep else (out, None)
        both = all_gather(eps, self.data.group, 0)
        return (both, deep) if return_deep else both

    def cond(self, x, t, traj_on: bool, deep, uncond):
        # an uncond rank's row is the last refresh's uncond eps
        eps = (self._eps(x, t, traj_on, deep_cache=deep) if self.is_cond
               else uncond[self.p:self.p + 1])
        return all_gather(eps, self.data.group, 0)[self.b:]

    def cond_deep(self, deep):
        return deep  # this rank's own row


@torch.inference_mode()
def denoise_loop(unet, schedule: DiffusionSchedule, latents: torch.Tensor, context: torch.Tensor,
                 pose_features=None, traj_features=None, num_inference_steps: int = 25,
                 guidance_scale: float = 8.0, omcm_min_step: int = 700, window_length: int = 16,
                 multidiff_total_steps: int = 1, multidiff_overlaps: int = 12,
                 deepcache_interval: int = 1, cfg_cache_interval: int = 1,
                 solver: str = "ddim", on_step: Optional[Callable[[int, int], None]] = None,
                 mesh=None) -> torch.Tensor:
    """CFG denoise loop over the DDIM timesteps (modes and ``mesh``: the
    module docstring); ``on_step(idx, t)`` is called after each step.  The
    arguments are the whole batch and clip under a mesh too, and every rank
    returns the whole final latents."""
    check_modes(multidiff_total_steps, deepcache_interval, cfg_cache_interval, solver,
                traj_features is not None)
    loop = dict(num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
                omcm_min_step=omcm_min_step, window_length=window_length,
                multidiff_total_steps=multidiff_total_steps,
                multidiff_overlaps=multidiff_overlaps, deepcache_interval=deepcache_interval,
                cfg_cache_interval=cfg_cache_interval, solver=solver, on_step=on_step)
    mode = mesh_mode(mesh)
    if mode is None:
        return _loop(unet, schedule, latents,
                     _Stacked(unet, context, pose_features, traj_features), **loop)
    b = latents.shape[0]
    if mode == "data":
        data = mesh.axis("data")
        part = shard(b, data, "prompts")
        local = lambda xs: None if xs is None else [x[part] for x in xs]
        ctx = torch.cat([context[:b][part], context[b:][part]], dim=0)
        out = _loop(unet, schedule, latents[part],
                    _Stacked(unet, ctx, local(pose_features), local(traj_features)), **loop)
        return all_gather(out, data.group, 0)
    data, sp = mesh.axis("data"), mesh.axis("sp")
    if multidiff_total_steps != 1:
        raise ValueError("frame-parallel serving requires multidiff_total_steps == 1")
    if data.size != 2 * b:
        raise ValueError(f"frame-parallel serving needs mesh data == 2*batch (the CFG pair "
                         f"rides 'data'); got data={data.size}, batch={b}")
    frames = shard(latents.shape[1], sp, "frames")
    branches = _Split(unet, context, pose_features, traj_features, data, frames)
    with unet.frame_shard_as(sp):
        out = _loop(unet, schedule, latents[:, frames], branches, **loop)
    return all_gather(out, sp.group, 1)


def _loop(unet, schedule, latents, branches, num_inference_steps, guidance_scale, omcm_min_step,
          window_length, multidiff_total_steps, multidiff_overlaps, deepcache_interval,
          cfg_cache_interval, solver, on_step) -> torch.Tensor:
    stride = window_length - multidiff_overlaps
    if multidiff_total_steps > 1 and (
            stride < 1 or latents.shape[1] != multidiff_total_steps * stride + multidiff_overlaps):
        raise ValueError(f"{multidiff_total_steps} windows of {window_length} frames overlapping "
                         f"by {multidiff_overlaps} do not tile {latents.shape[1]} frames")
    dtype = unet.dtype
    timesteps = schedule.ddim_timesteps(num_inference_steps).tolist()
    tables = schedule.dpmpp_2m_tables(num_inference_steps) if solver == "dpmpp_2m" else None

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
    deep = uncond = None  # step 0 refreshes both before any cached step reads them
    for idx, t in enumerate(timesteps):
        on = t >= omcm_min_step
        if (use_deep or use_cfg) and idx % k != 0:
            if use_cfg:  # the cond branch alone at batch B, the uncond eps reused
                cond = branches.cond(latents.to(dtype), t, on, deep, uncond)
            else:  # DeepCache: the shallow level on the pair
                uncond, cond = branches.pair(latents.to(dtype), t, on,
                                             deep_cache=deep).chunk(2, dim=0)
            eps = combine(uncond, cond)
        elif use_deep or use_cfg:  # refresh: the full pair, recording the caches
            out = branches.pair(latents.to(dtype), t, on, return_deep=use_deep)
            if use_deep:
                out, deep = out
                if use_cfg:
                    deep = branches.cond_deep(deep)
            uncond, cond = out.chunk(2, dim=0)
            eps = combine(uncond, cond)
        elif multidiff_total_steps == 1:
            eps = combine(*branches.pair(latents, t, on).chunk(2, dim=0))
        else:
            eps_acc = torch.zeros_like(latents)
            count = torch.zeros_like(latents)
            for w in range(multidiff_total_steps):
                win = slice(w * stride, w * stride + window_length)
                pose_w = None if branches.pose_cfg is None else [p[:, win] for p in branches.pose_cfg]
                eps_acc[:, win] += combine(*branches.pair(latents[:, win], t, False,
                                                          pose=pose_w).chunk(2, dim=0))
                count[:, win] += 1.0
            eps = eps_acc / count.clamp_min(1.0)
        solver_step(eps, t, idx)
        if on_step is not None:
            on_step(idx, t)
    return latents


def _decode(vae, latents: torch.Tensor, decode_chunk: int) -> torch.Tensor:
    b, f, h, w, c = latents.shape
    frames = latents.reshape(b * f, h, w, c)
    k = max(1, min(decode_chunk, b * f))
    while (b * f) % k:
        k -= 1
    images = torch.cat([vae.decode(frames[i:i + k]) for i in range(0, b * f, k)])
    images = (images / 2.0 + 0.5).clamp(0.0, 1.0)
    return images.reshape(b, f, *images.shape[1:])


@torch.inference_mode()
def decode_latents(vae, latents: torch.Tensor, decode_chunk: int = 1, mesh=None) -> torch.Tensor:
    """VAE decode -> (B, F, H, W, 3) in [0, 1]; /0.18215 inside ``vae.decode``.
    Decodes k frames a call, k the largest divisor of B*F that is at most
    ``decode_chunk`` (the VAE is frame-independent, so k changes no value).
    With a mesh each rank decodes its frames (``sp`` > 1) or its prompts
    (else) of the whole ``latents``, and every rank returns all of them."""
    mode = mesh_mode(mesh)
    if mode == "frames":
        sp = mesh.axis("sp")
        return all_gather(_decode(vae, latents[:, shard(latents.shape[1], sp, "frames")],
                                  decode_chunk), sp.group, 1)
    if mode == "data":
        data = mesh.axis("data")
        return all_gather(_decode(vae, latents[shard(latents.shape[0], data, "prompts")],
                                  decode_chunk), data.group, 0)
    return _decode(vae, latents, decode_chunk)
