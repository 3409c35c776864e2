"""The train steps of the three stages (synfmc_tpu/training/steps.py).

One step: the caption swap and per-sample text and camera CFG dropout, the
frozen VAE encode to a sampled latent, noise and timesteps, CLIP text
encode, Plücker rays, then the forward and backward of the trainable
modules for the stage's loss, then clip + AdamW:
- stage 1 (image LoRA, :177-204): single frames (F = 1), no camera, the
  UNet's LoRA branches, plain epsilon MSE;
- stage 2 (CMC, :207-270): the pose encoder and the UNet's pose merges,
  the loss masked by the inverted object union;
- stage 3 (OMC, :273-337): the ObjectAdapter's traj features into the
  UNet, timesteps biased to high noise, the loss on the objects' union mask
  (not inverted); the pose encoder frozen unless it trains (then it runs
  under ``torch.no_grad``, as ``jax.value_and_grad`` over the trainable tree
  differentiates nothing else).

The random draws are split from the math: :func:`draw_lora`,
:func:`draw_cam` and :func:`draw_obj` make every draw of a step into one
record (:class:`LoraDraws`, :class:`CamDraws`, :class:`ObjDraws`), and the
grads functions take that record, so both frameworks can be handed the same
draws.

``StepConfig.remat`` recomputes the UNet's forward in the backward
(``torch.utils.checkpoint``, non-reentrant): policy "full" saves nothing
inside the UNet; "dots", the counterpart of
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``, saves the
outputs of the Dense products (``aten.mm`` / ``aten.addmm``) and recomputes
everything else, the hand-written kernels included.  The recompute draws no
random numbers, so no RNG state is kept for it.

:func:`make_accumulating_step` takes ``k`` micro-batches, each with its own
draws, one at a time (one micro-batch's activations alive), sums their
gradients in fp32, and applies the mean in one clip + AdamW update.

On a mesh (one process a rank; ``parallel/mesh.py``):
- every rank draws the GLOBAL batch's draws from the step's seed and takes
  its part (:func:`draw_part`), so that a 2-rank step equals a 1-process
  step on the concatenated batch with the same draws;
- ``data``: each rank's loss is its samples' mean;
- ``sp`` (the grads functions' ``sp`` axis): the UNet runs frame-parallel
  (its motion modules exchange over ``sp``), each rank encodes, noises and
  scores its f/S frames, the pose encoder runs on the whole clip on every
  rank (its gradients then sum right over the ranks) and the appearance
  anchor, a global frame index, is read from the step's whole noise draw;
- the gradients (summed over the micro-batches) and the metrics are averaged
  over every rank once an optimizer step, in fp32 and before the clip, whose
  norm is then global (``group`` of the step functions);
- ``fsdp`` (ZeRO-1, ``TrainState.shards``): the fsdp ranks of a data line
  see the same samples; each holds the fp32 masters and AdamW moments of its
  dim-0 rows of every split tensor (``parallel.mesh.fsdp_rows``) and the
  replicated ones whole.  The split tensors' gradients are reduce-scattered
  over the fsdp line (one rank-major flat buffer), summed over the replica
  plane and divided by the world size; each rank updates its rows, casts
  them to the working type and all-gathers them into the model's tensors,
  so every rank holds the whole working weights.

Mixed precision: the model holds the trainable tensors in its working type
(bf16) and :class:`TrainState` keeps fp32 masters that the optimizer
updates and copies back.  Gradients are taken on the bf16 copies and cast
to fp32 before the clip, which is numerically what flax does with fp32
params under ``dtype=bf16``.  In an fp32 model the masters are the model's
own tensors, but for a split tensor's rows, which are a tensor of their own.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from synfmc_tpu_torch.diffusion.scheduler import DiffusionSchedule
from synfmc_tpu_torch.geometry.plucker import plucker_embedding
from synfmc_tpu_torch.parallel.collectives import all_gather_into_, all_reduce_, reduce_scatter_
from synfmc_tpu_torch.parallel.mesh import FsdpShards, shard
from synfmc_tpu_torch.training.losses import appearance_debias_loss, masked_diffusion_loss, mse
from synfmc_tpu_torch.utils.traj_features import build_adapter_inputs


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static per-stage hyperparameters (from the YAML config)."""

    cfg_random_null_text_ratio: float = 0.1
    background_caption_prob: float = 0.4
    apply_masked_loss: bool = False
    invert_loss_mask: bool = True
    mask_loss_weight: float = 1.0
    sd_loss_weight: float = 0.6
    appearance_debias: float = 0.0
    cfg_random_null_om_ratio: float = 0.1  # stage 3: whole-sample adapter-input dropout
    omcm_min_step: int = 700
    min_step_prob: float = 0.8
    sample_height: int = 256
    sample_width: int = 384
    remat: bool = False
    remat_policy: str = "full"  # or "dots"


class _Draws:
    def to(self, device):
        return type(self)(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})

    def part(self, part: slice, batch: int):
        """The draws of samples ``part`` of a ``batch``: a whole-batch draw
        (a scalar) as it is, a per-sample or per-frame one sliced."""
        def take(t):
            if t.dim() == 0:
                return t
            return t.reshape(batch, -1, *t.shape[1:])[part].flatten(0, 1)
        return type(self)(**{f.name: take(getattr(self, f.name))
                             for f in dataclasses.fields(self)})


@dataclasses.dataclass
class LoraDraws(_Draws):
    """Every random draw of one stage-1 step."""

    text_drop: torch.Tensor   # (B,) bool: null text
    vae_eps: torch.Tensor     # (B, H/8, W/8, 4) standard normal for the VAE sample
    noise: torch.Tensor       # (B, 1, H/8, W/8, 4) diffusion noise
    timesteps: torch.Tensor   # (B,) int64 in [0, T)


@dataclasses.dataclass
class CamDraws(_Draws):
    """Every random draw of one stage-2 step."""

    use_background: torch.Tensor  # () bool: swap in the background captions (whole batch)
    text_drop: torch.Tensor       # (B,) bool: null text
    camera_drop: torch.Tensor     # (B,) bool: zero camera
    vae_eps: torch.Tensor         # (B*F, H/8, W/8, 4) standard normal for the VAE sample
    noise: torch.Tensor           # (B, F, H/8, W/8, 4) diffusion noise
    timesteps: torch.Tensor       # (B,) int64 in [0, T)
    anchor: torch.Tensor          # (B,) int64 appearance-debias anchor frame


@dataclasses.dataclass
class ObjDraws(_Draws):
    """Every random draw of one stage-3 step: stage 2's, with the timesteps
    biased to high noise and the adapter inputs' CFG-dropout uniforms."""

    use_background: torch.Tensor
    text_drop: torch.Tensor
    camera_drop: torch.Tensor
    vae_eps: torch.Tensor
    noise: torch.Tensor
    timesteps: torch.Tensor       # (B,) sample_timesteps_biased
    om_uniform: torch.Tensor      # (B,) uniforms; a sample's adapter input drops when <= ratio
    anchor: torch.Tensor


def draw_lora(generator: torch.Generator, batch: dict, cfg: StepConfig,
              schedule: DiffusionSchedule) -> LoraDraws:
    """The draws of one stage-1 step (pixel_values (B, H, W, 3))."""
    b, h, w = batch["pixel_values"].shape[:3]
    dev = generator.device
    return LoraDraws(
        text_drop=torch.rand((b,), generator=generator, device=dev)
        < cfg.cfg_random_null_text_ratio,
        vae_eps=torch.randn((b, h // 8, w // 8, 4), generator=generator, device=dev),
        noise=torch.randn((b, 1, h // 8, w // 8, 4), generator=generator, device=dev),
        timesteps=schedule.sample_timesteps(generator, b),
    )


def draw_obj(generator: torch.Generator, batch: dict, cfg: StepConfig,
             schedule: DiffusionSchedule) -> ObjDraws:
    """The draws of one stage-3 step, in stage 2's order with the biased
    timesteps' three draws and the adapter uniforms before the anchor."""
    b, f, h, w = batch["pixel_values"].shape[:4]
    dev = generator.device
    uniform = lambda *shape: torch.rand(shape, generator=generator, device=dev)
    normal = lambda *shape: torch.randn(shape, generator=generator, device=dev)
    return ObjDraws(
        use_background=uniform() < cfg.background_caption_prob,
        text_drop=uniform(b) < cfg.cfg_random_null_text_ratio,
        camera_drop=uniform(b) < cfg.cfg_random_null_text_ratio,
        vae_eps=normal(b * f, h // 8, w // 8, 4),
        noise=normal(b, f, h // 8, w // 8, 4),
        timesteps=schedule.sample_timesteps_biased(generator, b, cfg.omcm_min_step,
                                                   cfg.min_step_prob),
        om_uniform=uniform(b),
        anchor=torch.randint(0, f, (b,), generator=generator, device=dev),
    )


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


def draw_part(draw: Callable, generator: torch.Generator, batch: dict, cfg: StepConfig,
              schedule: DiffusionSchedule, data=None):
    """``draw``'s record for the global batch (this rank's batch times the
    ``data`` axis), this rank's part of it; without ``data`` the batch's."""
    if data is None or data.size == 1:
        return draw(generator, batch, cfg, schedule)
    b, n = batch["pixel_values"].shape[0], data.size * batch["pixel_values"].shape[0]
    whole = {"pixel_values": torch.empty((n, *batch["pixel_values"].shape[1:]), device="meta")}
    return draw(generator, whole, cfg, schedule).part(shard(n, data, "samples"), n)


def rt_to_c2w(rt: torch.Tensor) -> torch.Tensor:
    """(B, F, 12) relative camera rows -> homogeneous (B, F, 4, 4)."""
    b, f = rt.shape[:2]
    m = rt.reshape(b, f, 3, 4)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=m.dtype, device=m.device)
    return torch.cat([m, bottom.expand(b, f, 1, 4)], dim=2)


def _select_text(batch: dict, draws, cfg: StepConfig) -> torch.Tensor:
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


# Dense products: the ops ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
# keeps.  Batched products (attention's bmm) and convolutions are recomputed.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = {"full": None, "dots": functools.partial(create_selective_checkpoint_contexts,
                                                          _dots_policy)}


def maybe_remat(fn: Callable, cfg: StepConfig) -> Callable:
    """``fn`` (the UNet call), rematerialised by ``cfg.remat_policy`` when
    ``cfg.remat``: non-reentrant ``torch.utils.checkpoint`` without RNG
    state, since the recompute draws no random numbers."""
    if not cfg.remat:
        return fn
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} "
                         f"(want one of {sorted(REMAT_POLICIES)})")
    context_fn = REMAT_POLICIES[cfg.remat_policy]
    extra = {} if context_fn is None else {"context_fn": context_fn}

    def remat(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                          **extra, **kwargs)

    return remat


def _conditions(vae, text_encoder, schedule, batch, draws, cfg, frames: slice = slice(None)):
    """The frozen part of a stage-2/3 step, without gradients: (noise, t,
    noisy latents, text context, Plücker rays), the noise and latents of
    ``frames`` alone, the rays of the whole clip."""
    with torch.no_grad():
        ids = _select_text(batch, draws, cfg)
        rt = batch["camera_rt"]
        if cfg.cfg_random_null_text_ratio > 0:  # camera CFG dropout -> zeros
            rt = rt * (1.0 - draws.camera_drop[:, None, None].to(rt.dtype))
        pixels = batch["pixel_values"]
        b, f = pixels.shape[:2]
        eps = draws.vae_eps.reshape(b, f, *draws.vae_eps.shape[1:])[:, frames].flatten(0, 1)
        latents = encode_latents(vae, pixels[:, frames], eps)
        noise = draws.noise[:, frames].to(latents.dtype)
        t = draws.timesteps
        noisy = schedule.add_noise(latents, noise, t)
        context = text_encoder(ids)
        plucker = plucker_embedding(batch["intrinsics"], rt_to_c2w(rt), cfg.sample_height,
                                    cfg.sample_width, flip_flag=batch.get("flip_flag"))
    return noise, t, noisy, context, plucker


def _debias(pred, noise, draws):
    """The appearance-debias term; the anchor frame from the whole draw."""
    return appearance_debias_loss(pred, noise, draws.anchor,
                                  anchor_source=draws.noise.to(noise.dtype))


def _backward(trainable: dict, loss: torch.Tensor, metrics: dict):
    loss.backward()
    # a tensor the loss does not reach (the ObjectAdapter's last stage: the
    # 4th down block takes no traj feature) has a zero gradient, as in JAX
    grads = {name: p.grad if p.grad is not None else torch.zeros_like(p)
             for name, p in trainable.items()}
    return grads, {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}}


def _clear(trainable: dict) -> None:
    for p in trainable.values():
        p.grad = None


def make_lora_grads_fn(unet, vae, text_encoder, schedule: DiffusionSchedule,
                       cfg: StepConfig = StepConfig()) -> Callable:
    """Stage 1 (image LoRA): ``grads_fn(trainable, batch, draws) -> (grads,
    metrics)``.  batch: pixel_values (B, H, W, 3) in [-1, 1], input_ids (B,
    77), null_ids (77,); the UNet runs on F = 1 latents without camera."""
    unet_call = maybe_remat(unet, cfg)

    def grads_fn(trainable: dict, batch: dict, draws: LoraDraws):
        with torch.no_grad():
            ids = _select_text(batch, draws, cfg)
            latents = encode_latents(vae, batch["pixel_values"][:, None], draws.vae_eps)
            noise = draws.noise.to(latents.dtype)
            t = draws.timesteps
            noisy = schedule.add_noise(latents, noise, t)
            context = text_encoder(ids)
        _clear(trainable)
        loss = mse(unet_call(noisy, t, context), noise)
        return _backward(trainable, loss, {})

    return grads_fn


def make_cam_grads_fn(unet, pose_encoder, vae, text_encoder, schedule: DiffusionSchedule,
                      cfg: StepConfig = StepConfig(apply_masked_loss=True), sp=None) -> Callable:
    """Stage 2 (CMC): ``grads_fn(trainable, batch, draws) -> (grads, metrics)``.

    ``trainable`` maps names to the model tensors that train (the others have
    ``requires_grad=False``); ``grads`` maps the same names to their
    gradients, in the tensors' own type.  batch: pixel_values (B, F, H, W, 3),
    input_ids / background_ids (B, 77), null_ids (77,), camera_rt (B, F, 12),
    intrinsics (B, F, 4), obj_union_mask (B, F, H, W, 1), optional flip_flag (B,).
    ``sp`` (the mesh's sp axis): frame-parallel (module docstring); it sets
    the UNet's frame shard.
    """
    unet_call = maybe_remat(unet, cfg)
    unet.set_frame_shard(sp)

    def grads_fn(trainable: dict, batch: dict, draws: CamDraws):
        frames = shard(batch["pixel_values"].shape[1], sp, "frames")
        noise, t, noisy, context, plucker = _conditions(vae, text_encoder, schedule, batch,
                                                        draws, cfg, frames)
        _clear(trainable)
        pose_feats = pose_encoder(plucker)
        pred = unet_call(noisy, t, context, pose_features=pose_feats)
        mask = batch.get("obj_union_mask") if cfg.apply_masked_loss else None
        loss, metrics = masked_diffusion_loss(
            pred, noise, None if mask is None else mask[:, frames],
            cfg.invert_loss_mask, cfg.mask_loss_weight, cfg.sd_loss_weight)
        if cfg.appearance_debias > 0:
            loss = loss + cfg.appearance_debias * _debias(pred, noise, draws)
        return _backward(trainable, loss, metrics)

    return grads_fn


OBJ_STEP_CONFIG = StepConfig(apply_masked_loss=True, invert_loss_mask=False, sd_loss_weight=0.3)


def make_obj_grads_fn(unet, pose_encoder, adapter, vae, text_encoder,
                      schedule: DiffusionSchedule, cfg: StepConfig = OBJ_STEP_CONFIG,
                      sp=None) -> Callable:
    """Stage 3 (OMC): ``grads_fn(trainable, batch, draws) -> (grads, metrics)``.

    batch adds obj_info (B, F, O, 12) and obj_masks (B, F, O, H, W) to
    stage 2's.  The raster (pose x mask, the mask, whole-sample dropout,
    re-masked) goes through the ObjectAdapter into the UNet's traj features;
    the loss mask is the union of the object masks.  A pose encoder with no
    trainable tensor runs without gradients.  ``sp``: as stage 2's; the
    adapter runs on the rank's frames."""
    unet_call = maybe_remat(unet, cfg)
    unet.set_frame_shard(sp)

    def grads_fn(trainable: dict, batch: dict, draws: ObjDraws):
        frames = shard(batch["pixel_values"].shape[1], sp, "frames")
        noise, t, noisy, context, plucker = _conditions(vae, text_encoder, schedule, batch,
                                                        draws, cfg, frames)
        info, obj_masks = batch["obj_info"][:, frames], batch["obj_masks"][:, frames]
        b, f = info.shape[:2]
        with torch.no_grad():
            feats, mask = build_adapter_inputs(info, obj_masks,
                                               cfg_dropout_ratio=cfg.cfg_random_null_om_ratio,
                                               uniforms=draws.om_uniform)
            union = (obj_masks.amax(dim=2) > 0).float()[..., None]
        _clear(trainable)
        with torch.set_grad_enabled(any(p.requires_grad for p in pose_encoder.parameters())):
            pose_feats = pose_encoder(plucker)
        traj_feats = [ft.reshape(b, f, *ft.shape[1:]) for ft in adapter(feats, mask)]
        pred = unet_call(noisy, t, context, pose_features=pose_feats, traj_features=traj_feats)
        loss, metrics = masked_diffusion_loss(
            pred, noise, union if cfg.apply_masked_loss else None,
            cfg.invert_loss_mask, cfg.mask_loss_weight, cfg.sd_loss_weight)
        if cfg.appearance_debias > 0:
            loss = loss + cfg.appearance_debias * _debias(pred, noise, draws)
        return _backward(trainable, loss, metrics)

    return grads_fn


@dataclasses.dataclass
class TrainState:
    step: int
    trainable: dict        # name -> model tensor (the working copy, whole on every rank)
    masters: dict          # name -> fp32 master (the same tensor in an fp32 model), or its
                           # rows under fsdp (a tensor of their own)
    optimizer: object      # optim.ClipAdamW over the masters
    shards: Optional[FsdpShards] = None  # the ZeRO-1 layout (mesh.fsdp > 1)


def init_train_state(trainable: dict, tx: Callable, masters: Optional[dict] = None,
                     mesh=None) -> TrainState:
    """``tx``: optim.make_optimizer's factory.  ``masters`` (fp32, by name)
    defaults to fp32 copies of the trainable tensors, or those tensors
    themselves when they are fp32 already.  On a ``mesh`` with fsdp > 1 a
    split tensor's master is this rank's rows, copied (``FsdpShards``)."""
    if masters is None:
        masters = {n: p if p.dtype == torch.float32 else p.detach().float().clone()
                   for n, p in trainable.items()}
    shards = None
    if mesh is not None and mesh.count("fsdp") > 1:
        shards = FsdpShards(mesh, {n: p.shape for n, p in trainable.items()})
        masters = {n: m if shards.rows[n] is None else shards.take(n, m).detach().float().clone()
                   for n, m in masters.items()}
    params = [masters[n] for n in trainable]
    kw = {} if shards is None else {"split": [shards.rows[n] is not None for n in trainable],
                                    "norm_group": shards.axis.group}
    return TrainState(step=0, trainable=trainable, masters=masters, optimizer=tx(params, **kw),
                      shards=shards)


def state_nbytes(state: TrainState) -> int:
    """The bytes of this rank's fp32 masters and both AdamW moments."""
    return 3 * sum(m.numel() * m.element_size() for m in state.masters.values())


@torch.no_grad()
def apply_grads(state: TrainState, grads: dict) -> TrainState:
    """Clip + AdamW on the fp32 masters, then copy them into the model;
    under fsdp the updated rows are cast to the working type (one for the
    whole model) and all-gathered into it."""
    state.optimizer.step([grads[n].float() for n in state.trainable])
    shards = state.shards
    if shards is not None and shards.names:
        dtype = state.trainable[shards.names[0]].dtype
        send = torch.cat([state.masters[n].reshape(-1).to(dtype) for n in shards.names])
        recv = send.new_empty(shards.axis.size * shards.part)
        all_gather_into_(recv, send, shards.axis.group)
        shards.unpack_into(recv, state.trainable)
    for n, p in state.trainable.items():
        master = state.masters[n]
        if master is not p:
            if shards is None or shards.rows[n] is None:
                p.copy_(master)
            master.grad = None
    state.step += 1
    return state


def average_over(grads: dict, metrics: dict, group,
                 shards: Optional[FsdpShards] = None) -> tuple[dict, dict]:
    """Gradients and metrics averaged over ``group`` (every rank) in fp32;
    as they are without a group (or a group of one).  With ``shards`` a split
    tensor's gradient comes back as this rank's rows: reduce-scattered over
    the fsdp line, summed over the replica plane, divided by the world size;
    the replicated ones and the metrics in one all-reduce."""
    if group is None:
        return grads, metrics
    metrics = {k: v.float() for k, v in metrics.items()}
    if shards is None or not shards.names:
        grads = {n: g.float() for n, g in grads.items()}
        all_reduce_(list(grads.values()) + list(metrics.values()), group)
        return grads, metrics
    flat = shards.pack(grads, torch.float32)
    part = flat.new_empty(shards.part)
    reduce_scatter_(part, flat, shards.axis.group)
    del flat
    all_reduce_([part], shards.plane.group, average=False)  # no-op on a plane of one
    part.div_(dist.get_world_size(group))
    rest = {n: grads[n].float() for n in grads if shards.rows[n] is None}
    all_reduce_(list(rest.values()) + list(metrics.values()), group)
    mine = shards.split(part)
    return {n: mine[n] if n in mine else rest[n] for n in grads}, metrics


def step_from_grads(grads_fn: Callable, group=None) -> Callable:
    """grads_fn -> ``step_fn(state, batch, draws) -> (state, metrics)``;
    ``group``: the ranks the gradients average over (module docstring), in
    the layout of ``state.shards``."""

    def step_fn(state: TrainState, batch: dict, draws):
        grads, metrics = average_over(*grads_fn(state.trainable, batch, draws), group,
                                      state.shards)
        return apply_grads(state, grads), metrics

    return step_fn


def make_accumulating_step(grads_fn: Callable, accum_steps: int, group=None) -> Callable:
    """Real gradient accumulation (synfmc_tpu/training/steps.py:133-174):
    ``step_fn(state, batches, draws) -> (state, metrics)`` over ``accum_steps``
    micro-batches and their draws.  Micro-batches run one at a time, so one
    micro-batch's activations are alive; their gradients and metrics sum in
    fp32 in micro order, are scaled by 1/k, and one clip + AdamW update
    applies the mean: the gradient of the mean loss over all k*B samples."""
    if accum_steps < 2:
        raise ValueError("use step_from_grads for accum_steps == 1")

    def step_fn(state: TrainState, batches: Sequence[dict], draws: Sequence):
        if len(batches) != accum_steps or len(draws) != accum_steps:
            raise ValueError(f"want {accum_steps} micro-batches and draws, got "
                             f"{len(batches)} and {len(draws)}")
        acc = macc = None
        for batch, d in zip(batches, draws):
            grads, metrics = grads_fn(state.trainable, batch, d)
            if acc is None:
                acc = {n: g.to(torch.float32, copy=True) for n, g in grads.items()}
                macc = {k: v.to(torch.float32, copy=True) for k, v in metrics.items()}
            else:
                for n, g in grads.items():
                    acc[n].add_(g.float())
                for k, v in metrics.items():
                    macc[k].add_(v.float())
        _clear(state.trainable)
        inv = 1.0 / accum_steps
        grads = {n: g.mul_(inv) for n, g in acc.items()}
        metrics = {k: v.mul_(inv) for k, v in macc.items()}
        grads, metrics = average_over(grads, metrics, group, state.shards)
        return apply_grads(state, grads), metrics

    return step_fn

