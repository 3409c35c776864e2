"""The three-stage trainer (synfmc_tpu/training/trainers.py:train, :330-806).

``train(stage, config)`` for stage "lora" (the image LoRA), "cam" (the CMC
camera controller) or "obj" (the OMC object controller) validates the
config, makes a timestamped run directory (``log.txt``, ``config.yaml``),
reads the SynFMC dataset the config names through ``data/loader.py``'s
worker pool (stage 1 single frames, ``UnrealTrajLoraDataset``; stages 2-3
clips, ``UnrealTrajVideoDataset``), builds the stage's modules as
``pipelines/factory.py:init_models`` does (seeded weights, the JAX
package's structural zeros), loads the config's SD1.5 directory, AnimateDiff
motion modules, LoRA and CMC bundles and, for obj, the OMC bundle of
``omcm_config.pretrained`` (its weights and its step count, not its
optimizer state) (``training/pretrained.py``), and takes clip + AdamW steps
on the stage's trainable set in bf16 with fp32 masters:
- lora: the UNet's LoRA branches;
- cam: the UNet's pose merges and the whole pose encoder; with ``train_mm``
  also the motion modules' norm / proj_in / proj_out;
- obj: the ObjectAdapter; with ``train_cm`` the pose merges and the pose
  encoder, with ``train_mm`` the motion modules' norm / proj,
  with ``train_image_lora`` the LoRA.

``gradient_accumulation_steps`` k > 1 takes k loader batches a step, one at
a time, and one update of their mean gradient; ``gradient_checkpointing``
recomputes the UNet's forward in the backward (``gradient_checkpointing_
policy`` "full" or "dots").  Epochs count loader batches: an epoch is
``len(loader) / k`` steps, rounded up over the whole run, and a resumed run
continues at batch ``step * k`` of the data order.

Every ``checkpointing_steps`` steps (or ``checkpointing_epochs`` epochs)
and at the end it writes the resumable state and the reference's bundles
(``lora-step-N.ckpt``; ``cmcm-step-N.ckpt``; ``omcm-step-N.ckpt`` with
``cmcm-`` / ``img-lora-step-N.ckpt`` when those sets train); it resumes
exactly (``resume_from``: a step directory or ``auto``), renders validation
samples every ``validation_steps`` steps and at ``validation_steps_tuple``
when ``enable_validation`` (``training/validation.py``; a failed render is
logged and training goes on), traces steps 3 to 2 + ``profile_steps`` with
``torch.profiler`` into ``run_dir/trace/``, and stops cleanly on SIGTERM /
SIGINT with a final save.  It runs on the GPU unless ``device="cpu"`` is
asked for.

``batches`` (an iterable of collated raw batches) replaces the dataset and
its loader, for runs on synthetic data; everything else stays the same.

``mesh: {data, fsdp, sp}`` (one process a GPU under ``python -m
torch.distributed.run``, ``parallel.mesh.init_distributed`` called first;
the world size must be data x fsdp x sp): each ``data`` rank loads its
stride slice of the global order (dataset seed ``global_seed`` + its data
index, loader seed ``global_seed``) at ``train_batch_size`` a rank, the
``fsdp`` and ``sp`` ranks of a data line the same samples; the steps run as
``training/steps.py`` says (global draws, frame-parallel UNet, gradients
averaged once a step; under fsdp > 1 each rank keeps the fp32 masters and
AdamW moments of its rows of the split tensors, ZeRO-1).  Rank 0 alone logs
to the console and makes the sanity dump, the validation renders, the
profile and the checkpoint files; the other ranks wait at a barrier
meanwhile, and log to ``log.txt.rank{N}``.  A checkpoint's state is
assembled first on every rank, in the loop thread (under fsdp a collective
gather of the shards), then rank 0 writes it.  A stop signal on any rank
stops every rank at the same step (``sync_stop_flag`` every step).  Every
rank resumes from the same ``state.pt``, which holds whole tensors whatever
the layout: a run may resume under another fsdp size.

``ckpt_device_snapshot`` (``auto``, ``always`` or ``never``; under
``async_checkpointing`` only, synfmc_tpu/training/trainers.py:748-759): a
periodic checkpoint takes a device-side snapshot of the state and rank 0's
writer thread copies it to the host on a CUDA stream of its own, into
pinned memory kept from one checkpoint to the next; ``auto``
takes it where it fits beside the step's peak (``snapshot_fits_on_device``;
never on the CPU), else the loop copies the state to the host itself.
"""

from __future__ import annotations

import datetime
import os
import signal
import threading
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from synfmc_tpu_torch.config import get_path, load_config, save_config
from synfmc_tpu_torch.data.dataset import UnrealTrajLoraDataset, UnrealTrajVideoDataset
from synfmc_tpu_torch.data.loader import ShardedLoader
from synfmc_tpu_torch.data.tokenizer import load_tokenizer
from synfmc_tpu_torch.device import resolve_device
from synfmc_tpu_torch.diffusion.scheduler import DiffusionSchedule
from synfmc_tpu_torch.ops import kernel_launches
from synfmc_tpu_torch.parallel.mesh import (
    TRAIN_AXES,
    barrier,
    broadcast_object,
    fetch_to_host,
    gather_shards,
    sync_stop_flag,
    training_mesh,
    tree_nbytes,
)
from synfmc_tpu_torch.pipelines.factory import STAGES, cast_models_, init_models
from synfmc_tpu_torch.training import checkpoint as ckpt
from synfmc_tpu_torch.training.config_schema import validate_config
from synfmc_tpu_torch.training.optim import make_optimizer
from synfmc_tpu_torch.training.params import (
    count_params,
    partition_params,
    stage1_lora_trainable,
    stage2_cmc_unet_trainable,
    stage3_mm_trainable,
    stage3_unet_trainable,
)
from synfmc_tpu_torch.training.pipeline_io import (
    AsyncCheckpointWriter,
    PinnedCopier,
    ThreadPrefetcher,
    snapshot_fits_on_device,
    snapshot_on_device,
)
from synfmc_tpu_torch.training.pretrained import load_pretrained, validate_pretrained_paths
from synfmc_tpu_torch.training.steps import (
    StepConfig,
    TrainState,
    draw_cam,
    draw_lora,
    draw_obj,
    draw_part,
    init_train_state,
    make_accumulating_step,
    make_cam_grads_fn,
    make_lora_grads_fn,
    make_obj_grads_fn,
    state_nbytes,
    step_from_grads,
)
from synfmc_tpu_torch.training.validation import run_validation
from synfmc_tpu_torch.utils.logger import close_logger, format_time, setup_logger
from synfmc_tpu_torch.utils.video import save_image_grid, save_videos_grid


def mesh_from_config(config: dict):
    """The config's ``mesh: {data, fsdp, sp}`` as a ``parallel.mesh`` training
    mesh (a world size other than data x fsdp x sp raises)."""
    spec = dict(config.get("mesh") or {})
    unknown = set(spec) - set(TRAIN_AXES)
    if unknown:
        raise ValueError(f"mesh: unknown axes {sorted(unknown)} (want {TRAIN_AXES})")
    return training_mesh(**{a: int(spec.get(a) or 1) for a in TRAIN_AXES})


SNAPSHOT_MODES = ("auto", "always", "never")


def snapshot_mode(config: dict) -> str:
    """The config's ``ckpt_device_snapshot`` (default ``auto``); another
    value raises."""
    mode = str(config.get("ckpt_device_snapshot", "auto"))
    if mode not in SNAPSHOT_MODES:
        raise ValueError(f"ckpt_device_snapshot: {mode!r} (want one of {SNAPSHOT_MODES})")
    return mode


def step_config(config: dict, stage: str) -> StepConfig:
    """The StepConfig the JAX trainer derives from a config (the loss mask
    inverted for stage 2 alone: it weighs the background)."""
    sample_size = tuple(get_path(config, "train_data.params.sample_size", (256, 384)))
    ratio = (float(config.get("cfg_random_null_text_ratio", 0.1))
             if config.get("cfg_random_null_text", True) else 0.0)
    return StepConfig(
        cfg_random_null_text_ratio=ratio,
        apply_masked_loss=bool(config.get("apply_masked_loss", False)),
        invert_loss_mask=stage == "cam",
        mask_loss_weight=float(config.get("mask_loss_weight", 1.0)),
        sd_loss_weight=float(config.get("sd_loss_weight", 1.0)),
        appearance_debias=float(config.get("appearance_debias", 0.0)),
        omcm_min_step=int(config.get("omcm_min_step", 700)),
        min_step_prob=float(config.get("min_step_prob", 0.8)),
        sample_height=int(sample_size[0]),
        sample_width=int(sample_size[1]),
        remat=bool(config.get("gradient_checkpointing", False)),
        remat_policy=str(config.get("gradient_checkpointing_policy", "full")),
    )


def host_batch(raw: dict, tokenizer, device) -> dict:
    """A collated raw batch (numpy arrays, caption lists) -> the step's
    tensors: stage 1's (no camera in the raw batch) or stage 2's."""
    t = lambda x: torch.as_tensor(np.asarray(x), device=device)
    batch = {
        "pixel_values": t(raw["pixel_values"]).float(),
        "input_ids": t(tokenizer(raw["captions"])).long(),
        "null_ids": t(tokenizer([""])[0]).long(),
    }
    if "camera_rt" not in raw:
        return batch
    batch.update(
        background_ids=t(tokenizer(raw["background_captions"])).long(),
        camera_rt=t(raw["camera_rt"]).float(),
        intrinsics=t(raw["intrinsics"]).float(),
        obj_union_mask=t(raw["obj_union_mask"]).float(),
    )
    if "flip_flag" in raw:
        batch["flip_flag"] = t(raw["flip_flag"]).bool()
    return batch


def object_batch(raw: dict, device) -> dict:
    """Stage 3's additions to a batch: obj_info (B, F, O, 12), obj_masks (B, F, O, H, W)."""
    return {k: torch.as_tensor(np.asarray(raw[k]), device=device).float()
            for k in ("obj_info", "obj_masks")}


def checksum(params) -> float:
    """Sum of |w| over ``params`` in float64, on their device."""
    return float(sum(p.detach().double().abs().sum() for p in params))


def state_tree(state: TrainState, epoch: int) -> dict:
    """What a resumable checkpoint holds, on the device: the step, the
    epoch, the fp32 masters, and the AdamW moments and update count; under
    fsdp a split tensor's masters and moments are this rank's ``Shard``."""
    names = list(state.trainable)
    exp_avg, exp_avg_sq = state.optimizer.moments()
    wrap = state.shards.wrap if state.shards is not None else dict
    return {"step": state.step, "epoch": epoch, "count": state.optimizer.count,
            "masters": wrap({n: state.masters[n] for n in names}),
            "exp_avg": wrap(dict(zip(names, exp_avg))),
            "exp_avg_sq": wrap(dict(zip(names, exp_avg_sq)))}


@torch.no_grad()
def restore_state(state: TrainState, saved: dict) -> TrainState:
    """Load a checkpoint's whole tensors into ``state``: the masters (this
    rank's rows of a split tensor's under fsdp), then the working weights
    re-cast from the whole masters as ``steps.apply_grads`` gives them, the
    moments and the counts."""
    names = list(state.trainable)
    if set(saved["masters"]) != set(names):
        raise ValueError(f"checkpoint holds {len(saved['masters'])} trainable tensors, the "
                         f"model {len(names)}: {sorted(set(saved['masters']) ^ set(names))[:5]}")
    shards = state.shards
    take = (lambda n, t: t) if shards is None else shards.take
    for n in names:
        src, p = saved["masters"][n], state.trainable[n]
        if src.shape != p.shape:
            raise ValueError(f"checkpoint {n}: shape {tuple(src.shape)} vs {tuple(p.shape)}")
        master = state.masters[n]
        master.copy_(take(n, src))
        if master is not p:
            p.copy_(src)
    state.optimizer.load_moments(int(saved["count"]),
                                 [take(n, saved["exp_avg"][n]) for n in names],
                                 [take(n, saved["exp_avg_sq"][n]) for n in names])
    state.step = int(saved["step"])
    return state


def split_trainable(tensors: dict) -> dict:
    """Trainable names -> the reference's parameter groups, each keyed by the
    module's state-dict names: pose (the pose encoder), merge (the UNet's
    pose merges), mm (the UNet's other non-LoRA tensors: train_mm's motion
    norm / proj), lora (the UNet's LoRA), adapter (the ObjectAdapter)."""
    def under(prefix):
        return {n[len(prefix):]: v for n, v in tensors.items() if n.startswith(prefix)}

    unet = under("unet.")
    merge = {n: v for n, v in unet.items() if stage2_cmc_unet_trainable(n)}
    lora = {n: v for n, v in unet.items() if n not in merge and "lora" in n}
    mm = {n: v for n, v in unet.items() if n not in merge and n not in lora}
    return {"pose": under("pose_encoder."), "merge": merge, "mm": mm, "lora": lora,
            "adapter": under("adapter.")}


# the reference's trainable_params order by stage, for the AdamW export
# (train_image_lora.py:178-188, train_cam_ctrl.py:276-305,
# train_cam_obj_ctrl.py:335-406)
EXPORT_ORDER = {"lora": ("lora",), "cam": ("pose", "merge", "mm"),
                "obj": ("pose", "merge", "mm", "adapter", "lora")}


def save_checkpoints(run_dir: str, saved: dict, config: dict, stage: str) -> dict:
    """The resumable state and the stage's reference bundles, the optimizer
    state in the reference's order (``EXPORT_ORDER``).  Returns the step,
    the seconds and the bytes written."""
    t0 = time.perf_counter()
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    step, epoch = saved["step"], saved["epoch"]
    native = ckpt.save_native(ckpt_dir, step, saved)
    moments = split_trainable({n: (saved["exp_avg"][n], saved["exp_avg_sq"][n])
                               for n in saved["masters"]})
    opt_sd = ckpt.export_adamw_state_dict(
        [moments[g] for g in EXPORT_ORDER[stage]], saved["count"],
        lr=float(config.get("learning_rate", 1e-4)),
        betas=(float(config.get("adam_beta1", 0.9)), float(config.get("adam_beta2", 0.999))),
        eps=float(config.get("adam_epsilon", 1e-8)),
        weight_decay=float(config.get("adam_weight_decay", 1e-2)))
    g = split_trainable(saved["masters"])
    if stage == "lora":
        bundles = [os.path.join(ckpt_dir, f"lora-step-{step}.ckpt")]
        ckpt.save_stage1_bundle(bundles[0], g["lora"], epoch, step, optimizer_state_dict=opt_sd)
    elif stage == "cam":
        bundles = [os.path.join(ckpt_dir, f"cmcm-step-{step}.ckpt")]
        ckpt.save_stage2_bundle(bundles[0], g["pose"], g["merge"], epoch, step,
                                mm_state=g["mm"] or None, optimizer_state_dict=opt_sd)
    else:
        # the reference's stage-3 cmcm bundle holds the merges alone; the
        # image LoRA gets img-lora-step-N.ckpt; train_mm's tensors, which the
        # reference writes nowhere, ride the omcm bundle's mm_state_dict
        bundles = ckpt.save_stage3_bundles(
            ckpt_dir, step, g["adapter"], pose_encoder_state=g["pose"] or None,
            merge_state=g["merge"], mm_state=g["mm"] or None, lora_state=g["lora"] or None,
            epoch=epoch, optimizer_state_dict=opt_sd)
    nbytes = os.path.getsize(os.path.join(native, ckpt.NATIVE_FILE)) + sum(
        os.path.getsize(b) for b in bundles)
    return {"step": step, "write_s": time.perf_counter() - t0, "bytes": nbytes}


def _sanity_check_dump(run_dir: str, raw: dict, stage: str) -> None:
    """First-batch sanity dump (reference do_sanity_check, train_cam_ctrl.py:531-538)."""
    pixels = np.asarray(raw["pixel_values"]) * 0.5 + 0.5
    out = os.path.join(run_dir, "sanity_check")
    if stage == "lora":
        save_image_grid(pixels, os.path.join(out, "batch.png"))
    else:
        save_videos_grid(pixels, os.path.join(out, "batch.gif"))


def _mem_str(dev: torch.device) -> str:
    if dev.type != "cuda":
        return ""
    return f" mem {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}GB"


def epoch_steps(epochs: int, batches_per_epoch: int, accum: int = 1) -> int:
    """Optimizer steps that consume ``epochs`` epochs of ``batches_per_epoch``
    loader batches, ``accum`` a step: ceil(epochs * batches / accum)."""
    return -(-epochs * batches_per_epoch // accum)


def epoch_boundary(step: int, epochs: int, batches_per_epoch: int, accum: int = 1) -> bool:
    """True when optimizer step ``step`` consumes the batch that completes a
    multiple of ``epochs`` epochs (the epoch-denominated checkpoint cadence)."""
    period = epochs * batches_per_epoch
    return (step * accum) // period > ((step - 1) * accum) // period


def step_seed(global_seed: int, step: int, micro: int = 0) -> int:
    """The generator seed of step ``step``'s micro-batch ``micro``: a function
    of (seed, step, micro) alone, so a resumed run draws what an
    uninterrupted run drew."""
    return global_seed * 1_000_003 + step + (micro << 40)


def _trainable_set(stage: str, models: dict, config: dict) -> dict:
    """Mark each module's tensors trainable or frozen for ``stage``; returns
    the trainable ones by prefixed name (trainers.py:466-502)."""
    if stage == "lora":
        trainable = partition_params(models["unet"], stage1_lora_trainable, "unet.")
    elif stage == "cam":
        train_mm = bool(config.get("train_mm", False))
        trainable = {**partition_params(
            models["unet"],
            lambda n: stage2_cmc_unet_trainable(n) or (train_mm and stage3_mm_trainable(n)),
            "unet."),
            **partition_params(models["pose_encoder"], lambda n: True, "pose_encoder.")}
    else:
        flags = {k: bool(config.get(k, False)) for k in ("train_cm", "train_mm")}
        flags["train_image_lora"] = bool(config.get("train_image_lora", False))
        trainable = {**partition_params(models["unet"],
                                        lambda n: stage3_unet_trainable(n, **flags), "unet."),
                     **partition_params(models["adapter"], lambda n: True, "adapter."),
                     **partition_params(models["pose_encoder"], lambda n: flags["train_cm"],
                                        "pose_encoder.")}
    for key in ("vae", "text"):
        partition_params(models[key], lambda n: False)
    return trainable


def train(stage: str, config, batches: Optional[Iterable[dict]] = None,
          max_steps: Optional[int] = None, device=None, seed: Optional[int] = None,
          on_step: Optional[Callable[[TrainState, dict, object], None]] = None) -> dict:
    """Run the stage; returns summary metrics.

    ``config``: a config dict or YAML path (configs/{lora,cam,obj}.yaml).
    ``max_steps`` overrides ``max_train_steps``.  ``seed`` overrides
    ``global_seed``: it makes the weights no file covers, the data order and
    content and, with the step index alone, each step's draws.
    ``on_step(state, metrics, draws)`` is called after every step (``draws``
    a list of the micro-batches' with accumulation).

    The result holds the last logged metrics, ``steps``, ``wall_s``,
    ``run_dir``, ``preempted`` after a signal, ``loss_history`` with
    ``record_loss_history``, and for measurement: the per-step losses,
    seconds and data waits, the seconds from the call to the end of the
    first step, the checkpoints' path (snapshot or host copy), seconds in the
    loop (the gather's among them), writer seconds and bytes, the steps whose
    checkpoint this rank assembled, this rank's bytes of fp32 masters and
    AdamW moments, each kernel's launches over the steps, the peak device
    memory of the steps, the validation renders (step, seconds, files,
    launches, peak), the trainable and frozen
    parameter counts, and checksums (sum of |w|) of the trainable and frozen
    weights before and after training.
    """
    t_call = time.perf_counter()
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r} (want one of {STAGES})")
    config = load_config(config)
    config_notes = validate_config(config, stage)
    snapshot_mode(config)
    mesh = mesh_from_config(config)
    dev = resolve_device(device)

    name = config.get("name", f"{stage}-run")
    # rank 0's clock names the run directory of every rank
    run_dir = broadcast_object(os.path.join(str(config["output_dir"]),
                                            f"{name}-{datetime.datetime.now():%Y-%m-%dT%H-%M}"))
    os.makedirs(run_dir, exist_ok=True)
    if mesh.is_main:
        save_config(config, os.path.join(run_dir, "config.yaml"))
    logger = setup_logger(run_dir, mesh.rank)
    try:
        return _run(stage, config, batches, max_steps, dev, seed, on_step, run_dir, logger,
                    config_notes, t_call, mesh)
    finally:
        close_logger(logger)


def _run(stage, config, batches, max_steps, dev, seed, on_step, run_dir, logger, config_notes,
         t_call, mesh) -> dict:
    logger.info(f"stage={stage} run_dir={run_dir} device={dev} mesh={mesh}")
    for note in config_notes:
        logger.info(note)
    global_seed = int(config.get("global_seed", 42)) if seed is None else int(seed)
    train_data_cfg = dict(get_path(config, "train_data.params", {}) or {})

    validate_pretrained_paths(config, stage)
    tokenizer = load_tokenizer(config.get("pretrained_model_path"),
                               strict=bool(config.get("strict_pretrained", False)))
    loader = dataset = None
    if batches is None:
        # the train_data target names the JAX package's class; the port picks
        # its own by stage, as the JAX trainer does (trainers.py:379)
        dataset_cls = UnrealTrajLoraDataset if stage == "lora" else UnrealTrajVideoDataset
        # host-side randomness per data rank; the order's seed is global, so
        # that the ranks' stride slices partition it (trainers.py:361, :386)
        data_index, data_count = mesh.index("data"), mesh.count("data")
        dataset = dataset_cls(**train_data_cfg, seed=global_seed + data_index)
        loader = ShardedLoader(dataset, batch_size=int(config.get("train_batch_size", 1)),
                               collate_fn=dataset_cls.collate_fn,
                               num_workers=int(config.get("num_workers", 4)), seed=global_seed,
                               process_index=data_index, process_count=data_count)
        if len(loader) == 0:
            raise ValueError(
                f"empty data loader: dataset has {len(dataset)} examples but "
                f"train_batch_size={loader.batch_size} with drop_last — no full batch")

    dtype = torch.bfloat16 if config.get("mixed_precision_training", True) else torch.float32
    models = init_models(config, stage, global_seed, dev)
    models, pretrained_meta = load_pretrained(models, config, stage, logger)
    trainable = _trainable_set(stage, models, config)
    # fp32 masters taken before the cast (the files' values); an fp32 model's
    # tensors are their own masters
    masters = ({n: p.detach().clone() for n, p in trainable.items()}
               if dtype != torch.float32 else None)
    cast_models_(models, dtype)
    frozen = [p for m in models.values() for p in m.parameters() if not p.requires_grad]
    schedule = DiffusionSchedule.from_config(**(config.get("noise_scheduler_kwargs") or {}))
    cfg = step_config(config, stage)

    # one optimizer step consumes `accum` loader batches: the run length, the
    # epoch-denominated checkpoints and the resume position count batches
    accum = int(config.get("gradient_accumulation_steps", 1) or 1)
    batches_per_epoch = len(loader) if loader is not None else None
    max_steps = max_steps or int(config.get("max_train_steps", 100))
    if max_steps == -1:
        # epoch-denominated run length (train_cam_ctrl.py:369-371)
        max_train_epoch = int(config.get("max_train_epoch", -1))
        if max_train_epoch == -1 or batches_per_epoch is None:
            raise ValueError("max_train_steps: -1 requires max_train_epoch and the dataset "
                             "(reference train_cam_ctrl.py:370 asserts the same)")
        max_steps = epoch_steps(max_train_epoch, batches_per_epoch, accum)
        logger.info(f"max_train_epoch {max_train_epoch} x {batches_per_epoch} batches/epoch "
                    f"/ {accum} accum -> max_train_steps {max_steps}")
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
    state = init_train_state(trainable, tx, masters, mesh=mesh)
    del masters  # a split tensor's master is a copy of this rank's rows
    sp = mesh.axis("sp")
    if stage == "lora":
        if sp.size > 1:
            raise ValueError("stage 1 trains single frames: mesh.sp must be 1")
        grads_fn = make_lora_grads_fn(models["unet"], models["vae"], models["text"], schedule, cfg)
        draw = draw_lora
    elif stage == "cam":
        grads_fn = make_cam_grads_fn(models["unet"], models["pose_encoder"], models["vae"],
                                     models["text"], schedule, cfg, sp=sp)
        draw = draw_cam
    else:
        grads_fn = make_obj_grads_fn(models["unet"], models["pose_encoder"], models["adapter"],
                                     models["vae"], models["text"], schedule, cfg, sp=sp)
        draw = draw_obj
    group = mesh.world_group
    step_fn = (make_accumulating_step(grads_fn, accum, group) if accum > 1
               else step_from_grads(grads_fn, group))
    n_train, n_frozen = count_params(trainable.values()), count_params(frozen)
    logger.info(f"dtype={dtype} trainable params: {n_train / 1e6:.2f}M; "
                f"frozen: {n_frozen / 1e6:.2f}M; accumulation {accum}; remat "
                f"{cfg.remat_policy if cfg.remat else 'off'}")
    n_state = state_nbytes(state)
    logger.info(f"fp32 masters and AdamW moments on this rank: {n_state} bytes"
                + ("" if state.shards is None else
                   f" ({len(state.shards.names)} of {len(trainable)} tensors split over "
                   f"fsdp={mesh.count('fsdp')})"))

    ckpt_steps = int(config.get("checkpointing_steps", -1))
    ckpt_epochs = int(config.get("checkpointing_epochs", -1))
    if ckpt_steps == -1 and ckpt_epochs != -1 and batches_per_epoch is not None:
        # epoch-denominated cadence (train_cam_ctrl.py:373-375); both keys
        # -1 = the unconditional end-of-run save only
        logger.info(f"checkpointing_epochs {ckpt_epochs}: a checkpoint at each step that "
                    f"completes {ckpt_epochs * batches_per_epoch} more loader batches")
    else:
        ckpt_epochs = -1

    global_step = 0
    if stage == "obj" and pretrained_meta.get("omcm_global_step") is not None:
        # the OMC warm start resumes the step count, not the optimizer state
        # (train_cam_obj_ctrl.py:574-578)
        global_step = state.step = int(pretrained_meta["omcm_global_step"])
        logger.info(f"omcm_config.pretrained: resuming step count at {global_step}")
    resume_from = config.get("resume_from")
    if resume_from == "auto":  # rank 0 picks, every rank reads the same state.pt
        resume_from = broadcast_object(ckpt.find_auto_resume(
            str(config["output_dir"]), config.get("name", f"{stage}-run")))
        if resume_from is None:
            logger.info("resume_from: auto — no prior checkpoint, starting fresh")
    if resume_from:
        restore_state(state, ckpt.restore_native(str(resume_from)))
        global_step = state.step
        logger.info(f"resumed from {resume_from} at step {global_step}")
    epoch, start_batch = 0, 0
    if global_step and batches_per_epoch is not None:
        # exact data-order continuation: the epoch and the consumed batches
        # of the partial epoch, `accum` batches a step
        epoch, start_batch = divmod(global_step * accum, batches_per_epoch)
        logger.info(f"resume data order: epoch {epoch}, skipping {start_batch} "
                    f"already-consumed batches")
    checksums = {"trainable": [checksum(trainable.values())], "frozen": [checksum(frozen)]}

    def device_batch(raw):
        batch = host_batch(raw, tokenizer, dev)
        if stage == "obj":
            batch.update(object_batch(raw, dev))
        return batch

    def batch_source():
        """(epoch, first raw batch, device batches), one item a step (``accum``
        batches; the epoch and raw batch of the first); on the prefetch
        thread, loader wait + tokenize + host-to-device copy overlap the
        previous step."""
        if loader is not None:
            it = loader.epochs(start_epoch=epoch, start_batch=start_batch)
        else:
            it = ((0, raw) for raw in batches)
        while True:
            group = []
            for _ in range(accum):
                try:
                    group.append(next(it))
                except StopIteration:
                    return
            yield group[0][0], group[0][1], [device_batch(raw) for _, raw in group]

    prefetch_depth = int(config.get("prefetch_batches", 1))
    source, prefetcher = batch_source(), None
    if prefetch_depth > 0:
        source = prefetcher = ThreadPrefetcher(source, depth=prefetch_depth)
    async_ckpt = bool(config.get("async_checkpointing", True))
    snap_mode = snapshot_mode(config)
    writer = AsyncCheckpointWriter()
    copier = PinnedCopier(dev)
    checkpoints: list[dict] = []
    assembled: list[int] = []  # the steps whose state this rank assembled

    def checkpoint(step_epoch: int, wait: bool) -> None:
        """Every rank assembles the state here, in the loop thread, before the
        next step changes it (under fsdp the gather is a collective, which a
        writer thread could reach in another order on each rank); rank 0
        then writes it, on the writer thread unless ``wait``, when every rank
        leaves once the files exist.  The loop's part is a device snapshot
        that the writer copies to the host (``ckpt_device_snapshot``, async
        only) or a blocking host copy."""
        t0 = time.perf_counter()
        tree = state_tree(state, step_epoch)
        snapshot = mesh.is_main and not wait and (
            snap_mode == "always" or (snap_mode == "auto" and snapshot_fits_on_device(
                tree_nbytes(tree), device=dev)))
        if snapshot:
            tree = snapshot_on_device(tree)
        t1 = time.perf_counter()
        tree = gather_shards(tree)
        gather_s = time.perf_counter() - t1
        assembled.append(state.step)
        if not mesh.is_main:
            if wait:
                barrier()
            return
        ready = None
        if not snapshot:
            tree = fetch_to_host(tree)
        elif copier.stream is not None:  # the writer's stream waits for the snapshot
            ready = torch.cuda.Event()
            ready.record()
        loop_s = time.perf_counter() - t0
        path = "snapshot" if snapshot else "host copy"

        def write():
            t = time.perf_counter()
            saved = copier(tree, ready) if snapshot else tree
            writer_copy_s = time.perf_counter() - t
            checkpoints.append({**save_checkpoints(run_dir, saved, config, stage), "path": path,
                                "copy_s": loop_s, "gather_s": gather_s,
                                "writer_copy_s": writer_copy_s})
            c = checkpoints[-1]
            logger.info(f"checkpoint step {c['step']}: {path}, {loop_s:.3f}s in the loop "
                        f"(gather {gather_s:.3f}s)"
                        + (f", host copy {writer_copy_s:.3f}s in the writer" if snapshot else "")
                        + f", write {c['write_s']:.3f}s, {c['bytes']} bytes")

        if wait:
            write()
            barrier()
        else:
            writer.submit(write)

    # SIGTERM / SIGINT request a clean stop: the in-flight step finishes, the
    # final save follows, and the process exits 0, so that `resume_from:
    # auto` continues from the exact stopping step.  Handlers install only in
    # the main thread and are restored on exit.
    stop_requested = threading.Event()
    old_handlers = {}
    if bool(config.get("checkpoint_on_preemption", True)):
        def on_signal(signum, frame):
            stop_requested.set()
            logger.warning(f"received signal {signum}: will checkpoint at the end of the "
                           f"current step and exit cleanly")
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                old_handlers[sig] = signal.signal(sig, on_signal)

    do_sanity = bool(config.get("do_sanity_check", False))
    logger_interval = int(config.get("logger_interval", 10))
    record = bool(config.get("record_loss_history", False))
    enable_validation = bool(config.get("enable_validation", False))
    validation_steps = int(config.get("validation_steps", -1))
    validation_tuple = tuple(int(s) for s in (config.get("validation_steps_tuple") or ()))
    profile_steps = int(config.get("profile_steps", 0) or 0)
    profiler = None
    metrics_out: dict = {}
    losses, step_s, data_s, validations = [], [], [], []
    first_step_s = None
    last_saved_step = -1
    step_gen = torch.Generator(device=dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    peak = 0
    launches0 = kernel_launches(backward=True)
    t_start = time.perf_counter()
    data_t0 = time.perf_counter()
    try:
        while global_step < max_steps:
            try:
                epoch, raw, micro = next(source)
            except StopIteration:
                logger.info(f"the batches ran out at step {global_step}")
                break
            data_s.append(time.perf_counter() - data_t0)
            if global_step == 0 and do_sanity and mesh.is_main:
                _sanity_check_dump(run_dir, raw, stage)
            if profile_steps and global_step == 2 and mesh.is_main:
                profiler = _start_profiler(dev)
            # step k's draws: a function of (seed, k, micro) alone, so a resumed
            # run's step k draws what an uninterrupted run's step k drew; each
            # rank takes its part of the global batch's
            draws = []
            for i, batch in enumerate(micro):
                step_gen.manual_seed(step_seed(global_seed, global_step, i))
                draws.append(draw_part(draw, step_gen, batch, cfg, schedule, mesh.axis("data")))
            if accum > 1:
                state, metrics = step_fn(state, micro, draws)
            else:
                (draws,), (batch,) = draws, micro
                state, metrics = step_fn(state, batch, draws)
            global_step = state.step
            last = {k: float(v) for k, v in metrics.items()}  # waits for the step
            step_s.append(time.perf_counter() - data_t0)
            losses.append(last["loss"])
            if first_step_s is None:
                first_step_s = time.perf_counter() - t_call
            if on_step is not None:
                on_step(state, metrics, draws)
            if profiler is not None and global_step == 2 + profile_steps:
                _stop_profiler(profiler, run_dir, dev, logger)
                profiler = None
            if enable_validation and ((validation_steps > 0 and global_step % validation_steps == 0)
                                      or global_step in validation_tuple):
                if mesh.is_main:  # one render, on whole clips; the others wait
                    if cuda:  # the steps' peak so far; the render's own goes to its record
                        peak = max(peak, torch.cuda.max_memory_allocated(dev))
                        torch.cuda.reset_peak_memory_stats(dev)
                    with models["unet"].frame_shard_as(None):
                        validations.append(_validate(stage, run_dir, global_step, models,
                                                     config, tokenizer, schedule, dataset, dev,
                                                     logger))
                    if cuda:
                        torch.cuda.reset_peak_memory_stats(dev)
                barrier()
            if global_step % logger_interval == 0 or global_step == max_steps:
                eta = (max_steps - global_step) * step_s[-1]
                logger.info(f"step {global_step}/{max_steps} loss {last['loss']:.4f} "
                            f"lr {state.optimizer.schedule(global_step - 1):.2e} "
                            f"data {data_s[-1]:.3f}s iter {step_s[-1]:.3f}s "
                            f"eta {format_time(eta)}{_mem_str(dev)}")
                metrics_out = dict(last)
            if ((ckpt_steps > 0 and global_step % ckpt_steps == 0)
                    or (ckpt_epochs > 0 and epoch_boundary(global_step, ckpt_epochs,
                                                           batches_per_epoch, accum))):
                checkpoint(epoch, wait=not async_ckpt)
                last_saved_step = global_step
            data_t0 = time.perf_counter()
            if sync_stop_flag(stop_requested.is_set()):
                logger.info(f"stopping on preemption signal at step {global_step}; "
                            f"final checkpoint follows")
                metrics_out["preempted"] = True
                break
    finally:
        if profiler is not None:
            _stop_profiler(profiler, run_dir, dev, logger)
        writer.wait()  # surface write failures; order the final save
        if prefetcher is not None:
            prefetcher.close()
        if loader is not None:
            loader.close()
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)

    if cuda:
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
    if global_step != last_saved_step:
        checkpoint(epoch, wait=True)
    barrier()  # rank 0's writes are on disk when any rank returns
    launches = {k: v - launches0[k] for k, v in kernel_launches(backward=True).items()}
    for v in validations:  # the steps' launches alone
        for k, n in v["launches"].items():
            launches[k] -= n
    checksums["trainable"].append(checksum(trainable.values()))
    checksums["frozen"].append(checksum(frozen))
    metrics_out.update(steps=global_step, wall_s=time.perf_counter() - t_start, run_dir=run_dir)
    if record:
        metrics_out["loss_history"] = list(losses)
    metrics_out.update(
        losses=losses, step_s=step_s, data_s=data_s, first_step_s=first_step_s,
        checkpoints=checkpoints, assembled=assembled, launches=launches,
        validations=validations, peak_gib=peak / 2**30 if cuda else None, state_bytes=n_state,
        trainable_params=n_train, frozen_params=n_frozen, checksums=checksums)
    return metrics_out


def _validate(stage, run_dir, step, models, config, tokenizer, schedule, dataset, dev,
              logger) -> dict:
    """One validation render; a failure is logged and training goes on
    (trainers.py:717-728).  Returns its step, seconds, files, launches and
    peak (GiB on the GPU)."""
    before = kernel_launches(backward=True)
    t0 = time.perf_counter()
    files, error = [], None
    try:
        files = run_validation(stage, run_dir, step, models, config, tokenizer, schedule,
                               dataset=None if stage == "lora" else dataset, device=dev)
    except Exception as e:  # validation must never kill training
        error = f"{type(e).__name__}: {e}"
        logger.warning(f"validation at step {step} failed: {error}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in kernel_launches(backward=True).items()}
    if error is None:
        logger.info(f"validation at step {step}: {len(files)} files in {seconds:.2f}s")
    return {"step": step, "s": seconds, "files": files, "launches": launches, "error": error,
            "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                         if dev.type == "cuda" else None)}


def _start_profiler(dev: torch.device):
    """torch.profiler over the next steps (the counterpart of
    jax.profiler.start_trace, trainers.py:701-716)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, run_dir: str, dev: torch.device, logger) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prof.stop()
    path = os.path.join(run_dir, "trace", "trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    logger.info(f"profiler trace written to {path}")
