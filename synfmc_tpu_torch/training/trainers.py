"""The stage-2 trainer (synfmc_tpu/training/trainers.py:train, its cam-stage
path, :330-806).

``train("cam", config)`` validates the config, makes a timestamped run
directory (``log.txt``, ``config.yaml``), reads the SynFMC dataset the config
names through ``data/loader.py``'s worker pool, builds the cam-stage modules
as ``pipelines/factory.py:init_models`` does (seeded weights, the JAX
package's structural zeros), loads the config's SD1.5 directory, AnimateDiff
motion modules and LoRA bundle (``training/pretrained.py``), and takes clip +
AdamW steps on the stage-2 trainable set (the UNet's pose-merge projections,
the whole pose encoder; with ``train_mm`` also the motion modules' norm /
proj_in / proj_out), in bf16 with fp32 masters.  It writes resumable
checkpoints and reference-layout ``cmcm-step-N.ckpt`` bundles every
``checkpointing_steps`` steps and at the end, resumes exactly
(``resume_from``: a step directory or ``auto``), and stops cleanly on
SIGTERM / SIGINT with a final save.  It runs on the GPU unless
``device="cpu"`` is asked for.

``batches`` (an iterable of collated raw batches) replaces the dataset and
its loader, for runs on synthetic data; everything else stays the same.

Not ported (each raises NotImplementedError naming its key): gradient
accumulation, rematerialisation, validation renders, the profiler window,
a mesh axis > 1, and the stages ``lora`` and ``obj``.
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
from synfmc_tpu_torch.data.dataset import UnrealTrajVideoDataset
from synfmc_tpu_torch.data.loader import ShardedLoader
from synfmc_tpu_torch.data.tokenizer import load_tokenizer
from synfmc_tpu_torch.device import resolve_device
from synfmc_tpu_torch.diffusion.scheduler import DiffusionSchedule
from synfmc_tpu_torch.ops import kernel_launches
from synfmc_tpu_torch.pipelines.factory import cast_models_, init_models
from synfmc_tpu_torch.training import checkpoint as ckpt
from synfmc_tpu_torch.training.config_schema import validate_config
from synfmc_tpu_torch.training.optim import make_optimizer
from synfmc_tpu_torch.training.params import (
    count_params,
    partition_params,
    stage2_cmc_unet_trainable,
    stage3_mm_trainable,
)
from synfmc_tpu_torch.training.pipeline_io import AsyncCheckpointWriter, ThreadPrefetcher
from synfmc_tpu_torch.training.pretrained import load_pretrained, validate_pretrained_paths
from synfmc_tpu_torch.training.steps import (
    CamDraws,
    StepConfig,
    TrainState,
    draw_cam,
    init_train_state,
    make_cam_train_step,
)
from synfmc_tpu_torch.utils.logger import close_logger, format_time, setup_logger
from synfmc_tpu_torch.utils.video import save_videos_grid


def _not_ported(config: dict) -> None:
    """Raise NotImplementedError, naming the key, for what is not ported."""
    get = lambda key, default: config.get(key, default) or default
    checks = [
        ("gradient_accumulation_steps", int(get("gradient_accumulation_steps", 1)) > 1),
        ("gradient_checkpointing", bool(get("gradient_checkpointing", False))),
        ("enable_validation", bool(get("enable_validation", False))),
        ("profile_steps", int(get("profile_steps", 0)) > 0),
    ]
    checks += [(f"mesh.{axis}", int(n or 1) > 1) for axis, n in get("mesh", {}).items()]
    for key, refused in checks:
        if refused:
            value = get_path(config, key)
            raise NotImplementedError(f"{key}={value!r} is not ported yet")


def step_config(config: dict) -> StepConfig:
    """The stage-2 StepConfig the JAX trainer derives from a config (the loss
    mask inverted: stage 2 weighs the background)."""
    sample_size = tuple(get_path(config, "train_data.params.sample_size", (256, 384)))
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


def checksum(params) -> float:
    """Sum of |w| over ``params`` in float64, on their device."""
    return float(sum(p.detach().double().abs().sum() for p in params))


def host_state(state: TrainState, epoch: int) -> dict:
    """What a resumable checkpoint holds, copied to the CPU: the step, the
    epoch, the fp32 masters, and the AdamW moments and update count."""
    names = list(state.trainable)
    exp_avg, exp_avg_sq = state.optimizer.moments()
    cpu = lambda t: t.detach().to("cpu", copy=True)
    return {"step": state.step, "epoch": epoch, "count": state.optimizer.count,
            "masters": {n: cpu(state.masters[n]) for n in names},
            "exp_avg": {n: cpu(m) for n, m in zip(names, exp_avg)},
            "exp_avg_sq": {n: cpu(v) for n, v in zip(names, exp_avg_sq)}}


@torch.no_grad()
def restore_state(state: TrainState, saved: dict) -> TrainState:
    """Load ``host_state``'s record into ``state``: the masters, then the
    working weights re-cast from them as ``steps.apply_grads`` does, the
    moments and the counts."""
    names = list(state.trainable)
    if set(saved["masters"]) != set(names):
        raise ValueError(f"checkpoint holds {len(saved['masters'])} trainable tensors, the "
                         f"model {len(names)}: {sorted(set(saved['masters']) ^ set(names))[:5]}")
    for n in names:
        src, master = saved["masters"][n], state.masters[n]
        if src.shape != master.shape:
            raise ValueError(f"checkpoint {n}: shape {tuple(src.shape)} vs "
                             f"{tuple(master.shape)}")
        master.copy_(src)
        if master is not state.trainable[n]:
            state.trainable[n].copy_(master)
    state.optimizer.load_moments(int(saved["count"]), [saved["exp_avg"][n] for n in names],
                                 [saved["exp_avg_sq"][n] for n in names])
    state.step = int(saved["step"])
    return state


def _split(tensors: dict) -> tuple[dict, dict, dict]:
    """Trainable names -> (pose encoder, merge, motion-module) dicts keyed by
    the modules' state-dict names."""
    pose = {n[len("pose_encoder."):]: v for n, v in tensors.items()
            if n.startswith("pose_encoder.")}
    unet = {n[len("unet."):]: v for n, v in tensors.items() if n.startswith("unet.")}
    merge = {n: v for n, v in unet.items() if stage2_cmc_unet_trainable(n)}
    mm = {n: v for n, v in unet.items() if n not in merge}
    return pose, merge, mm


def save_checkpoints(run_dir: str, saved: dict, config: dict) -> dict:
    """The resumable state and the reference's ``cmcm-step-N.ckpt`` (the
    optimizer state in the reference's order: pose encoder, merge, mm).
    Returns the seconds and bytes written."""
    t0 = time.perf_counter()
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    step, epoch = saved["step"], saved["epoch"]
    native = ckpt.save_native(ckpt_dir, step, saved)
    moments = {n: (saved["exp_avg"][n], saved["exp_avg_sq"][n]) for n in saved["masters"]}
    opt_sd = ckpt.export_adamw_state_dict(
        list(_split(moments)), saved["count"],
        lr=float(config.get("learning_rate", 1e-4)),
        betas=(float(config.get("adam_beta1", 0.9)), float(config.get("adam_beta2", 0.999))),
        eps=float(config.get("adam_epsilon", 1e-8)),
        weight_decay=float(config.get("adam_weight_decay", 1e-2)))
    pose, merge, mm = _split(saved["masters"])
    bundle = os.path.join(ckpt_dir, f"cmcm-step-{step}.ckpt")
    ckpt.save_stage2_bundle(bundle, pose, merge, epoch, step, mm_state=mm or None,
                            optimizer_state_dict=opt_sd)
    nbytes = os.path.getsize(os.path.join(native, ckpt.NATIVE_FILE)) + os.path.getsize(bundle)
    return {"step": step, "write_s": time.perf_counter() - t0, "bytes": nbytes}


def _sanity_check_dump(run_dir: str, raw: dict) -> None:
    """First-batch sanity dump (reference do_sanity_check, train_cam_ctrl.py:531-538)."""
    pixels = np.asarray(raw["pixel_values"]) * 0.5 + 0.5
    save_videos_grid(pixels, os.path.join(run_dir, "sanity_check", "batch.gif"))


def _mem_str(dev: torch.device) -> str:
    if dev.type != "cuda":
        return ""
    return f" mem {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}GB"


def train(stage: str, config, batches: Optional[Iterable[dict]] = None,
          max_steps: Optional[int] = None, device=None, seed: Optional[int] = None,
          on_step: Optional[Callable[[TrainState, dict, CamDraws], None]] = None) -> dict:
    """Run the stage; returns summary metrics.

    ``config``: a config dict or YAML path (configs/cam.yaml).  ``max_steps``
    overrides ``max_train_steps``.  ``seed`` overrides ``global_seed``: it
    makes the weights no file covers, the data order and content and, with
    the step index alone, each step's draws.  ``on_step(state, metrics,
    draws)`` is called after every step.

    The result holds the last logged metrics, ``steps``, ``wall_s``,
    ``run_dir``, ``preempted`` after a signal, ``loss_history`` with
    ``record_loss_history``, and for measurement: the per-step losses,
    seconds and data waits, the seconds from the call to the end of the
    first step, the checkpoints' seconds and bytes, each kernel's launches
    over the run, the peak device memory, the trainable and frozen parameter
    counts, and checksums (sum of |w|) of the trainable and frozen weights
    before and after training.
    """
    t_call = time.perf_counter()
    if stage != "cam":
        raise NotImplementedError(f"stage {stage!r} is not ported yet (only 'cam')")
    config = load_config(config)
    config_notes = validate_config(config, stage)
    _not_ported(config)
    dev = resolve_device(device)

    name = config.get("name", f"{stage}-run")
    run_dir = os.path.join(str(config["output_dir"]),
                           f"{name}-{datetime.datetime.now():%Y-%m-%dT%H-%M}")
    os.makedirs(run_dir, exist_ok=True)
    save_config(config, os.path.join(run_dir, "config.yaml"))
    logger = setup_logger(run_dir)
    try:
        return _run(stage, config, batches, max_steps, dev, seed, on_step, run_dir, logger,
                    config_notes, t_call)
    finally:
        close_logger(logger)


def _run(stage, config, batches, max_steps, dev, seed, on_step, run_dir, logger, config_notes,
         t_call) -> dict:
    logger.info(f"stage={stage} run_dir={run_dir} device={dev}")
    for note in config_notes:
        logger.info(note)
    global_seed = int(config.get("global_seed", 42)) if seed is None else int(seed)
    train_data_cfg = dict(get_path(config, "train_data.params", {}) or {})

    validate_pretrained_paths(config, stage)
    tokenizer = load_tokenizer(config.get("pretrained_model_path"),
                               strict=bool(config.get("strict_pretrained", False)))
    loader = None
    if batches is None:
        # the train_data target names the JAX package's class; the port picks
        # its own by stage, as the JAX trainer does (trainers.py:379)
        dataset = UnrealTrajVideoDataset(**train_data_cfg, seed=global_seed)
        loader = ShardedLoader(dataset, batch_size=int(config.get("train_batch_size", 1)),
                               collate_fn=UnrealTrajVideoDataset.collate_fn,
                               num_workers=int(config.get("num_workers", 4)), seed=global_seed)
        if len(loader) == 0:
            raise ValueError(
                f"empty data loader: dataset has {len(dataset)} examples but "
                f"train_batch_size={loader.batch_size} with drop_last — no full batch")

    dtype = torch.bfloat16 if config.get("mixed_precision_training", True) else torch.float32
    models = init_models(config, stage, global_seed, dev)
    models, _ = load_pretrained(models, config, stage, logger)
    train_mm = bool(config.get("train_mm", False))
    unet_rule = lambda n: stage2_cmc_unet_trainable(n) or (train_mm and stage3_mm_trainable(n))
    trainable = {**partition_params(models["unet"], unet_rule, "unet."),
                 **partition_params(models["pose_encoder"], lambda n: True, "pose_encoder.")}
    for key in ("vae", "text"):
        partition_params(models[key], lambda n: False)
    # fp32 masters taken before the cast (the files' values); an fp32 model's
    # tensors are their own masters
    masters = ({n: p.detach().clone() for n, p in trainable.items()}
               if dtype != torch.float32 else None)
    cast_models_(models, dtype)
    frozen = [p for m in models.values() for p in m.parameters() if not p.requires_grad]
    schedule = DiffusionSchedule.from_config(**(config.get("noise_scheduler_kwargs") or {}))
    cfg = step_config(config)

    steps_per_epoch = len(loader) if loader is not None else None
    max_steps = max_steps or int(config.get("max_train_steps", 100))
    if max_steps == -1:
        # epoch-denominated run length (train_cam_ctrl.py:369-371)
        max_train_epoch = int(config.get("max_train_epoch", -1))
        if max_train_epoch == -1 or steps_per_epoch is None:
            raise ValueError("max_train_steps: -1 requires max_train_epoch and the dataset "
                             "(reference train_cam_ctrl.py:370 asserts the same)")
        max_steps = max_train_epoch * steps_per_epoch
        logger.info(f"max_train_epoch {max_train_epoch} x {steps_per_epoch} batches/epoch "
                    f"-> max_train_steps {max_steps}")
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
    logger.info(f"dtype={dtype} trainable params: {n_train / 1e6:.2f}M; "
                f"frozen: {n_frozen / 1e6:.2f}M")

    ckpt_steps = int(config.get("checkpointing_steps", -1))
    if ckpt_steps == -1:
        # epoch-denominated cadence (train_cam_ctrl.py:373-375); both keys
        # -1 = the unconditional end-of-run save only
        ckpt_epochs = int(config.get("checkpointing_epochs", -1))
        if ckpt_epochs != -1 and steps_per_epoch is not None:
            ckpt_steps = ckpt_epochs * steps_per_epoch
            logger.info(f"checkpointing_epochs {ckpt_epochs} x {steps_per_epoch} "
                        f"batches/epoch -> checkpointing_steps {ckpt_steps}")

    resume_from = config.get("resume_from")
    if resume_from == "auto":
        resume_from = ckpt.find_auto_resume(str(config["output_dir"]),
                                            config.get("name", f"{stage}-run"))
        if resume_from is None:
            logger.info("resume_from: auto — no prior checkpoint, starting fresh")
    epoch, start_batch = 0, 0
    if resume_from:
        restore_state(state, ckpt.restore_native(str(resume_from)))
        logger.info(f"resumed from {resume_from} at step {state.step}")
        if steps_per_epoch is not None:
            # exact data-order continuation: the epoch and the consumed
            # batches of the partial epoch (one batch a step, no accumulation)
            epoch, start_batch = divmod(state.step, steps_per_epoch)
            logger.info(f"resume data order: epoch {epoch}, skipping {start_batch} "
                        f"already-consumed batches")
    global_step = state.step
    checksums = {"trainable": [checksum(trainable.values())], "frozen": [checksum(frozen)]}

    def batch_source():
        """(epoch, raw batch, device batch), one per step; on the prefetch
        thread, loader wait + tokenize + host-to-device copy overlap the
        previous step."""
        if loader is not None:
            for ep, raw in loader.epochs(start_epoch=epoch, start_batch=start_batch):
                yield ep, raw, host_batch(raw, tokenizer, dev)
        else:
            for raw in batches:
                yield 0, raw, host_batch(raw, tokenizer, dev)

    prefetch_depth = int(config.get("prefetch_batches", 1))
    source, prefetcher = batch_source(), None
    if prefetch_depth > 0:
        source = prefetcher = ThreadPrefetcher(source, depth=prefetch_depth)
    async_ckpt = bool(config.get("async_checkpointing", True))
    writer = AsyncCheckpointWriter()
    checkpoints: list[dict] = []

    def checkpoint(step_epoch: int, wait: bool) -> None:
        t0 = time.perf_counter()
        saved = host_state(state, step_epoch)  # before the next step changes the state
        copy_s = time.perf_counter() - t0

        def write():
            checkpoints.append({**save_checkpoints(run_dir, saved, config), "copy_s": copy_s})
            c = checkpoints[-1]
            logger.info(f"checkpoint step {c['step']}: host copy {c['copy_s']:.3f}s, write "
                        f"{c['write_s']:.3f}s, {c['bytes']} bytes")

        if wait:
            write()
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
    metrics_out: dict = {}
    losses, step_s, data_s = [], [], []
    first_step_s = None
    last_saved_step = -1
    step_gen = torch.Generator(device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = kernel_launches(backward=True)
    t_start = time.perf_counter()
    data_t0 = time.perf_counter()
    try:
        while global_step < max_steps:
            epoch, raw, batch = next(source)
            data_s.append(time.perf_counter() - data_t0)
            if global_step == 0 and do_sanity:
                _sanity_check_dump(run_dir, raw)
            # step k's draws: a function of (seed, k) alone, so a resumed
            # run's step k draws what an uninterrupted run's step k drew
            step_gen.manual_seed(global_seed * 1_000_003 + global_step)
            draws = draw_cam(step_gen, batch, cfg, schedule)
            state, metrics = step_fn(state, batch, draws)
            global_step = state.step
            last = {k: float(v) for k, v in metrics.items()}  # waits for the step
            step_s.append(time.perf_counter() - data_t0)
            losses.append(last["loss"])
            if first_step_s is None:
                first_step_s = time.perf_counter() - t_call
            if on_step is not None:
                on_step(state, metrics, draws)
            if global_step % logger_interval == 0 or global_step == max_steps:
                eta = (max_steps - global_step) * step_s[-1]
                logger.info(f"step {global_step}/{max_steps} loss {last['loss']:.4f} "
                            f"lr {state.optimizer.schedule(global_step - 1):.2e} "
                            f"data {data_s[-1]:.3f}s iter {step_s[-1]:.3f}s "
                            f"eta {format_time(eta)}{_mem_str(dev)}")
                metrics_out = dict(last)
            if ckpt_steps > 0 and global_step % ckpt_steps == 0:
                checkpoint(epoch, wait=not async_ckpt)
                last_saved_step = global_step
            data_t0 = time.perf_counter()
            if stop_requested.is_set():
                logger.info(f"stopping on preemption signal at step {global_step}; "
                            f"final checkpoint follows")
                metrics_out["preempted"] = True
                break
    finally:
        writer.wait()  # surface write failures; order the final save
        if prefetcher is not None:
            prefetcher.close()
        if loader is not None:
            loader.close()
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)

    if global_step != last_saved_step:
        checkpoint(epoch, wait=True)
    launches = {k: v - launches0[k] for k, v in kernel_launches(backward=True).items()}
    checksums["trainable"].append(checksum(trainable.values()))
    checksums["frozen"].append(checksum(frozen))
    metrics_out.update(steps=global_step, wall_s=time.perf_counter() - t_start, run_dir=run_dir)
    if record:
        metrics_out["loss_history"] = list(losses)
    metrics_out.update(
        losses=losses, step_s=step_s, data_s=data_s, first_step_s=first_step_s,
        checkpoints=checkpoints, launches=launches,
        peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None,
        trainable_params=n_train, frozen_params=n_frozen, checksums=checksums)
    return metrics_out
