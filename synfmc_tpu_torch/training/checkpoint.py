"""Checkpoints: the trainer's resumable state, and the reference's torch
bundles both ways.

The counterpart of synfmc_tpu/training/checkpoint.py.

- **Resumable state** (``save_native`` / ``restore_native``): the JAX
  package writes the whole TrainState with Orbax; the port writes one
  ``torch.save`` file, ``step-N/state.pt`` under the run's ``checkpoints``
  directory, holding the fp32 masters, the AdamW moments and update count,
  the step and the epoch, all on the CPU.  The frozen weights are not in
  it: a resumed run makes them again from the seed and the pretrained
  files.  A step directory is written under a temporary name and renamed
  into place, so that ``latest_native`` never finds a partial one.
  ``latest_native`` and ``find_auto_resume`` are the JAX package's (:91-134).
  On a mesh rank 0 alone writes (``save_native`` raises elsewhere), from
  the whole state that every rank has assembled (under ``mesh.fsdp`` > 1
  gathered from the ranks' rows), so the file is the same whatever the
  layout; every rank reads the same file, and the trainer puts a barrier
  after a write that a later step or run could read.
- **Reference bundles**, state dicts by reference name on the CPU, the
  ``optimizer_state_dict`` in ``torch.optim.AdamW`` form with its parameters
  in the reference's positional order (``export_adamw_state_dict``, from
  synfmc_tpu/interop/torch_port.py): ``save_stage1_bundle`` (:179)
  ``lora-step-N.ckpt``; ``save_stage2_bundle`` (:202) ``cmcm-step-N.ckpt``;
  ``save_stage3_bundles`` (:224) ``omcm-step-N.ckpt`` and, when those sets
  train, ``cmcm-step-N.ckpt`` and ``img-lora-step-N.ckpt``.
- **Reading** a bundle into the port's modules: ``torch_load_state_dict``
  (:167) and ``load_into_params`` (:299) as ``load_into_module``.  The
  port's modules carry the reference's state-dict names, so a bundle's
  tensors load by name; the checks are the JAX package's: every checkpoint
  key must land in the module, shapes must agree, and a strict load must
  cover the module.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Mapping, Optional

import torch
import torch.distributed as dist

# Checkpoint keys with no parameter behind them (synfmc_tpu/interop/
# torch_port.py:185): AnimateDiff's temporal PE table, BatchNorm counters and
# CLIP's position ids.  The port's temporal PE is a non-persistent buffer
# named ``...attention_blocks.N.pe``, so ``...pos_encoder.pe`` never matches
# a key of the module and is dropped before loading.
IGNORABLE = re.compile(r"(pos_encoder\.pe|num_batches_tracked|position_ids)$")


def torch_load_state_dict(path: str) -> dict:
    """A torch checkpoint (a state dict or a bundle of them) on the CPU.
    Full unpickling, as the JAX package does: load only trusted files."""
    return torch.load(path, map_location="cpu", weights_only=False)


def load_into_module(module: torch.nn.Module, state_dict: Mapping, kind: str,
                     strict: bool = False) -> torch.nn.Module:
    """Copy ``state_dict``'s tensors into ``module`` (its dtype, device and
    memory format kept).  Raises ValueError on a shape mismatch,
    AssertionError when a checkpoint key (other than ``IGNORABLE`` ones) has
    no place in the module, and with ``strict`` KeyError when a module key
    has no tensor in the checkpoint."""
    own = module.state_dict()
    tensors, unused = {}, []
    for name, value in state_dict.items():
        if IGNORABLE.search(name):
            continue
        if name not in own:
            unused.append(name)
            continue
        t = torch.as_tensor(value)
        if tuple(t.shape) != tuple(own[name].shape):
            raise ValueError(f"shape mismatch {name}: checkpoint {tuple(t.shape)} vs "
                             f"{kind} {tuple(own[name].shape)}")
        tensors[name] = t
    if unused:
        raise AssertionError(f"unconsumed {kind} checkpoint keys: {unused[:5]}")
    missing = [k for k in own if k not in tensors]
    if strict and missing:
        raise KeyError(f"missing checkpoint tensors for {len(missing)} {kind} keys, "
                       f"e.g. {missing[:5]}")
    module.load_state_dict(tensors, strict=False)
    return module


# ---------------------------------------------------------------------------
# resumable state
# ---------------------------------------------------------------------------

NATIVE_FILE = "state.pt"


def save_native(ckpt_dir: str, step: int, state: dict) -> str:
    """Write ``state`` (tensors on the CPU, ints, dicts) as
    ``ckpt_dir/step-{step}/state.pt``; returns the step directory.  Rank 0
    of a process group alone writes."""
    if dist.is_initialized() and dist.get_rank() != 0:
        raise RuntimeError(f"rank {dist.get_rank()}: the resumable state is written by rank 0 "
                           f"alone")
    path = os.path.join(os.path.abspath(ckpt_dir), f"step-{step}")
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, NATIVE_FILE))
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def restore_native(path: str) -> dict:
    """The state ``save_native`` wrote to the step directory ``path``."""
    return torch.load(os.path.join(path, NATIVE_FILE), map_location="cpu", weights_only=True)


def find_auto_resume(output_dir: str, name: str) -> Optional[str]:
    """Latest resumable state across this job's timestamped run dirs.

    ``resume_from: auto`` support: run dirs are ``{output_dir}/{name}-<ts>``
    (a restarted job gets a fresh dir, so plain latest_native can't see the
    previous attempt).  Scans every ``{name}-*/checkpoints`` and returns the
    highest-step directory (ties: newest mtime), or None when this is the
    first attempt.
    """
    if not os.path.isdir(output_dir):
        return None
    # match exactly this job's dirs: {name}-%Y-%m-%dT%H-%M (a job named
    # "cam" must not pick up "cam-hires-..." checkpoints)
    pat = re.compile(re.escape(name) + r"-\d{4}-\d{2}-\d{2}T\d{2}-\d{2}$")
    best: tuple[int, float, str] | None = None
    for run in os.listdir(output_dir):
        if run != name and not pat.match(run):
            continue
        path = latest_native(os.path.join(output_dir, run, "checkpoints"))
        if path is None:
            continue
        step = int(os.path.basename(path)[5:])
        key = (step, os.path.getmtime(path), path)
        if best is None or key[:2] > best[:2]:
            best = key
    return best[2] if best else None


def latest_native(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step-") and name[5:].isdigit():
            steps.append(int(name[5:]))
    if not steps:
        return None
    return os.path.join(ckpt_dir, f"step-{max(steps)}")


# ---------------------------------------------------------------------------
# reference-compatible torch bundles
# ---------------------------------------------------------------------------

# Sibling order within each reference module, replicating torch's
# named_parameters() order (module-definition order, not alphabetical):
# synfmc_tpu/interop/torch_port.py's table.
_NAMED_PARAM_ORDER = {
    "to_q": 0, "to_k": 1, "to_v": 2, "to_out": 3, "processor": 4,
    "to_q_lora": 0, "to_k_lora": 1, "to_v_lora": 2, "to_out_lora": 3,
    "in_conv": 0, "block1": 1, "block2": 2, "skep": 3, "down_opt": 4,
    "attention_blocks": 0, "norms": 1, "ff": 2, "ff_norm": 3,
    "norm": 0, "proj_in": 1, "transformer_blocks": 2, "proj_out": 3,
    "encoder_down_conv_blocks": 0, "encoder_down_attention_blocks": 1,
    "encoder_conv_in": 2,
    "body": 0, "conv_in": 1, "zero_conv_in": 2, "zero_conv_out_list": 3,
    "down_blocks": 5, "mid_block": 6, "up_blocks": 7,
    "weight": 0, "bias": 1,
}


def _order_key(name: str):
    key = []
    for p in name.split("."):
        if p.isdigit():
            key.append((1, int(p), ""))
        elif p in _NAMED_PARAM_ORDER:
            key.append((0, _NAMED_PARAM_ORDER[p], ""))
        else:
            key.append((2, 0, p))
    return key


def torch_parameter_order(names) -> list[str]:
    """State-dict names in the reference's ``named_parameters()`` order, the
    positional order torch optimizers key their per-parameter state by."""
    return sorted(names, key=_order_key)


# torch.optim.AdamW param_group keys beyond the hyperparameters; load_state_dict
# restores groups verbatim, so every key AdamW.step() reads must be present.
_ADAMW_GROUP_DEFAULTS = {
    "amsgrad": False, "maximize": False, "foreach": None,
    "capturable": False, "differentiable": False, "fused": None,
}


def export_adamw_state_dict(segments: list[dict], count: int, lr: float,
                            betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                            weight_decay: float = 1e-2) -> dict:
    """A ``torch.optim.AdamW.state_dict()`` from each parameter's moments.

    ``segments``: dicts ``{state-dict name: (exp_avg, exp_avg_sq)}`` in the
    reference's trainable_params order (stage 2: pose encoder, merge, mm);
    within a segment, ``torch_parameter_order``.  ``param_names`` records
    the name at each index (``load_state_dict`` reads only ``state`` and
    ``param_groups``)."""
    names, state = [], {}
    for segment in segments:
        for name in torch_parameter_order(segment):
            exp_avg, exp_avg_sq = segment[name]
            state[len(names)] = {"step": torch.tensor(float(count)),
                                 "exp_avg": exp_avg.float().contiguous(),
                                 "exp_avg_sq": exp_avg_sq.float().contiguous()}
            names.append(name)
    group = {"lr": lr, "betas": tuple(betas), "eps": eps, "weight_decay": weight_decay,
             "initial_lr": lr, **_ADAMW_GROUP_DEFAULTS, "params": list(range(len(names)))}
    return {"state": state, "param_groups": [group], "param_names": names}


def _cpu(state: Mapping) -> dict:
    return {k: v.detach().to("cpu").contiguous() for k, v in state.items()}


def _save(bundle: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(bundle, path)


def save_stage1_bundle(path: str, lora_state: Mapping, epoch: int, global_step: int,
                       optimizer_state_dict: Optional[dict] = None) -> None:
    """The reference's ``lora-step-N.ckpt`` (train_image_lora.py:282-296):
    ``{epoch, global_step, lora_state_dict, optimizer_state_dict}``; the
    optimizer key is always there (None without Adam state)."""
    _save({"epoch": epoch, "global_step": global_step, "lora_state_dict": _cpu(lora_state),
           "optimizer_state_dict": optimizer_state_dict}, path)


def save_stage3_bundles(out_dir: str, global_step: int, omcm_state: Mapping,
                        pose_encoder_state: Optional[Mapping] = None,
                        merge_state: Optional[Mapping] = None,
                        mm_state: Optional[Mapping] = None,
                        lora_state: Optional[Mapping] = None, epoch: int = 0,
                        optimizer_state_dict: Optional[dict] = None) -> list[str]:
    """Stage 3's files (train_cam_obj_ctrl.py:948-980); returns their paths.

    ``omcm-step-N.ckpt`` holds the adapter, the epoch, the step and the
    optimizer state, and with ``mm_state`` (train_mm's norm / proj tensors,
    which the reference trains but writes nowhere) an extra
    ``mm_state_dict``.  With a trained pose encoder (train_cm),
    ``cmcm-step-N.ckpt`` holds it and the merge tensors ('merge' in the name,
    'lora' not in it); with ``lora_state`` (train_image_lora),
    ``img-lora-step-N.ckpt`` holds the LoRA."""
    omcm = {"epoch": epoch, "global_step": global_step, "omcm_state_dict": _cpu(omcm_state),
            "optimizer_state_dict": optimizer_state_dict}
    if mm_state:
        omcm["mm_state_dict"] = _cpu(mm_state)
    paths = [os.path.join(out_dir, f"omcm-step-{global_step}.ckpt")]
    _save(omcm, paths[-1])
    if pose_encoder_state is not None:
        paths.append(os.path.join(out_dir, f"cmcm-step-{global_step}.ckpt"))
        _save({"epoch": epoch, "global_step": global_step,
               "pose_encoder_state_dict": _cpu(pose_encoder_state),
               "attention_processor_state_dict": _cpu(merge_state or {})}, paths[-1])
    if lora_state is not None:
        paths.append(os.path.join(out_dir, f"img-lora-step-{global_step}.ckpt"))
        _save({"epoch": epoch, "global_step": global_step, "lora_state_dict": _cpu(lora_state)},
              paths[-1])
    return paths


def save_stage2_bundle(path: str, pose_encoder_state: Mapping, merge_state: Mapping, epoch: int,
                       global_step: int, mm_state: Optional[Mapping] = None,
                       optimizer_state_dict: Optional[dict] = None) -> None:
    """The reference's ``cmcm-step-N.ckpt`` (train_cam_ctrl.py:669-684):
    state dicts by reference name, on the CPU; a train_mm run's motion-module
    tensors go to their own ``mm_state_dict``."""
    bundle = {
        "epoch": epoch,
        "global_step": global_step,
        "optimizer_state_dict": optimizer_state_dict,
        "pose_encoder_state_dict": _cpu(pose_encoder_state),
        "attention_processor_state_dict": _cpu(merge_state),
    }
    if mm_state:
        bundle["mm_state_dict"] = _cpu(mm_state)
    _save(bundle, path)
