"""Validation renders during training (synfmc_tpu/training/trainers.py:809-987,
the reference's validation passes, train_cam_ctrl.py:686-779 and
train_cam_obj_ctrl.py:619-780).

The pipeline is built from the trainer's live modules (the tensors the
step updates), never from copies taken at start-up, so whatever trains is
what renders.  It runs without gradients, on the modules' working type, and
puts each module's ``training`` flag back as it found it.

Files under ``run_dir/samples/{step}/``:
- stage 1: ``validation.png``, the config's prompts as one grid of single
  frames (``video_length=1``);
- stages cam and obj with a dataset (``validation_data.use_dataset``, on by
  default): per real clip ``i`` drawn by ``create_validation_samples``,
  ``real-i.gif``, ``cm-i.gif`` (the clip's camera), for obj also
  ``omcm-i.gif`` (camera and the clip's objects) and the per-frame union
  masks as PNGs in ``i_masks/`` (and ``i_real_masks/`` with sphere masks),
  ``label_i.txt`` (prompt and frame paths), ``cam_label_compute_i.txt`` and
  ``cam_label_gt_i.txt``;
- otherwise the prompts along the neutral camera: ``validation.gif`` and
  ``i-camera.txt``.

Each render starts from a generator seeded with ``global_seed``, as the
JAX package hands every render the same key: the pixels differ between the
two packages (different random streams), the file set and the text files
do not.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from synfmc_tpu_torch.config import get_path
from synfmc_tpu_torch.data.image import write_png
from synfmc_tpu_torch.geometry.plucker import plucker_embedding
from synfmc_tpu_torch.geometry.relative import absolute_from_relative_cams
from synfmc_tpu_torch.pipelines.animation import AnimationPipeline
from synfmc_tpu_torch.training.steps import rt_to_c2w
from synfmc_tpu_torch.utils.traj_features import build_adapter_inputs
from synfmc_tpu_torch.utils.video import (
    save_camera_info_txt,
    save_camera_label_txt,
    save_image_grid,
    save_videos_grid,
)


def build_validation_pipeline(models: dict, tokenizer, schedule, device) -> AnimationPipeline:
    """An AnimationPipeline over the trainer's own modules (no copies)."""
    return AnimationPipeline(unet=models["unet"], vae=models["vae"], text_encoder=models["text"],
                             tokenizer=tokenizer, schedule=schedule,
                             pose_encoder=models.get("pose_encoder"),
                             adapter=models.get("adapter"), device=device)


def run_validation(stage: str, run_dir: str, global_step: int, models: dict, config: dict,
                   tokenizer, schedule, dataset=None, device=None) -> list[str]:
    """Render the validation samples of ``global_step``; returns the files
    written, relative to ``run_dir/samples/{global_step}``."""
    flags = {m: m.training for module in models.values() for m in module.modules()}
    try:
        with torch.no_grad():
            _render(stage, run_dir, global_step, models, config, tokenizer, schedule, dataset,
                    device)
    finally:
        for m, flag in flags.items():
            m.train(flag)
    out_dir = os.path.join(run_dir, "samples", str(global_step))
    return sorted(os.path.relpath(os.path.join(d, f), out_dir)
                  for d, _, files in os.walk(out_dir) for f in files)


def _render(stage, run_dir, global_step, models, config, tokenizer, schedule, dataset, device):
    val = config.get("validation_data") or {}
    out_dir = os.path.join(run_dir, "samples", str(global_step))
    pipe = build_validation_pipeline(models, tokenizer, schedule, device)
    train_params = get_path(config, "train_data.params", {}) or {}
    h, w = tuple(train_params.get("sample_size", (256, 384)))
    seed = int(config.get("global_seed", 42))
    kw = dict(height=h, width=w, num_inference_steps=int(val.get("num_inference_steps", 25)),
              guidance_scale=float(val.get("guidance_scale", 8.0)))
    num = int(val.get("num", 2))

    def render(prompts, frames, **extra):
        gen = torch.Generator(device=pipe.device).manual_seed(seed)
        out = pipe(prompts, video_length=frames, generator=gen, **kw, **extra)
        return out.float().cpu().numpy()

    if stage != "lora" and dataset is not None and bool(val.get("use_dataset", True)):
        os.makedirs(out_dir, exist_ok=True)
        samples = dataset.create_validation_samples(num)
        _render_dataset(stage, out_dir, pipe, samples, config, h, w, render)
        return

    prompts = list(val.get("prompts", []))[:num]
    if not prompts:
        return
    os.makedirs(out_dir, exist_ok=True)
    if stage == "lora":
        save_image_grid(render(prompts, 1)[:, 0], os.path.join(out_dir, "validation.png"))
        return
    f = int(train_params.get("sample_n_frames", 16))
    n = len(prompts)
    # the neutral, straight-ahead trajectory
    intr = torch.tensor([w, h, 0, 0], dtype=torch.float32).expand(n, f, 4)
    c2w = torch.eye(4).expand(n, f, 4, 4)
    for i in range(n):
        save_camera_info_txt(os.path.join(out_dir, f"{i}-camera.txt"), intr[i].numpy(),
                             np.broadcast_to(np.eye(3, 4, dtype=np.float32), (f, 3, 4)))
    videos = render(prompts, f, plucker=plucker_embedding(intr, c2w, h, w))
    save_videos_grid(videos, os.path.join(out_dir, "validation.gif"))


def _render_dataset(stage, out_dir, pipe, samples, config, h, w, render):
    train_params = get_path(config, "train_data.params", {}) or {}
    use_sphere = bool(train_params.get("use_sphere_mask", False))
    cam_scale = float(train_params.get("cam_translation_rescale_factor", 1.0))
    omcm_min_step = int(config.get("omcm_min_step", 700))
    for i, s in enumerate(samples):
        frames = s["pixel_values"].shape[0]
        save_videos_grid((s["pixel_values"] * 0.5 + 0.5)[None],
                         os.path.join(out_dir, f"real-{i}.gif"))
        rt = torch.as_tensor(np.asarray(s["camera_rt"]), dtype=torch.float32)[None]
        intr = torch.as_tensor(np.asarray(s["intrinsics"]), dtype=torch.float32)[None]
        plucker = plucker_embedding(intr, rt_to_c2w(rt), h, w)
        save_videos_grid(render([s["prompt"]], frames, plucker=plucker),
                         os.path.join(out_dir, f"cm-{i}.gif"))

        if stage == "obj" and pipe.adapter is not None:
            masks = s["circle_masks"] if use_sphere else s["obj_masks"]
            feats, mask = build_adapter_inputs(
                torch.as_tensor(np.asarray(s["obj_info"]), dtype=torch.float32)[None],
                torch.as_tensor(np.asarray(masks), dtype=torch.float32)[None])
            traj = pipe.encode_traj(feats, mask, frames)
            save_videos_grid(render([s["prompt"]], frames, plucker=plucker, traj_features=traj,
                                    omcm_min_step=omcm_min_step),
                             os.path.join(out_dir, f"omcm-{i}.gif"))
            _dump_masks(masks, os.path.join(out_dir, f"{i}_masks"))
            if use_sphere:
                _dump_masks(s["obj_masks"], os.path.join(out_dir, f"{i}_real_masks"))

        with open(os.path.join(out_dir, f"label_{i}.txt"), "w") as fo:
            fo.write(s["prompt"] + "\n")
            for p in s["img_paths"]:
                fo.write(str(p) + "\n")
        abs_computed = absolute_from_relative_cams(
            s["camera_info"][0], np.asarray(s["camera_rt"]).reshape(-1, 3, 4), cam_scale)
        save_camera_label_txt(os.path.join(out_dir, f"cam_label_compute_{i}.txt"), "labels",
                              abs_computed)
        save_camera_label_txt(os.path.join(out_dir, f"cam_label_gt_{i}.txt"), "gt labels",
                              np.asarray(s["camera_info"])[:, :3, :])


def _dump_masks(mask_set, mask_dir: str) -> None:
    """(F, O, H, W) masks -> one gray PNG a frame of their union."""
    os.makedirs(mask_dir, exist_ok=True)
    for t, mk in enumerate(np.max(np.asarray(mask_set), axis=1)):
        write_png(os.path.join(mask_dir, f"{t}.png"), (np.clip(mk, 0, 1) * 255).astype(np.uint8))
