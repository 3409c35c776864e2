"""SynFMC dataset: Unreal-rendered clips with 6D camera + object pose labels.

The port's copy of synfmc_tpu/data/dataset.py:49-772
(``UnrealTrajVideoDataset``, the cam and obj stages' dataset) and :775-815
(``UnrealTrajLoraDataset``, stage 1's single frames), numpy only: frames and
masks are read by ``data/image.py``, whose C++ library is built and loaded
by the constructor, in the parent process, before a loader forks its
workers.  Not ported: the text-only validation prompt generators
(:558-753); the trainer's validation renders draw real clips
(``create_validation_samples``) or the config's prompts.

Behavioral parity with the reference datasets (fmc/data/dataset.py:979
``UnrealTrajLoraDataset``, :2215 ``UnrealTrajVideoDataset``): same on-disk
layout, CSV/JSON metadata parsing, clip/fps/stride sampling, visibility
filtering, caption synthesis hooks, sphere masks, relative-pose construction
(including the first-frame rotation-only rewrite), and rejection resampling on
empty captions.

TPU-native departures:
- pure numpy host pipeline (no torch / torchvision / cv2),
- ragged per-frame object lists are padded to ``max_objects`` with validity
  carried by all-zero masks — the jit-able layout the train steps consume
  (SURVEY.md §7 "ragged object data"),
- explicit ``random.Random(seed)`` instead of global RNG state.

On-disk layout (per reference __init__, dataset.py:4629-4760):
  data_root/Rendered_Traj_Results[_multi]/{static,dynamic}/{i}/{seq}_{frame:04d}.png
  lable_root/Rendered_Traj_Results[_multi]/{static,dynamic}/{i}.json
  mask_root/Rendered_Traj_Results[_multi]/{static,dynamic}/{i}/{frame}/total.png + {k}.png
  seq_csv_root/traj_{static,dynamic}[_multi].csv
  hdri_json_file_path, asset_json_file_path
"""

from __future__ import annotations

import csv
import json
import math
import os
import random
from typing import Optional

import numpy as np

from synfmc_tpu_torch.data import image
from synfmc_tpu_torch.data.captions import (
    assemble_video_caption,
    camera_pose_descriptions,
    csv_param_to_dict,
    get_background_description,
    get_seen_objects,
)
from synfmc_tpu_torch.data.masks import (
    min_enclosing_circle,
    resize_mask_nearest,
    sphere_gaussian_mask,
)
from synfmc_tpu_torch.geometry.euler import euler_to_matrix_v2
from synfmc_tpu_torch.geometry.relative import relative_cams_to_first, relative_obj_to_cam


class UnrealTrajVideoDataset:
    def __init__(
        self,
        data_root: str,
        lable_root: str,
        mask_root: str,
        seq_csv_root: str,
        hdri_json_file_path: str,
        asset_json_file_path: str,
        sample_n_frames: int = 16,
        ori_fps: int = 16,
        time_duration: int = 4,
        tgt_fps_list=(16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4),
        allow_change_tgt: bool = False,
        single_static_num: int = 0,
        single_dynamic_num: int = 0,
        multi_static_num: int = 0,
        multi_dynamic_num: int = 0,
        sample_size=(256, 384),
        is_image: bool = False,
        use_flip: bool = False,
        cam_translation_rescale_factor: float = 1.0,
        obj_translation_rescale_factor: float = 1.0,
        use_sphere_mask: bool = False,
        max_objects: int = 6,
        appearance_percentage: float = 0.0015,
        seed: int = 0,
        **_unused,
    ):
        self.data_root = data_root
        self.lable_root = lable_root
        self.mask_root = mask_root
        self.seq_csv_root = seq_csv_root
        self.sample_n_frames = sample_n_frames
        self.ori_fps = ori_fps
        self.time_duration = time_duration
        self.tgt_fps_list = list(tgt_fps_list)
        self.allow_change_tgt = allow_change_tgt
        self.sample_size = tuple(sample_size) if not isinstance(sample_size, int) else (sample_size, sample_size)
        self.is_image = is_image
        self.use_flip = use_flip
        self.cam_translation_rescale_factor = cam_translation_rescale_factor
        self.obj_translation_rescale_factor = obj_translation_rescale_factor
        self.use_sphere_mask = use_sphere_mask
        self.max_objects = max_objects
        self.appearance_percentage = appearance_percentage
        self.seed = seed
        self.epoch = 0
        self.rng = random.Random(seed)
        image.library()

        with open(hdri_json_file_path) as f:
            self.hdri_json_data = json.load(f)
        with open(asset_json_file_path) as f:
            self.asset_json_data = json.load(f)

        # dataset index over the 4 category dirs (dataset.py:4700-4735)
        self.dataset, self.data_type_list, self.seq_id_list = [], [], []
        counts = {
            ("single", "static"): single_static_num,
            ("single", "dynamic"): single_dynamic_num,
            ("multi", "static"): multi_static_num,
            ("multi", "dynamic"): multi_dynamic_num,
        }
        for (single_type, static_type), num in counts.items():
            suffix = "_multi" if single_type == "multi" else ""
            for i in range(num):
                self.dataset.append(
                    {
                        "annotation_file_path": os.path.join(
                            lable_root, f"Rendered_Traj_Results{suffix}", static_type, f"{i}.json"
                        ),
                        "clip_path": os.path.join(
                            data_root, f"Rendered_Traj_Results{suffix}", static_type, str(i)
                        ),
                    }
                )
                self.data_type_list.append(f"{single_type}_{static_type}")
                self.seq_id_list.append(str(i))
        self.length = len(self.dataset)
        self.seq_meta_data_map = self._get_csv_meta_data_map()

    # ---- metadata ----

    def _get_csv_meta_data_map(self) -> dict:
        """CSV trajectory metadata: Group row = camera, following rows =
        objects (dataset.py:4760-4800)."""
        out = {}
        for static_type in ("static", "dynamic"):
            for suffix, single_type in (("", "single"), ("_multi", "multi")):
                csv_path = os.path.join(self.seq_csv_root, f"traj_{static_type}{suffix}.csv")
                seq_meta: dict = {}
                if os.path.exists(csv_path):
                    with open(csv_path, encoding="utf-8") as f:
                        rows = list(csv.DictReader(f))
                    seq_id, body_id = None, -1
                    for row in rows:
                        if row["Type"] == "Group":
                            seq_id = row.pop("Seq_ID")
                            body_id = -1
                            seq_meta[seq_id] = {"camera": row, "objects": {}}
                        else:
                            body_id += 1
                            row.pop("Seq_ID")
                            seq_meta[seq_id]["objects"][str(body_id)] = row
                out[f"{single_type}_{static_type}"] = seq_meta
        return out

    # ---- clip sampling (dataset.py:5166-5303) ----

    def get_clip_time_list(self, idx: int) -> list:
        """Merge camera Time_Range_List segments by target object."""
        meta = self.seq_meta_data_map[self.data_type_list[idx]][self.seq_id_list[idx]]
        comment = csv_param_to_dict(meta["camera"]["Comment"])
        tgt_obj_ids = eval(comment["tgt_obj_id_list"])  # noqa: S307 — trusted metadata
        ranges = eval(meta["camera"]["Time_Range_List"])  # noqa: S307
        clips, prev = [], None
        for time_range, tgt in zip(ranges, tgt_obj_ids):
            if prev is None or tgt != prev:
                clips.append(list(time_range))
            else:
                assert clips[-1][-1] == time_range[0]
                clips[-1][-1] = time_range[-1]
            prev = tgt
        return clips

    def sample_clip_from_image_folder(self, folder: str, clip_time_list: list,
                                      start_frame: Optional[int] = None):
        """Segment choice + tgt_fps + stride + PNG reads (dataset.py:5166-5238)."""
        n = self.sample_n_frames
        candidates, fps_mins = [], []
        for start, end in clip_time_list:
            length = end - start
            if length < n:
                continue
            max_interval = math.floor((length - 1) / (n - 1))
            assert max_interval > 0
            candidates.append((start, end))
            fps_mins.append(math.ceil(self.ori_fps / max_interval))
        if not candidates:
            return None, None, None, False
        k = self.rng.randint(0, len(candidates) - 1)
        start, end = candidates[k]
        length = end - start
        tgt_fps = self.rng.randint(fps_mins[k], self.ori_fps)
        interval = round(self.ori_fps / tgt_fps)
        if length - (n - 1) * interval - 1 < 0:
            interval = math.floor(self.ori_fps / tgt_fps)

        files = sorted(
            os.path.join(folder, f) for f in os.listdir(folder)
            if os.path.isfile(os.path.join(folder, f))
        )[:-1]  # the last frame has no forward annotation (dataset.py:5208)
        in_range = []
        for path in files:
            frame_num = int(os.path.basename(path).split("_")[1].split(".")[0])
            if start <= frame_num < end:
                in_range.append(path)
        in_range = sorted(in_range)
        assert len(in_range) == length, (len(in_range), length)
        if start_frame is None:
            max_start = length - (n - 1) * interval - 1
            start_frame = self.rng.randint(0, max_start)
        picks = [in_range[start_frame + i * interval] for i in range(n)]
        frame_indices = [int(os.path.basename(p).split("_")[1].split(".")[0]) for p in picks]
        return tgt_fps, picks, frame_indices, True

    # ---- per-frame labels ----

    @classmethod
    def get_camera_info_np(cls, label_data: dict, frame_idx_list) -> tuple[np.ndarray, np.ndarray]:
        """Annotation JSON -> (F, 4, 4) cameras + (F, 4) intrinsics.

        Quirks preserved (dataset.py:5427-5457): euler passed as
        (entry[5], entry[4], entry[3]); intrinsics row = entry[-3:-1] + [0, 0]
        i.e. fx = sensor_w, fy = sensor_h, cx = cy = 0.
        """
        with open(label_data["annotation_file_path"]) as f:
            annotation = json.load(f)
        cams, intrinsics = [], []
        for t in frame_idx_list:
            entry = annotation["camera"][t]
            xyz, euler = entry[:3], entry[3:6]
            rot = euler_to_matrix_v2(euler[2], euler[1], euler[0])
            m = np.eye(4)
            m[:3, :3] = rot
            m[:3, 3] = xyz
            cams.append(m)
            intrinsics.append(list(entry[-3:-1]) + [0, 0])
        return np.stack(cams), np.asarray(intrinsics, dtype=np.float32)

    def get_text_prompt_and_mask_list(self, idx: int, frame_idx_list):
        """Per-frame visibility + caption assembly (dataset.py:4815-5155).

        Returns (caption, background, per_frame) where per_frame is a list of
        dicts {seen_idxs, total_mask, obj_masks, obj_infos (n,4,4)}.
        """
        data_type = self.data_type_list[idx]
        seq_id = self.seq_id_list[idx]
        meta = self.seq_meta_data_map[data_type][seq_id]
        static_type = "static" if "static" in data_type else "dynamic"
        suffix = "_multi" if "multi" in data_type else ""

        background = get_background_description(self.hdri_json_data, meta["camera"], self.rng)

        with open(self.dataset[idx]["annotation_file_path"]) as f:
            annotation = json.load(f)
        scene_type = csv_param_to_dict(meta["camera"]["Comment"])["scene_type"]

        per_frame = []
        for t in frame_idx_list:
            mask_root = os.path.join(
                self.mask_root, f"Rendered_Traj_Results{suffix}", static_type, seq_id, str(t)
            )
            seen_ids, seen_idxs, total_mask, obj_masks, obj_descs, act_descs, act_types = get_seen_objects(
                mask_root, self.asset_json_data, meta, t,
                appearance_percentage=self.appearance_percentage, max_num=self.max_objects,
            )
            obj_infos = []
            for obj_idx in seen_idxs:
                entry = annotation["objects"][str(obj_idx)][t]
                xyz, euler = entry[-3:], entry[3:6]
                m = np.eye(4)
                m[:3, :3] = euler_to_matrix_v2(euler[2], euler[1], euler[0])
                m[:3, 3] = xyz
                obj_infos.append(m)
            per_frame.append(
                dict(
                    seen_ids=seen_ids,
                    seen_idxs=seen_idxs,
                    total_mask=total_mask,
                    obj_masks=obj_masks,
                    obj_infos=np.stack(obj_infos) if obj_infos else np.zeros((0, 4, 4)),
                    obj_descs=obj_descs,
                    act_descs=act_descs,
                    act_types=act_types,
                )
            )

        if any(len(fr["seen_idxs"]) == 0 for fr in per_frame):
            return "", background, per_frame  # rejection-sampled by __getitem__

        # key frames for the temporal caption (dataset.py:4901)
        f_total = len(frame_idx_list)
        chosen = [i for i in range(0, f_total, max(f_total // 3, 1))][:4]
        keyframes = []
        for ci in chosen:
            fr = per_frame[ci]
            keyframes.append(
                dict(
                    seen_idxs=fr["seen_idxs"],
                    obj_descs=fr["obj_descs"],
                    act_descs=fr["act_descs"],
                    act_types=fr["act_types"],
                    cam_types=camera_pose_descriptions(
                        annotation, fr["seen_idxs"], frame_idx_list[ci]
                    ),
                )
            )
        # single-object tracking is decided over ALL frames (dataset.py:4906-4916)
        is_track_single = all(len(fr["seen_idxs"]) == 1 for fr in per_frame) and (
            len({fr["seen_idxs"][0] for fr in per_frame}) == 1
        )
        caption, background_caption = assemble_video_caption(
            scene_type, background, keyframes,
            is_multi="multi" in data_type, rng=self.rng,
            is_track_single=is_track_single,
        )
        return caption, background_caption, per_frame

    # ---- assembly ----

    def _load_clip(self, img_paths: list) -> np.ndarray:
        """All clip frames decoded+resized to (F, H, W, 3) float32 [0, 1]:
        ``_load_and_resize`` of synfmc_tpu/data/dataset.py:320-326 (RGB,
        PIL's BILINEAR, / 255) through ``data/image.py``."""
        h, w = self.sample_size
        return image.decode_resize_batch(list(img_paths), h, w)

    def _resize_mask(self, mask: np.ndarray) -> np.ndarray:
        h, w = self.sample_size
        m2d = mask[..., 0] if mask.ndim == 3 else mask
        # nearest resize commutes exactly with the dtype cast; resizing the
        # bool/uint8 source first moves 4x fewer bytes
        return resize_mask_nearest(m2d, h, w).astype(np.float32)

    def sample_video_from_image_folder(self, folder: str, tgt_fps: int,
                                       start_frame: Optional[int] = None):
        """Fixed-fps whole-video sampling (dataset.py:5240-5276) — the
        allow_change_tgt=True path."""
        n = self.sample_n_frames
        interval = round(self.ori_fps / tgt_fps)
        length = self.ori_fps * self.time_duration
        files = sorted(
            os.path.join(folder, f) for f in os.listdir(folder)
            if os.path.isfile(os.path.join(folder, f))
        )[:-1]
        in_range = [
            p for p in files
            if 0 <= int(os.path.basename(p).split("_")[1].split(".")[0]) < length
        ]
        assert len(in_range) == length, (len(in_range), length)
        if start_frame is None:
            start_frame = self.rng.randint(0, length - (n - 1) * interval - 1)
        picks = [in_range[start_frame + i * interval] for i in range(n)]
        frame_indices = [int(os.path.basename(p).split("_")[1].split(".")[0]) for p in picks]
        return picks, frame_indices

    def get_batch(self, idx: int) -> Optional[dict]:
        video_path = self.dataset[idx]["clip_path"]
        if self.allow_change_tgt:
            tgt_fps = self.rng.choice(self.tgt_fps_list)
            img_paths, frame_list = self.sample_video_from_image_folder(video_path, tgt_fps)
        else:
            clip_times = self.get_clip_time_list(idx)
            tgt_fps, img_paths, frame_list, found = self.sample_clip_from_image_folder(
                video_path, clip_times
            )
            if not found:
                return None

        camera_info, intrinsics = self.get_camera_info_np(self.dataset[idx], frame_list)
        caption, background, per_frame = self.get_text_prompt_and_mask_list(idx, frame_list)
        if caption == "":
            return None

        pixels = self._load_clip(img_paths)  # (F,H,W,3) [0,1]
        pixels = (pixels - 0.5) / 0.5  # Normalize(0.5, 0.5)

        f = len(frame_list)
        h, w = self.sample_size
        o = self.max_objects
        total_mask = np.stack([self._resize_mask(fr["total_mask"]) for fr in per_frame])[..., None]
        obj_masks = np.zeros((f, o, h, w), np.float32)
        raw_obj_masks = np.zeros((f, o, h, w), np.float32)
        obj_info = np.zeros((f, o, 12), np.float32)
        for fi, fr in enumerate(per_frame):
            rel = relative_obj_to_cam(
                camera_info[fi], fr["obj_infos"], self.obj_translation_rescale_factor
            ) if len(fr["obj_infos"]) else np.zeros((0, 12), np.float32)
            for oi, mask in enumerate(fr["obj_masks"][:o]):
                raw_obj_masks[fi, oi] = self._resize_mask(mask)
                if self.use_sphere_mask:
                    # reference order: nearest-resize to sample_size FIRST,
                    # then circle+Gaussian at target res (dataset.py:5350-62)
                    obj_masks[fi, oi] = sphere_gaussian_mask(raw_obj_masks[fi, oi] > 0.5)
                else:
                    obj_masks[fi, oi] = raw_obj_masks[fi, oi]
                obj_info[fi, oi] = rel[oi]

        flip = self.use_flip and self.rng.random() < 0.5
        if flip:  # RandomHorizontalFlipWithPose parity (dataset.py:885-905)
            pixels = pixels[:, :, ::-1].copy()
            total_mask = total_mask[:, :, ::-1].copy()
            obj_masks = obj_masks[:, :, :, ::-1].copy()
            raw_obj_masks = raw_obj_masks[:, :, :, ::-1].copy()

        camera_rt = relative_cams_to_first(camera_info, self.cam_translation_rescale_factor)
        # first frame -> absolute rotation, zero translation (dataset.py:5496-5507)
        first = np.zeros((3, 4), np.float32)
        first[:3, :3] = camera_info[0][:3, :3]
        camera_rt[0] = first.reshape(-1)

        data_type = self.data_type_list[idx]
        return dict(
            video_path=video_path,
            pixel_values=pixels.astype(np.float32, copy=False),
            caption=caption,
            background_caption=background,
            camera_rt=camera_rt.astype(np.float32, copy=False),
            intrinsics=intrinsics.astype(np.float32, copy=False),
            obj_union_mask=total_mask.astype(np.float32, copy=False),
            obj_info=obj_info,
            obj_masks=obj_masks,
            flip_flag=np.asarray(flip),
            frame_list=frame_list,
            tgt_fps=tgt_fps,
            # validation extras (reference create_validation_prompts tuple,
            # dataset.py:3525-3533 / _v2:4066-4070); collate_fn ignores them
            raw_obj_masks=raw_obj_masks,
            camera_info=camera_info.astype(np.float32, copy=False),
            img_paths=img_paths,
            seen_ids_per_frame=[fr["seen_ids"] for fr in per_frame],
            scene_type=csv_param_to_dict(
                self.seq_meta_data_map[data_type][self.seq_id_list[idx]]["camera"]["Comment"]
            )["scene_type"],
            static_type="static" if "static" in data_type else "dynamic",
        )

    def __len__(self) -> int:
        return self.length

    def set_epoch(self, epoch: int) -> None:
        """Advance the per-epoch RNG stream (DistributedSampler.set_epoch
        analog for sample CONTENT: fps/stride/flip choices vary per epoch)."""
        self.epoch = int(epoch)

    def __getitem__(self, idx: int) -> dict:
        # Sample content is a PURE FUNCTION of (seed, epoch, idx): the item
        # RNG is derived fresh here, so a crash-resumed run mid-epoch draws
        # byte-identical samples to an uninterrupted one, and content does
        # not depend on worker count or job scheduling.  (The reference's
        # stateful torch/global RNG has neither property.)
        ss = np.random.SeedSequence((self.seed, self.epoch, int(idx)))
        self.rng = random.Random(int(ss.generate_state(1)[0]))
        # rejection resampling until a caption exists (dataset.py:5464-5471)
        for _ in range(1000):
            sample = self.get_batch(idx)
            if sample is not None:
                return sample
            idx = self.rng.randint(0, self.length - 1)
        raise RuntimeError("could not sample a captioned clip in 1000 tries")

    # ---- trajectory-bearing validation samples ----

    def create_validation_sample(self, points_diff=None, max_tries: int = 100) -> dict:
        """Draw a REAL captioned clip with full trajectory ground truth.

        Rebuild of the reference validation generators: the base tuple of
        ``create_validation_prompts`` (dataset.py:3000-3533) — (prompt,
        intrinsics, abs cams, rel cams, obj infos, rel objs, obj masks,
        frame idxs, img paths, circle masks, seen ids) — plus the ``_v2``
        extras (scene_type/static_type, 3538) and the ``_with_traj_change``
        circle-center relocation along ``points_diff`` (4073, 4490-4523).

        Returns a dict:
          prompt, background_caption, pixel_values (F,H,W,3 in [-1,1]),
          intrinsics (F,4), camera_info (F,4,4 absolute),
          camera_rt (F,12 relative-to-first, first frame rotation-only),
          obj_info (F,O,12 camera-relative), obj_masks (F,O,H,W raw binary),
          circle_masks (F,O,H,W Gaussian spheres), frame_list, img_paths,
          seen_ids_per_frame, scene_type, static_type.

        ``points_diff``: optional (F, 2) per-frame (dx, dy) pixel offsets;
        every circle mask is re-centered at (first object center +
        points_diff[frame]), clamped to the image — the object-dragging
        demo input of the reference's traj-change generator.
        """
        sample = None
        for _ in range(max_tries):
            idx = self.rng.randint(0, self.length - 1)
            sample = self.get_batch(idx)
            if sample is not None:
                break
        if sample is None:
            raise RuntimeError(f"no valid validation clip found in {max_tries} tries")

        raw = sample["raw_obj_masks"]  # (F,O,H,W) binary
        f, o, h, w = raw.shape
        circle = np.zeros_like(raw)
        first_center = None  # tracked once across the clip (ref 4494-4515)
        for fi in range(f):
            for oi in range(o):
                m = raw[fi, oi]
                if m.max() <= 0:
                    continue
                override = None
                if points_diff is not None:
                    ys, xs = np.nonzero(m)
                    (cx, cy), _ = min_enclosing_circle(np.column_stack((xs, ys)))
                    if first_center is None:
                        first_center = (cx, cy)
                    override = (
                        float(np.clip(first_center[0] + points_diff[fi][0], 0, w)),
                        float(np.clip(first_center[1] + points_diff[fi][1], 0, h)),
                    )
                circle[fi, oi] = sphere_gaussian_mask(
                    m[..., None].astype(bool), center_override=override
                )
        return dict(
            prompt=sample["caption"],
            background_caption=sample["background_caption"],
            pixel_values=sample["pixel_values"],
            intrinsics=sample["intrinsics"],
            camera_info=sample["camera_info"],
            camera_rt=sample["camera_rt"],
            obj_info=sample["obj_info"],
            obj_masks=raw,
            circle_masks=circle,
            frame_list=sample["frame_list"],
            img_paths=sample["img_paths"],
            seen_ids_per_frame=sample["seen_ids_per_frame"],
            scene_type=sample["scene_type"],
            static_type=sample["static_type"],
        )

    def create_validation_samples(self, num: int, points_diff=None) -> list[dict]:
        return [self.create_validation_sample(points_diff=points_diff) for _ in range(num)]

    @staticmethod
    def collate_fn(samples: list[dict]) -> dict:
        """Dense numpy batch (the reference's ragged lists are already padded
        per-sample; dataset.py:5532-5568)."""
        stack = lambda key: np.stack([s[key] for s in samples])
        return {
            "video_paths": [s["video_path"] for s in samples],
            "pixel_values": stack("pixel_values"),
            "captions": [s["caption"] for s in samples],
            "background_captions": [s["background_caption"] for s in samples],
            "camera_rt": stack("camera_rt"),
            "intrinsics": stack("intrinsics"),
            "obj_union_mask": stack("obj_union_mask"),
            "obj_info": stack("obj_info"),
            "obj_masks": stack("obj_masks"),
            "flip_flag": stack("flip_flag"),
            "frame_lists": [s["frame_list"] for s in samples],
        }


class UnrealTrajLoraDataset(UnrealTrajVideoDataset):
    """Stage-1 image dataset: a random single frame per clip
    (synfmc_tpu/data/dataset.py:775-815, the reference's fmc/data/
    dataset.py:979-2213).  A clip without a caption is rejected (the base
    class's ``__getitem__`` resamples), and ``use_flip`` flips the pixels
    alone: a single frame has no pose to adjust."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("is_image", True)
        super().__init__(*args, **kwargs)

    def get_batch(self, idx: int) -> Optional[dict]:
        folder = self.dataset[idx]["clip_path"]
        files = sorted(
            os.path.join(folder, f) for f in os.listdir(folder)
            if os.path.isfile(os.path.join(folder, f)) and f.endswith(".png") and "-" not in f
        )[:-1]
        if not files:
            return None
        path = self.rng.choice(files)
        t = int(os.path.basename(path).split("_")[1].split(".")[0])
        caption, background, _ = self.get_text_prompt_and_mask_list(idx, [t])
        if caption == "":
            return None
        pixels = ((self._load_clip([path])[0] - 0.5) / 0.5).astype(np.float32)
        if self.use_flip and self.rng.random() < 0.5:
            pixels = pixels[:, ::-1].copy()
        return dict(video_path=path, pixel_values=pixels, caption=caption,
                    background_caption=background)

    @staticmethod
    def collate_fn(samples: list[dict]) -> dict:
        return {
            "pixel_values": np.stack([s["pixel_values"] for s in samples]),
            "captions": [s["caption"] for s in samples],
            "background_captions": [s["background_caption"] for s in samples],
        }
