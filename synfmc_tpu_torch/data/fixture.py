"""Synthetic miniature SynFMC dataset generator (the port's copy of
synfmc_tpu/data/fixture.py, writing PNGs with ``data/image.py:write_png``).

Creates the exact on-disk layout the reference datasets read
(SURVEY.md §2.4) so the data pipeline is testable without the real
(external) SynFMC release: PNG frame folders, per-frame mask folders,
annotation JSONs, trajectory CSVs, and HDRI/asset metadata JSONs.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np

from synfmc_tpu_torch.data.image import write_png


def build_synthetic_dataset(
    root: str,
    num_seqs: int = 2,
    num_objects: int = 2,
    num_frames: int = 48,
    height: int = 64,
    width: int = 96,
    ori_fps: int = 16,
    multi: bool = False,
    seed: int = 0,
) -> dict:
    """Build a tiny dataset under ``root``; returns the dataset kwargs."""
    rng = np.random.default_rng(seed)
    suffix = "_multi" if multi else ""
    static_type = "dynamic"
    data_dir = os.path.join(root, "data", f"Rendered_Traj_Results{suffix}", static_type)
    label_dir = os.path.join(root, "labels", f"Rendered_Traj_Results{suffix}", static_type)
    mask_dir = os.path.join(root, "masks", f"Rendered_Traj_Results{suffix}", static_type)
    csv_dir = os.path.join(root, "csv")
    for d in (data_dir, label_dir, mask_dir, csv_dir):
        os.makedirs(d, exist_ok=True)

    asset_ids = [f"asset{k}" for k in range(num_objects)]
    hdri_json = {"h0": {"descriptions": ["a lush green forest", "an open meadow"]}}
    asset_json = {
        aid: {
            "description": f"a {name} character",
            "animation": {"walk": {"description": "walk"}, "idle": {"description": ""}},
        }
        for aid, name in zip(asset_ids, ["red robot", "blue dragon", "green gnome", "yellow bird"])
    }
    hdri_path = os.path.join(root, "hdri.json")
    asset_path = os.path.join(root, "assets.json")
    with open(hdri_path, "w") as f:
        json.dump(hdri_json, f)
    with open(asset_path, "w") as f:
        json.dump(asset_json, f)

    # trajectory CSVs — all four are opened by _get_csv_meta_data_map
    for st in ("static", "dynamic"):
        for sx in ("", "_multi"):
            path = os.path.join(csv_dir, f"traj_{st}{sx}.csv")
            rows = []
            if st == static_type and sx == suffix:
                for i in range(num_seqs):
                    half = num_frames // 2
                    rows.append(
                        {
                            "Seq_ID": str(i),
                            "Type": "Group",
                            "Comment": f"scene_type=ground;hdri=h0;tgt_obj_id_list=[0, 0]",
                            "Time_Range_List": f"[[0, {half}], [{half}, {num_frames}]]",
                        }
                    )
                    for k in range(num_objects):
                        rows.append(
                            {
                                "Seq_ID": str(i),
                                "Type": "Object",
                                "Comment": (
                                    f"obj_id={asset_ids[k]};"
                                    "animation_name_list=['walk', 'idle'];"
                                    "action_type_list=['move', 'idle']"
                                ),
                                "Time_Range_List": f"[[0, {half}], [{half}, {num_frames}]]",
                            }
                        )
            with open(path, "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=["Seq_ID", "Type", "Comment", "Time_Range_List"])
                writer.writeheader()
                writer.writerows(rows)

    for i in range(num_seqs):
        clip_dir = os.path.join(data_dir, str(i))
        os.makedirs(clip_dir, exist_ok=True)
        # camera entry: [x, y, z, e_roll, e_pitch, e_yaw, fx, fy, pad]
        # ([:3]=xyz, [3:6]=euler, [-3:-1]=fx,fy — dataset.py:5427-5457)
        cam_entries, obj_entries = [], {str(k): [] for k in range(num_objects)}
        for t in range(num_frames + 1):
            cam_entries.append(
                [
                    float(100 * np.cos(t / 10)), float(100 * np.sin(t / 10)), 50.0,
                    0.0, float(5 * np.sin(t / 8)), float(t * 2.0),
                    float(width), float(height), 0.0,
                ]
            )
            for k in range(num_objects):
                # object entry: [pad, pad, pad, e1, e2, e3, x, y, z]
                obj_entries[str(k)].append(
                    [0.0, 0.0, 0.0, 0.0, 0.0, float(t * 3.0 + k * 30),
                     float(20 * t / num_frames + 40 * k), float(10 * k), 0.0]
                )
        with open(os.path.join(label_dir, f"{i}.json"), "w") as f:
            json.dump({"camera": cam_entries, "objects": obj_entries}, f)

        # frames (+1 extra: the loader drops the last sorted file) and masks
        for t in range(num_frames + 1):
            img = rng.integers(0, 255, (height, width, 3), dtype=np.uint8)
            write_png(os.path.join(clip_dir, f"{i}_{t:04d}.png"), img)

            frame_mask_dir = os.path.join(mask_dir, str(i), str(t))
            os.makedirs(frame_mask_dir, exist_ok=True)
            total = np.zeros((height, width), np.uint8)
            for k in range(num_objects):
                m = np.zeros((height, width), np.uint8)
                cx = int((10 + 20 * t / num_frames + 25 * k) % (width - 16)) + 8
                cy = int(height * (0.3 + 0.3 * k)) % (height - 16) + 8
                m[cy - 7 : cy + 7, cx - 7 : cx + 7] = 255
                total |= m
                write_png(os.path.join(frame_mask_dir, f"{k}.png"), m)
            write_png(os.path.join(frame_mask_dir, "total.png"), total)

    return dict(
        data_root=os.path.join(root, "data"),
        lable_root=os.path.join(root, "labels"),
        mask_root=os.path.join(root, "masks"),
        seq_csv_root=csv_dir,
        hdri_json_file_path=hdri_path,
        asset_json_file_path=asset_path,
        **(
            {"multi_dynamic_num": num_seqs}
            if multi
            else {"single_dynamic_num": num_seqs}
        ),
        ori_fps=ori_fps,
        time_duration=num_frames // ori_fps,
    )
