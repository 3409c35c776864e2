"""SynFMC dataset pre-flight validator, the port of scripts/validate_dataset.py.

A 50k-step run that dies hours in on a malformed sequence -- or silently
skips half its data through the rejection-resampling loop -- is the most
expensive failure mode of the reference data layout (PNG folders, per-frame
mask dirs, annotation JSONs, trajectory CSVs, all cross-referenced by
convention).  This tool checks every cross-reference up front through the
port's data layer (data/dataset.py, data/captions.py, data/image.py),
without a device:

    python -m synfmc_tpu_torch.scripts.validate_dataset --config configs/cam.yaml [--deep]

Checks, per configured sequence (the dataset's index rules):
  * clip dir exists; frame files named {seq}_{frame:04d}.png, contiguous
    0..N (the loader drops the last file: needs ori_fps*time_duration + 1);
  * annotation JSON parses; camera entries cover every frame with >= 9
    numbers each (pose + sensor intrinsics);
  * CSV row exists for the sequence; camera Comment parses and carries
    scene_type / hdri / tgt_obj_id_list; Time_Range_List merges cleanly and
    stays inside the frame range; at least one mergeable clip segment is
    long enough for sample_n_frames (else __getitem__ rejection-loops);
  * per-object CSV rows: Comment obj_id resolves into the asset JSON with
    the animation names listed in animation_name_list; object count matches
    the annotation JSON's objects;
  * hdri key resolves to a nonempty descriptions list (else captions
    silently degrade);
  * per-frame mask dir has total.png (+ {k}.png per object for multi);
  * PNG decodability + consistent dimensions (first/middle/last frame per
    sequence; every frame with --deep) through data/image.py's reader.

Prints a WARN line per warning, an ERROR line per error and a summary line;
exit 0 = clean, 1 = errors.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


class Report:
    def __init__(self):
        self.errors: list[str] = []
        self.warnings: list[str] = []
        self.sequences = 0
        self.frames_checked = 0

    def err(self, seq: str, msg: str) -> None:
        self.errors.append(f"[{seq}] {msg}")

    def warn(self, seq: str, msg: str) -> None:
        self.warnings.append(f"[{seq}] {msg}")


def _check_pngs(report: Report, seq: str, paths: list[str]) -> None:
    from synfmc_tpu_torch.data.image import imread

    dims = None
    for p in paths:
        try:
            a = imread(p)
        except Exception as e:
            report.err(seq, f"undecodable PNG {p}: {e}")
            continue
        report.frames_checked += 1
        if a.ndim >= 2:
            if dims is None:
                dims = a.shape[:2]
            elif a.shape[:2] != dims:
                report.err(seq, f"inconsistent frame size {a.shape[:2]} vs {dims}: {p}")


def _merge_clips(time_ranges, tgt_obj_ids):
    clips, prev = [], None
    for time_range, tgt in zip(time_ranges, tgt_obj_ids):
        if prev is None or tgt != prev:
            clips.append(list(time_range))
        else:
            if clips[-1][-1] != time_range[0]:
                raise ValueError(
                    f"non-contiguous Time_Range_List at {time_range} (prev end {clips[-1][-1]})"
                )
            clips[-1][-1] = time_range[-1]
        prev = tgt
    return clips


def validate(params: dict, deep: bool = False) -> Report:
    """Validate the dataset a config's train_data.params points at."""
    from synfmc_tpu_torch.data.captions import csv_param_to_dict
    from synfmc_tpu_torch.data.dataset import UnrealTrajVideoDataset

    report = Report()
    try:
        ds = UnrealTrajVideoDataset(**params)
    except Exception as e:
        report.err("<init>", f"dataset construction failed: {e}")
        return report

    n_frames_expected = ds.ori_fps * ds.time_duration
    with open(params["asset_json_file_path"]) as f:
        asset_json = json.load(f)
    hdri_json = ds.hdri_json_data

    for idx in range(len(ds)):
        entry = ds.dataset[idx]
        data_type = ds.data_type_list[idx]
        seq_id = ds.seq_id_list[idx]
        seq = f"{data_type}/{seq_id}"
        report.sequences += 1
        is_multi = "multi" in data_type

        # ---- frames on disk ----
        clip = entry["clip_path"]
        if not os.path.isdir(clip):
            report.err(seq, f"missing clip dir {clip}")
            continue
        pngs = sorted(f for f in os.listdir(clip) if f.endswith(".png") and "-" not in f)
        nums = []
        for f_ in pngs:
            try:
                nums.append(int(f_.split("_")[1].split(".")[0]))
            except (IndexError, ValueError):
                report.err(seq, f"frame file not named seq_NNNN.png: {f_}")
        if nums and (min(nums) != 0 or max(nums) != len(nums) - 1):
            report.err(seq, f"frame numbers not contiguous 0..{len(nums)-1} "
                            f"(got {min(nums)}..{max(nums)})")
        if len(nums) < n_frames_expected + 1:
            report.err(seq, f"{len(nums)} frames < ori_fps*time_duration+1 = "
                            f"{n_frames_expected + 1} (loader drops the last file)")

        # ---- annotation JSON ----
        ann_path = entry["annotation_file_path"]
        try:
            with open(ann_path) as f:
                ann = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            report.err(seq, f"annotation unreadable {ann_path}: {e}")
            continue
        cams = ann.get("camera", [])
        if len(cams) < n_frames_expected:
            report.err(seq, f"annotation has {len(cams)} camera entries < {n_frames_expected}")
        elif any(len(c) < 9 for c in cams):
            report.err(seq, "camera entry with < 9 numbers (need pose + sensor dims)")
        ann_objs = ann.get("objects", {})

        # ---- CSV metadata ----
        meta = ds.seq_meta_data_map.get(data_type, {}).get(seq_id)
        if meta is None:
            report.err(seq, f"no CSV Group row (traj_{data_type.split('_')[1]}"
                            f"{'_multi' if is_multi else ''}.csv)")
            continue
        try:
            comment = csv_param_to_dict(meta["camera"]["Comment"])
        except Exception as e:
            report.err(seq, f"camera Comment unparseable: {e}")
            continue
        for key in ("scene_type", "hdri", "tgt_obj_id_list"):
            if key not in comment:
                report.err(seq, f"camera Comment missing {key!r}")
        if "hdri" in comment and not hdri_json.get(comment["hdri"], {}).get("descriptions"):
            report.warn(seq, f"hdri {comment.get('hdri')!r} has no descriptions "
                             f"(background captions degrade)")
        try:
            ranges = eval(meta["camera"]["Time_Range_List"])  # noqa: S307 — local file
            tgt_ids = eval(comment["tgt_obj_id_list"])  # noqa: S307
            clips = _merge_clips(ranges, tgt_ids)
        except Exception as e:
            report.err(seq, f"camera Time_Range_List invalid: {e}")
            clips = []
        if clips:
            lo = min(s for s, _ in clips)
            hi = max(e for _, e in clips)
            if lo < 0 or hi > n_frames_expected:
                report.err(seq, f"Time_Range_List {lo}..{hi} outside 0..{n_frames_expected}")
            if not ds.allow_change_tgt and all(e - s < ds.sample_n_frames for s, e in clips):
                report.err(seq, f"no clip segment >= sample_n_frames={ds.sample_n_frames} "
                                f"(rejection loop would spin forever)")

        # ---- per-object rows vs asset json vs annotation ----
        objs = meta.get("objects", {})
        if len(objs) != len(ann_objs):
            report.err(seq, f"CSV has {len(objs)} object rows, annotation has {len(ann_objs)}")
        for oi, row in objs.items():
            try:
                ocomment = csv_param_to_dict(row["Comment"])
                obj_id = ocomment["obj_id"]
                anims = eval(ocomment["animation_name_list"])  # noqa: S307
                eval(ocomment["action_type_list"])  # noqa: S307
                otr = eval(row["Time_Range_List"])  # noqa: S307
            except Exception as e:
                report.err(seq, f"object {oi} row unparseable: {e}")
                continue
            if len(otr) != len(anims):
                report.err(seq, f"object {oi}: {len(otr)} time ranges vs {len(anims)} animations")
            if obj_id not in asset_json:
                report.err(seq, f"object {oi}: obj_id {obj_id!r} not in asset JSON")
                continue
            known = asset_json[obj_id].get("animation", {})
            for a in anims:
                if a not in known:
                    report.err(seq, f"object {oi}: animation {a!r} not in asset JSON for {obj_id!r}")

        # ---- masks ----
        mask_base = os.path.join(
            ds.mask_root,
            f"Rendered_Traj_Results{'_multi' if is_multi else ''}",
            data_type.split("_")[1], seq_id,
        )
        check_frames = sorted(nums)[:-1] if nums else []
        if not deep and len(check_frames) > 3:
            check_frames = [check_frames[0], check_frames[len(check_frames) // 2], check_frames[-2]]
        mask_paths = []
        for t in check_frames:
            d = os.path.join(mask_base, str(t))
            total = os.path.join(d, "total.png")
            if not os.path.isfile(total):
                report.err(seq, f"missing mask {total}")
                continue
            mask_paths.append(total)
            if is_multi or len(objs) > 1:
                for oi in range(len(objs)):
                    p = os.path.join(d, f"{oi}.png")
                    if not os.path.isfile(p):
                        report.err(seq, f"missing per-object mask {p}")
                    else:
                        mask_paths.append(p)

        # ---- decodability ----
        frame_paths = [os.path.join(clip, f"{seq_id}_{t:04d}.png") for t in check_frames]
        _check_pngs(report, seq, [p for p in frame_paths if os.path.isfile(p)] + mask_paths)

    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m synfmc_tpu_torch.scripts.validate_dataset")
    p.add_argument("--config", required=True, help="stage YAML (train_data.params is read)")
    p.add_argument("--deep", action="store_true",
                   help="decode every frame and check every mask dir (slow)")
    args = p.parse_args(argv)

    from synfmc_tpu_torch.config import get_path, load_config

    config = load_config(args.config)
    params = dict(get_path(config, "train_data.params", {}) or {})
    report = validate(params, deep=args.deep)

    for w in report.warnings:
        print(f"WARN  {w}")
    for e in report.errors:
        print(f"ERROR {e}")
    status = "FAILED" if report.errors else "OK"
    print(f"{status}: {report.sequences} sequences, {report.frames_checked} PNGs decoded, "
          f"{len(report.errors)} errors, {len(report.warnings)} warnings")
    return 1 if report.errors else 0


if __name__ == "__main__":
    sys.exit(main())
