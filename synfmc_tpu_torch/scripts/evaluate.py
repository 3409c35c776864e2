"""Evaluation command line: camera-pose accuracy (RotErr/TransErr), frame
PSNR and FID/FVD.

The port of scripts/evaluate.py.  It reads the files the trainers'
validation writes under ``samples/{step}/`` (computed and GT camera label
txts, GIFs):

    # all label-txt pairs under a validation step dir
    python -m synfmc_tpu_torch.scripts.evaluate --samples-dir output/run/samples/200

    # one explicit pair
    python -m synfmc_tpu_torch.scripts.evaluate --pred cam_label_compute_0.txt \\
        --gt cam_label_gt_0.txt

    # per-frame PSNR between two GIFs
    python -m synfmc_tpu_torch.scripts.evaluate --video-a ours.gif --video-b reference.gif

    # FID (FVD with --fvd) of two GIFs or GIF directories through a TorchScript extractor
    python -m synfmc_tpu_torch.scripts.evaluate --video-a a/ --video-b b/ --extractor inception.pt

GIFs are read by ``utils/video.py:read_gif``; an ``.mp4`` raises (no MP4
decoder in this package).  The extractor runs on the card unless ``--cpu``
is given.  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re

import numpy as np


def eval_label_pair(pred: str, gt: str) -> dict:
    from synfmc_tpu_torch.evaluation.metrics import camera_errors_from_label_txt

    errs = camera_errors_from_label_txt(pred, gt)
    return {k: (np.asarray(v).round(6).tolist() if isinstance(v, np.ndarray) else v)
            for k, v in errs.items()}


def eval_samples_dir(d: str) -> dict:
    out = {}
    for pred in sorted(glob.glob(os.path.join(d, "cam_label_compute_*.txt"))):
        m = re.search(r"cam_label_compute_(\d+)\.txt$", pred)
        gt = os.path.join(d, f"cam_label_gt_{m.group(1)}.txt")
        if os.path.exists(gt):
            out[f"sample_{m.group(1)}"] = eval_label_pair(pred, gt)
    if not out:
        return {"error": f"no cam_label_compute_*/cam_label_gt_* pairs in {d}"}
    rot = [v["rot_err_deg_mean"] for v in out.values()]
    trans = [v["trans_err_mean"] for v in out.values()]
    out["aggregate"] = {
        "rot_err_deg_mean": float(np.mean(rot)),
        "trans_err_mean": float(np.mean(trans)),
        "num_samples": len(rot),
    }
    return out


def load_frames(path: str) -> np.ndarray:
    """(T, H, W, 3) float32 in [0, 1] from a GIF."""
    from synfmc_tpu_torch.utils.video import read_gif

    if path.lower().endswith(".mp4"):
        raise ValueError(f"{path}: MP4 needs an ffmpeg-based decoder (imageio-ffmpeg), which "
                         "this package does not use; convert the video to GIF")
    return read_gif(path).astype(np.float32) / 255.0


def eval_videos(path_a: str, path_b: str) -> dict:
    from synfmc_tpu_torch.evaluation.metrics import psnr

    a, b = load_frames(path_a), load_frames(path_b)
    n = min(len(a), len(b))
    if a.shape[1:] != b.shape[1:]:
        return {"error": f"frame shapes differ: {a.shape[1:]} vs {b.shape[1:]}"}
    # psnr() is +inf for identical frames, which strict JSON parsers reject: cap it
    per_frame = [min(psnr(a[i], b[i]), 99.0) for i in range(n)]
    return {
        "psnr_per_frame": [round(p, 3) for p in per_frame],
        "psnr_mean": float(np.mean(per_frame)),
        "frames_compared": n,
    }


def video_files(path: str) -> list[str]:
    """A video file, or a directory's GIFs and MP4s (sorted)."""
    if os.path.isdir(path):
        files = sorted(f for ext in ("*.gif", "*.mp4") for f in glob.glob(os.path.join(path, ext)))
        if not files:
            raise FileNotFoundError(f"no .gif/.mp4 files in {path}")
        return files
    return [path]


def eval_frechet_extracted(path_a: str, path_b: str, extractor_path: str,
                           video_level: bool = False, device=None) -> dict:
    """Decode videos -> TorchScript feature extractor -> Fréchet distance.

    - FID (default): every frame is a sample; the extractor gets (N, 3, H, W)
      float in [0, 1] and returns (N, D) (InceptionV3 pool3: D = 2048).
    - FVD (``video_level``): every video is a sample; the extractor gets
      (1, 3, T, H, W) a clip and returns (1, D) (I3D logits: D = 400); needs
      two videos or more a side (pass directories).
    """
    from synfmc_tpu_torch.evaluation.fid import (
        extract_features,
        fid_from_features,
        load_torchscript_extractor,
    )

    extractor = load_torchscript_extractor(extractor_path, device)

    def features(path):
        batches = []
        for f in video_files(path):
            frames = load_frames(f)
            if video_level:
                batches.append(frames.transpose(3, 0, 1, 2)[None])  # (1, 3, T, H, W)
            else:
                batches.append(frames.transpose(0, 3, 1, 2))  # (T, 3, H, W)
        return extract_features(batches, extractor)

    fa, fb = features(path_a), features(path_b)
    return {
        "frechet_distance": fid_from_features(fa, fb),
        "protocol": "fvd" if video_level else "fid",
        "n_a": int(len(fa)),
        "n_b": int(len(fb)),
        "dim": int(fa.shape[-1]),
        "extractor": os.path.basename(extractor_path),
    }


def load_features(path: str) -> np.ndarray:
    data = np.load(path)
    if hasattr(data, "files"):  # npz: 'features' or the sole array
        data = data["features" if "features" in data.files else data.files[0]]
    return np.asarray(data)


def eval_frechet(path_a: str, path_b: str) -> dict:
    """FID/FVD from precomputed (N, D) feature arrays (.npy, or .npz['features'])."""
    from synfmc_tpu_torch.evaluation.fid import fid_from_features

    a, b = load_features(path_a), load_features(path_b)
    return {
        "frechet_distance": fid_from_features(a, b),
        "n_a": int(len(a)),
        "n_b": int(len(b)),
        "dim": int(a.shape[-1]),
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m synfmc_tpu_torch.scripts.evaluate")
    p.add_argument("--samples-dir", default=None, help="a samples/{step} validation dir")
    p.add_argument("--pred", default=None, help="computed camera label txt")
    p.add_argument("--gt", default=None, help="ground-truth camera label txt")
    p.add_argument("--video-a", default=None, help="a GIF, or a directory of GIFs")
    p.add_argument("--video-b", default=None)
    p.add_argument("--features-a", default=None,
                   help="feature .npy/.npz for FID/FVD (with --features-b)")
    p.add_argument("--features-b", default=None)
    p.add_argument("--extractor", default=None,
                   help="TorchScript feature extractor (.pt): with --video-a/--video-b (files "
                        "or GIF dirs) runs the full FID/FVD path -- InceptionV3 pool3 for FID, "
                        "I3D for FVD")
    p.add_argument("--fvd", action="store_true",
                   help="video-level (FVD) protocol: one feature per clip, extractor input "
                        "(1, 3, T, H, W)")
    p.add_argument("--cpu", action="store_true", help="run the extractor on the CPU")
    return p, p.parse_args(argv)


def evaluate(args) -> dict:
    result = {}
    if args.samples_dir:
        result["camera"] = eval_samples_dir(args.samples_dir)
    if args.pred and args.gt:
        result["camera_pair"] = eval_label_pair(args.pred, args.gt)
    if args.video_a and args.video_b:
        if args.extractor:
            result["frechet"] = eval_frechet_extracted(args.video_a, args.video_b,
                                                       args.extractor, video_level=args.fvd,
                                                       device="cpu" if args.cpu else None)
        else:
            result["video"] = eval_videos(args.video_a, args.video_b)
    if args.features_a and args.features_b:
        result["frechet"] = eval_frechet(args.features_a, args.features_b)
    return result


def main(argv=None) -> int:
    parser, args = parse_args(argv)
    result = evaluate(args)
    if not result:
        parser.error("nothing to evaluate: pass --samples-dir, --pred/--gt, "
                     "--video-a/--video-b, or --features-a/--features-b")
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
