"""Quality metrics: PSNR and RotErr/TransErr camera-pose accuracy, the port
of synfmc_tpu/evaluation/metrics.py.

The reference's evaluation hook is the per-sample camera-pose txt dumps
written during validation (train_cam_ctrl.py:41-74, 779); RotErr/TransErr are
computed downstream (paper protocol: geodesic rotation error in degrees and
translation L2 over the trajectory, relative to frame 0).  Everything is
float64 numpy on the host, as in the JAX package.

Two camera file layouts (synfmc_tpu/utils/video.py, and this package's
utils/video.py, write both):
- ``save_camera_info_txt``: a first line with the frame count F, then per
  frame ``idx fx fy cx cy 0 0`` and the row-major 3x4 [R|t];
- ``save_camera_label_txt``: a header line, then per frame seven placeholder
  fields and the row-major 3x4 camera matrix.
"""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB (+inf for identical inputs)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_val**2 / mse))


def rot_err_deg(r_pred: np.ndarray, r_gt: np.ndarray) -> np.ndarray:
    """Geodesic rotation error in degrees, per frame; (..., 3, 3) rotations."""
    r_rel = np.einsum("...ij,...kj->...ik", r_pred, r_gt)  # R_pred @ R_gt^T
    trace = np.trace(r_rel, axis1=-2, axis2=-1)
    cos = np.clip((trace - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(cos))


def trans_err(t_pred: np.ndarray, t_gt: np.ndarray, normalize: bool = True) -> np.ndarray:
    """Translation L2 error per frame; optionally scale-normalized by the
    ground-truth trajectory extent (CameraCtrl protocol)."""
    t_pred = np.asarray(t_pred, np.float64)
    t_gt = np.asarray(t_gt, np.float64)
    if normalize:
        scale = np.linalg.norm(t_gt, axis=-1).max()
        if scale > 0:
            t_pred = t_pred / scale
            t_gt = t_gt / scale
    return np.linalg.norm(t_pred - t_gt, axis=-1)


def parse_camera_text(text: str) -> tuple[np.ndarray, np.ndarray]:
    """A camera info file's contents -> (intrinsics (F, 4), RT (F, 3, 4))."""
    lines = text.strip().splitlines()
    n = int(lines[0])
    intrinsics, rts = [], []
    for line in lines[1:n + 1]:
        vals = [float(v) for v in line.split()]
        intrinsics.append(vals[1:5])
        rts.append(np.asarray(vals[7:19]).reshape(3, 4))
    return np.asarray(intrinsics), np.stack(rts)


def parse_camera_txt(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse a camera info file -> (intrinsics (F, 4), RT (F, 3, 4))."""
    with open(path) as fh:
        return parse_camera_text(fh.read())


def _camera_errors(rt_pred: np.ndarray, rt_gt: np.ndarray) -> dict:
    rot = rot_err_deg(rt_pred[:, :, :3], rt_gt[:, :, :3])
    trans = trans_err(rt_pred[:, :, 3], rt_gt[:, :, 3])
    return {
        "rot_err_deg_mean": float(rot.mean()),
        "rot_err_deg": rot,
        "trans_err_mean": float(trans.mean()),
        "trans_err": trans,
    }


def camera_errors_from_txt(pred_path: str, gt_path: str) -> dict:
    """RotErr/TransErr between two camera info files."""
    return _camera_errors(parse_camera_txt(pred_path)[1], parse_camera_txt(gt_path)[1])


def parse_camera_label_txt(path: str) -> np.ndarray:
    """Parse a camera label file (reference train_cam_ctrl.py:50-74) -> RT (F, 3, 4)."""
    with open(path) as f:
        lines = f.read().strip().splitlines()[1:]
    rts = [np.asarray([float(v) for v in ln.split()[7:19]]).reshape(3, 4)
           for ln in lines if ln.strip()]
    return np.stack(rts)


def camera_errors_from_label_txt(pred_path: str, gt_path: str) -> dict:
    """RotErr/TransErr between the computed and GT camera label files that
    validation writes (train_cam_ctrl.py:779)."""
    return _camera_errors(parse_camera_label_txt(pred_path), parse_camera_label_txt(gt_path))
