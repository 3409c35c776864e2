"""Relative-pose constructors (the port's copy of synfmc_tpu/geometry/relative.py).

Behavioral parity with reference fmc/data/utils.py:148-200, reformulated as
vectorized numpy (the reference loops over frames with per-frame
``np.dot``).  Conventions (matching the reference math exactly):

Given per-frame camera extrinsics ``RT_t = [R_t | T_t]`` (3x4, world-to-?? —
the reference treats them as given) the relative-to-first-frame matrix is

    R'_t = R_t^T @ R_0
    T'_t = (-R_t^T @ T_t + R_t^T @ T_0) / scale_T

with frame 0 forced to identity (utils.py:161).  Output is flattened to 12-d
per frame.

Camera-relative object poses (utils.py:185-200): given camera ``RT1`` (3x4)
and per-frame object poses ``RT2`` (F,3,4):

    R'_t = R2_t^T @ R1        (NOTE: reference transposes the *object*
    T'_t = (-R2_t^T @ T2_t + R2_t^T @ T1) / scale_T    rotation, utils.py:193-194)

``absolute_from_relative_cams`` inverts the relative construction given the
first absolute camera (utils.py:167-183).
"""

from __future__ import annotations

import numpy as np


def relative_cams_to_first(cam_rts: np.ndarray, scale_t: float = 1.0) -> np.ndarray:
    """Relative camera matrices w.r.t. frame 0 (reference utils.py:148-163).

    Args:
      cam_rts: (F, 3, 4) or (F, 4, 4) camera matrices (rows beyond 3 ignored).
      scale_t: translation rescale factor (1200 for cameras, cam.yaml:32).

    Returns:
      (F, 12) float array; frame 0 is the flattened 3x4 identity.
    """
    cam_rts = np.asarray(cam_rts, dtype=np.float64)[:, :3, :]
    r = cam_rts[:, :, :3]  # (F,3,3)
    t = cam_rts[:, :, 3]  # (F,3)
    r0, t0 = r[0], t[0]
    r_t = np.swapaxes(r, 1, 2)  # R_t^T
    rel_t = (np.einsum("fij,fj->fi", r_t, -t) + r_t @ t0) / scale_t
    rel_r = r_t @ r0
    out = np.concatenate([rel_r, rel_t[:, :, None]], axis=-1)
    out[0] = np.eye(3, 4)
    return out.reshape(len(cam_rts), 12).astype(np.float32)


def relative_obj_to_cam(cam_rt: np.ndarray, obj_rts: np.ndarray, scale_t: float = 1.0) -> np.ndarray:
    """Camera-relative object poses (reference utils.py:185-200).

    Args:
      cam_rt: (3, 4) or (4, 4) reference camera matrix (the frame's camera).
      obj_rts: (F, 3, 4) or (F, 4, 4) per-frame object pose matrices.
      scale_t: translation rescale (1000 for objects, cam.yaml:33).

    Returns:
      (F, 12) float array.
    """
    cam_rt = np.asarray(cam_rt, dtype=np.float64)[:3, :]
    obj = np.asarray(obj_rts, dtype=np.float64)[:, :3, :]
    r1, t1 = cam_rt[:, :3], cam_rt[:, 3]
    r2 = obj[:, :, :3]
    t2 = obj[:, :, 3]
    r2_t = np.swapaxes(r2, 1, 2)
    rel_t = (np.einsum("fij,fj->fi", r2_t, -t2) + r2_t @ t1) / scale_t
    rel_r = r2_t @ r1
    out = np.concatenate([rel_r, rel_t[:, :, None]], axis=-1)
    return out.reshape(len(obj), 12).astype(np.float32)


def absolute_from_relative_cams(
    first_cam: np.ndarray, rel_cams: np.ndarray, scale_t: float = 1.0
) -> np.ndarray:
    """Absolute cameras from relative ones (reference utils.py:167-183).

    Args:
      first_cam: (4, 4) absolute first-frame camera.
      rel_cams: (F, 3, 4) relative matrices as from relative_cams_to_first
        (already divided by scale_t).
      scale_t: the same rescale factor used to build rel_cams.

    Returns:
      list-equivalent (F, 3, 4) array of absolute cameras; frame 0 is
      first_cam[:3].
    """
    first_cam = np.asarray(first_cam, dtype=np.float64)
    rel_cams = np.asarray(rel_cams, dtype=np.float64).reshape(-1, 3, 4)
    out = [np.copy(first_cam[:3])]
    for rel in rel_cams[1:]:
        m = np.eye(4)
        m[:3, :] = rel
        m[:3, 3] *= scale_t
        out.append((first_cam @ np.linalg.inv(m))[:3])
    return np.stack(out).astype(np.float32)
