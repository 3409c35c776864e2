"""Camera label files (the counterpart of synfmc_tpu/evaluation/metrics.py's
``parse_camera_txt``, :48).

Layout (synfmc_tpu/utils/video.py:save_camera_info_txt): a first line with
the frame count F, then per frame ``idx fx fy cx cy 0 0`` and the row-major
3x4 [R|t].
"""

from __future__ import annotations

import numpy as np


def parse_camera_text(text: str) -> tuple[np.ndarray, np.ndarray]:
    """A camera label file's contents -> (intrinsics (F, 4), RT (F, 3, 4))."""
    lines = text.strip().splitlines()
    n = int(lines[0])
    intrinsics, rts = [], []
    for line in lines[1:n + 1]:
        vals = [float(v) for v in line.split()]
        intrinsics.append(vals[1:5])
        rts.append(np.asarray(vals[7:19]).reshape(3, 4))
    return np.asarray(intrinsics), np.stack(rts)


def parse_camera_txt(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse a camera label file -> (intrinsics (F, 4), RT (F, 3, 4))."""
    with open(path) as fh:
        return parse_camera_text(fh.read())
