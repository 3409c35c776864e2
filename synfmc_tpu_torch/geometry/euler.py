"""Unreal-Engine Euler-angle conventions used by the SynFMC annotations.

Behavioral parity with the reference (fmc/data/utils.py:54-71), which defines
two conventions:

- ``euler_to_matrix``    — reference ``transform_euler_to_matrix``
  (utils.py:54-61).  NOTE: entry [2][1] of the reference matrix reads
  ``-cos(x)sin(y)cos(z) - sin(x)cos(z)`` which is *not* a pure rotation
  (both terms carry cos(z); a proper decomposition would have sin(z) in the
  second term).  The quirk is preserved verbatim because dataset annotations
  were generated with it.
- ``euler_to_matrix_v2`` — reference ``transform_euler_to_matrix_v2``
  (utils.py:64-71).  Decomposes exactly as Rz(yaw) @ Ry(-pitch) @ Rx(-roll);
  we implement it through that composition.

Both accept degrees and operate on numpy arrays of any batch shape (scalars
broadcast).  The port's copy of synfmc_tpu/geometry/euler.py, numpy only.
"""

from __future__ import annotations

import numpy as np


def to_radian(degree):
    """Degrees -> radians (reference utils.py:49-50)."""
    return degree * (np.pi / 180.0)


def euler_to_matrix(roll, pitch, yaw):
    """Reference ``transform_euler_to_matrix`` (utils.py:54-61), batched.

    Returns rotation matrices of shape ``(*batch, 3, 3)``.
    """
    x, y, z = to_radian(np.asarray(roll)), to_radian(np.asarray(pitch)), to_radian(np.asarray(yaw))
    x, y, z = np.broadcast_arrays(x, y, z)
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    rows = [
        np.stack([cy * cz, -cy * sz, -sy], axis=-1),
        np.stack([sx * sy * cz + cx * sz, -sx * sy * sz + cx * cz, sx * cy], axis=-1),
        # [2][1] preserves the reference's cos(z) factor (utils.py:60).
        np.stack([cx * sy * cz - sx * sz, -cx * sy * cz - sx * cz, cx * cy], axis=-1),
    ]
    return np.stack(rows, axis=-2)


def euler_to_matrix_v2(roll, pitch, yaw):
    """Reference ``transform_euler_to_matrix_v2`` (utils.py:64-71), batched.

    Equals ``Rz(yaw) @ Ry(-pitch) @ Rx(-roll)`` in radians; returns
    ``(*batch, 3, 3)``.
    """
    x, y, z = to_radian(np.asarray(roll)), to_radian(np.asarray(pitch)), to_radian(np.asarray(yaw))
    x, y, z = np.broadcast_arrays(x, y, z)
    one = np.ones_like(x)
    zero = np.zeros_like(x)

    def rot(c, s, axis):
        if axis == 0:  # Rx
            rows = [[one, zero, zero], [zero, c, -s], [zero, s, c]]
        elif axis == 1:  # Ry
            rows = [[c, zero, s], [zero, one, zero], [-s, zero, c]]
        else:  # Rz
            rows = [[c, -s, zero], [s, c, zero], [zero, zero, one]]
        return np.stack([np.stack(r, axis=-1) for r in rows], axis=-2)

    rz = rot(np.cos(z), np.sin(z), 2)
    ry = rot(np.cos(-y), np.sin(-y), 1)
    rx = rot(np.cos(-x), np.sin(-x), 0)
    return rz @ ry @ rx
