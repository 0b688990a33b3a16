"""A circular sensor path: frame k at angle 2 pi laps k / F on a circle of
`radius_m` about `center_m` at `height_m`, the sensor level and facing
along the tangent (counter-clockwise) when `face_tangent`, turned a
further `yaw_step_deg` a frame.  `laps` 0 holds the sensor at the
circle's start."""
from __future__ import annotations

import math

import numpy as np


def poses(path: dict):
    """(rots [F, 3, 3] sensor-to-world, trans [F, 3]) float32."""
    F = int(path["frames"])
    cx, cy = path["center_m"]
    r = float(path["radius_m"])
    rots, trans = [], []
    for k in range(F):
        th = 2 * math.pi * path["laps"] * k / F
        yaw = (th + math.pi / 2 if path["face_tangent"] else 0.0) \
            + math.radians(path["yaw_step_deg"] * k)
        c, s = math.cos(yaw), math.sin(yaw)
        rots.append([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        trans.append([cx + r * math.cos(th), cy + r * math.sin(th), path["height_m"]])
    return np.asarray(rots, np.float32), np.asarray(trans, np.float32)
