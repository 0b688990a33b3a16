"""External-observer point cloud -> DBSCAN clusters -> AABB obstacle boxes.

A copy of gie_mapping_tpu/runtime/clustering.py for the PyTorch port,
without its numpy fallback (the reference's DBSCAN over the
`forbid_reg_cloud` channel, volumetric_mapper.cpp:391-496): clusters of at
least 4 points, grown through points with 3 neighbours within eps = 0.3 m,
become axis-aligned boxes for the virtual-fence set; the z extent is
clamped to [0.2, 2.6] unless `is_ext_obsv_3D`.
"""
from __future__ import annotations

import numpy as np

from .native import get_lib, ptr

EPS = 0.3
MIN_NBR_PTS = 3
MIN_CLUSTER = 4


def dbscan_aabb(points, eps=EPS, min_pts=MIN_NBR_PTS, min_cluster=MIN_CLUSTER,
                max_boxes=64):
    """Cluster `points` [N, 3] in the native library; returns boxes
    [K, 2, 3] float32 (ll, ur), K <= max_boxes."""
    pts = np.ascontiguousarray(points, np.float32)
    if len(pts) == 0:
        return np.zeros((0, 2, 3), np.float32)
    out = np.zeros((max_boxes, 6), np.float32)
    k = get_lib().gie_dbscan_aabb(ptr(pts), len(pts), float(eps), int(min_pts),
                                  int(min_cluster), ptr(out), int(max_boxes),
                                  None)
    return out[:k].reshape(k, 2, 3)


def cloud_to_fence_boxes(points, is_3d: bool = False):
    """The whole external-observer path: cluster, then clamp z
    (volumetric_mapper.cpp:481-493).  Returns [(ll, ur)] of 3-lists."""
    out = []
    for ll, ur in dbscan_aabb(points):
        min_z = ll[2] if is_3d else 0.2
        max_z = ur[2] if is_3d else 2.6
        out.append(([ll[0], ll[1], min_z], [ur[0], ur[1], max_z]))
    return out
