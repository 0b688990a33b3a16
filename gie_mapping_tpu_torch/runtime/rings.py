"""Multi-ring LiDAR point cloud -> range-ring image, on the host.

A copy of gie_mapping_tpu/runtime/rings.py for the PyTorch port, without
its numpy fallback: each point with a ring index is binned by azimuth into
a [ring_num, scan_num] image of horizontal ranges (the reference's
vlp16_map_maker.cpp:73-148), in the native library.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .native import get_lib, ptr


def cloud_to_rings(points, rings, ring_num=16, scan_num=360,
                   theta_min=-np.pi, theta_inc=None):
    """points [N, 3] float32 (sensor frame), rings [N] int ring indices
    (out-of-range ids are dropped).

    Returns (rings_img [ring_num, scan_num] float32 horizontal ranges with
    NaN in empty bins, theta_min, theta_inc); the library bins in float32,
    and the two angles come back as given (Python floats by default)."""
    if theta_inc is None:
        theta_inc = 2 * np.pi / scan_num
    pts = np.ascontiguousarray(points, np.float32)
    rg = np.ascontiguousarray(rings, np.int32)
    img = np.empty((ring_num, scan_num), np.float32)
    get_lib().gie_cloud_to_rings(
        ptr(pts), ptr(rg, ctypes.c_int32), len(pts), int(ring_num),
        int(scan_num), float(theta_min), float(theta_inc), ptr(img))
    return img, theta_min, theta_inc
