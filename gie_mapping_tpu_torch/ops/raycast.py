"""Projective point-cloud sensor model (endpoint scatter, min-depth
panorama, per-voxel carve).

Counterpart of gie_mapping_tpu/ops/raycast.py::pointcloud_project (the
projective mode; the exact DDA mode is not ported yet): two kernels of
ops/kernels/carve.py, `panorama` over the points and `carve` over the
window's voxels.
"""
from __future__ import annotations

import math

from .kernels.carve import carve, panorama


def panorama_bins(local_size) -> tuple[int, int]:
    """Smallest power-of-two (theta, phi) binning that still resolves one
    voxel at the maximum ray length (0.707*X voxels)."""
    need = 2 * math.pi * 0.707 * local_size[0]
    n_theta = 1 << max(7, math.ceil(math.log2(need)))
    return min(n_theta, 2048), min(n_theta // 2, 1024)


def pointcloud_project(points, valid, origin, pvt, *, local_size, voxel_width,
                       ogm_min_h, ogm_max_h, for_motion_planner: bool,
                       robot_r2_grids: int, n_theta: int = 512,
                       n_phi: int = 256):
    """Dense projective point-cloud OGM update.

    points float32 [N, 3] WORLD frame endpoints; valid bool [N]; origin (3,)
    sensor origin and pvt (3,) window pivot as host values.  Returns
    (inst_type int8, ray_count int32) [X, Y, Z]."""
    local_size = tuple(int(s) for s in local_size)
    depth, cnt, ep = panorama(points, valid, origin, pvt, local_size=local_size,
                              voxel_width=voxel_width, ogm_min_h=ogm_min_h,
                              ogm_max_h=ogm_max_h, n_theta=n_theta, n_phi=n_phi)
    return carve(depth, cnt, ep, pvt, origin, local_size=local_size,
                 voxel_width=voxel_width, n_theta=n_theta, n_phi=n_phi,
                 for_motion_planner=for_motion_planner,
                 robot_r2_grids=robot_r2_grids)
