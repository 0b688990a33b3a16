"""Projective point-cloud sensor model (endpoint scatter, min-depth
panorama, per-voxel carve).

Counterpart of gie_mapping_tpu/ops/raycast.py::pointcloud_project (the
projective mode; the exact DDA mode is not ported yet).  The endpoint
scatter and the panorama build are plain PyTorch reductions (an integer
index_add and a float scatter-min: both order-independent, so
deterministic); the per-voxel lookup and classification is the carve kernel
(ops/kernels/carve.py).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import geometry as geo
from .kernels.carve import (BIG_DEPTH, carve_consts, atan2f_exact, bin_index,
                            carve, hypot2_f32, norm3_f32)


def panorama_bins(local_size) -> tuple[int, int]:
    """Smallest power-of-two (theta, phi) binning that still resolves one
    voxel at the maximum ray length (0.707*X voxels)."""
    need = 2 * math.pi * 0.707 * local_size[0]
    n_theta = 1 << max(7, math.ceil(math.log2(need)))
    return min(n_theta, 2048), min(n_theta // 2, 1024)


def panorama(points, valid, origin, *, n_theta, n_phi, local_size,
             voxel_width):
    """Per (theta, phi) bin: min range and ray count of the valid points.
    points float32 [N, 3] world frame; valid bool [N]; origin (3,) host
    float32.  Returns (depth f32, cnt int32) [n_theta, n_phi]."""
    dev = points.device
    k = carve_consts(n_theta, n_phi, local_size, voxel_width)
    rel = points - torch.as_tensor(np.asarray(origin, np.float32), device=dev)
    r = norm3_f32(rel)
    theta = atan2f_exact(rel[:, 1], rel[:, 0])
    phi = atan2f_exact(rel[:, 2], hypot2_f32(rel[:, 0], rel[:, 1]))
    bt = bin_index(theta, k["pi"], k["theta_scale"], n_theta)
    bp = bin_index(phi, k["half_pi"], k["phi_scale"], n_phi)
    bin_id = torch.where(valid, bt * n_phi + bp, 0).long()
    big = float(np.float32(BIG_DEPTH))
    depth = torch.full((n_theta * n_phi,), big, dtype=torch.float32, device=dev)
    depth.scatter_reduce_(0, bin_id, torch.where(valid, r, big), reduce="amin")
    cnt = torch.zeros(n_theta * n_phi, dtype=torch.int32, device=dev)
    cnt.index_add_(0, bin_id, valid.to(torch.int32))
    return depth.reshape(n_theta, n_phi), cnt.reshape(n_theta, n_phi)


def endpoint_counts(points, valid, pvt, *, local_size, voxel_width, ogm_min_h,
                    ogm_max_h):
    """Registered endpoint hits per window voxel (int32 [X, Y, Z])."""
    X, Y, Z = local_size
    dev = points.device
    loc = geo.pos2coord(points, voxel_width) - torch.as_tensor(
        np.asarray(pvt, np.int32), device=dev)
    hgt_ok = (points[:, 2] >= ogm_min_h) & (points[:, 2] <= ogm_max_h)
    reg = valid & hgt_ok & geo.inside_volume(loc, local_size)
    flat = loc[:, 0] * (Y * Z) + loc[:, 1] * Z + loc[:, 2]
    flat = torch.where(reg, flat, 0).long()
    cnt = torch.zeros(X * Y * Z, dtype=torch.int32, device=dev)
    cnt.index_add_(0, flat, reg.to(torch.int32))
    return cnt.reshape(X, Y, Z)


def pointcloud_project(points, valid, origin, pvt, *, local_size, voxel_width,
                       ogm_min_h, ogm_max_h, for_motion_planner: bool,
                       robot_r2_grids: int, n_theta: int = 512,
                       n_phi: int = 256):
    """Dense projective point-cloud OGM update.

    points float32 [N, 3] WORLD frame endpoints; valid bool [N]; origin (3,)
    sensor origin and pvt (3,) window pivot as host values.  Returns
    (inst_type int8, ray_count int32) [X, Y, Z]."""
    local_size = tuple(int(s) for s in local_size)
    ep = endpoint_counts(points, valid, pvt, local_size=local_size,
                         voxel_width=voxel_width, ogm_min_h=ogm_min_h,
                         ogm_max_h=ogm_max_h)
    depth, cnt = panorama(points, valid, origin, n_theta=n_theta, n_phi=n_phi,
                          local_size=local_size, voxel_width=voxel_width)
    return carve(depth, cnt, ep, pvt, origin, local_size=local_size,
                 voxel_width=voxel_width, n_theta=n_theta, n_phi=n_phi,
                 for_motion_planner=for_motion_planner,
                 robot_r2_grids=robot_r2_grids)
