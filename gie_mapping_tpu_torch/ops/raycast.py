"""The point-cloud sensor models: the projective carve (endpoint scatter,
min-depth panorama, per-voxel carve) and the exact per-ray DDA walk.

Counterpart of gie_mapping_tpu/ops/raycast.py: `pointcloud_project` is two
kernels of ops/kernels/carve.py, `panorama` over the points and `carve`
over the window's voxels; `pointcloud_raycast` (raycast_mode "dda") walks
every ray voxel by voxel in plain PyTorch operations, as the JAX package's
scan does in XLA.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import geometry as geo
from ..utils.constants import VOX_FREE, VOX_OCCUPIED, VOX_UNKNOWN
from .kernels.carve import carve, norm3_f32, panorama
from .scan_sensors import _robot_sphere_mask


def max_dda_steps(local_size) -> int:
    """Static step bound: a ray of length .707*X voxels crosses at most
    ~sqrt(3)*.707*X + 3 voxel boundaries."""
    return int(math.ceil(0.707 * local_size[0] * math.sqrt(3.0))) + 4


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


def pointcloud_raycast(points, valid, origin, pvt, *, local_size, voxel_width,
                       ogm_min_h, ogm_max_h, for_motion_planner: bool,
                       robot_r2_grids: int):
    """Exact point-cloud OGM update: every endpoint inside the window (and
    the height band) counts +1 in its voxel; every ray then walks from the
    sensor's voxel towards its endpoint's, one voxel boundary a step
    (Amanatides-Woo: the axis of the smallest t_max, the first on ties),
    and counts -1 in each voxel it enters until it reaches the endpoint's
    voxel, enters a voxel holding an endpoint, or passes the ray's length
    or 0.707 * X voxel widths.  The sensor's own voxel counts -1 for each
    ray unless an endpoint lies there.  A fixed max_dda_steps steps run,
    each ray masked once done; the counts are integer scatter-adds, exact
    in any order.  The floats round as the JAX package's program does
    (pos2coord's fused reciprocal, the fused norm, the voxel border
    p0 * w + step * w * 0.5 unfused, IEEE divisions).

    points float32 [N, 3] WORLD frame endpoints; valid bool [N]; origin (3,)
    sensor origin and pvt (3,) window pivot as host values.  Returns
    (inst_type int8, ray_count int32) [X, Y, Z]."""
    local_size = tuple(int(s) for s in local_size)
    X, Y, Z = local_size
    dev = points.device
    size = torch.tensor(local_size, dtype=torch.int32, device=dev)
    pvt_t = torch.as_tensor(np.asarray(pvt, np.int32), device=dev)
    strides = torch.tensor([Y * Z, Z, 1], dtype=torch.int32, device=dev)
    n_vox = X * Y * Z

    def flat_inside(loc):
        ins = geo.inside_volume(loc, size)
        return torch.where(ins, (loc * strides).sum(-1, dtype=torch.int32),
                           0).long(), ins

    glb_crd = geo.pos2coord(points, voxel_width)
    loc_crd = glb_crd - pvt_t
    hgt_ok = (points[:, 2] >= ogm_min_h) & (points[:, 2] <= ogm_max_h)
    flat, inside = flat_inside(loc_crd)
    reg = valid & hgt_ok & inside
    counts = torch.zeros(n_vox, dtype=torch.int32, device=dev)
    counts.index_add_(0, flat, reg.to(torch.int32))
    endpoint_occ = counts > 0

    p0 = torch.as_tensor(np.asarray(origin, np.float32), device=dev)
    p0_idx = geo.pos2coord(p0, voxel_width)
    direction = points - p0
    seg_len = norm3_f32(direction)
    dirn = direction / seg_len.clamp(min=1e-9)[:, None]
    max_length = float(np.float32(0.707 * X * voxel_width))
    step = torch.where(dirn > 0, 1, torch.where(dirn < 0, -1, 0)) \
        .to(torch.int32)
    vw = torch.tensor(float(np.float32(voxel_width)), device=dev)
    stepf = step.to(torch.float32)
    border = p0_idx.to(torch.float32) * vw + stepf * vw * 0.5
    big = float(np.float32(3.4e38))
    moving = step != 0
    dsafe = torch.where(moving, dirn, 1.0)
    t_max = torch.where(moving, (border - p0) / dsafe, big)
    t_delta = torch.where(moving, vw / dsafe.abs(), big)
    p1_idx = glb_crd

    # the sensor's voxel, for each ray not stopped there by an endpoint
    p0_flat, p0_in = flat_inside((p0_idx - pvt_t)[None, :])
    first = valid & ~endpoint_occ[p0_flat] & p0_in
    counts.index_add_(0, p0_flat.expand_as(valid), -first.to(torch.int32))

    n = points.shape[0]
    cur = p0_idx.expand(n, 3).clone()
    done = (p1_idx == p0_idx).all(-1) | ~valid
    axes = torch.arange(3, device=dev)
    for _ in range(max_dda_steps(local_size)):
        onehot = t_max.argmin(-1, keepdim=True) == axes
        new_cur = cur + torch.where(onehot, step, 0)
        new_tmax = torch.where(onehot, t_max + t_delta, t_max)
        f, ins = flat_inside(new_cur - pvt_t)
        hit_occ = endpoint_occ[f] & ins
        live = ~done
        dec = live & ~hit_occ & ins
        counts.index_add_(0, f, -dec.to(torch.int32))
        reached = (new_cur == p1_idx).all(-1)
        t_next = new_tmax.amin(-1)
        done = (done | hit_occ | reached | (t_next > max_length)
                | (t_next > seg_len))
        cur = torch.where(live[:, None], new_cur, cur)
        t_max = torch.where(live[:, None], new_tmax, t_max)

    ray_count = counts.reshape(X, Y, Z)
    if for_motion_planner:
        ray_count = torch.where(
            _robot_sphere_mask(local_size, robot_r2_grids, dev), -1, ray_count)
    inst_type = torch.where(ray_count > 0, VOX_OCCUPIED, torch.where(
        ray_count < 0, VOX_FREE, VOX_UNKNOWN)).to(torch.int8)
    return inst_type, ray_count
