"""Projection ("inverse") sensor models: 2-D LiDAR, depth camera and
multi-ring 3-D LiDAR.

Counterpart of gie_mapping_tpu/ops/scan_sensors.py (hokuyo_update,
realsense_update and vlp16_update, with ScanParam, CamParam, MulScanParam
and the window helpers).  Every window voxel is projected into the
measurement (a scan, a depth image, a ring image) and compared with the
measured range there.  The depth image is read with a plain gather, as
the JAX package does on the CPU (its TPU one-hot lookup is not carried).

The beam index comes from float trigonometry, so every rounding step
follows the JAX CPU reference's jitted frame program: the window position
minus the sensor origin is one fused multiply-add (c * w - o) in x and y
and the rounded height minus o in z (_sensor_offsets), the frame
change is XLA's dot (geometry.Projection.to_local), atan2 is the C library's
atan2f (kernels/carve.py::atan2f_exact), every square root is correctly
rounded, and the beam's divide is an IEEE division by a tensor.

One step is not followed: the planar range sqrt(x**2 + y**2) is taken in
XLA's fused form, sqrt(fma(x, x, y * y)).  XLA's CPU loop vectoriser leaves
the squares unfused in its vector body and fuses them in its scalar tail,
and which voxels of a row fall in the tail is a choice of its cost model
(it varies with the row length and the fusion around it), so the range may
differ from the reference's by an ulp.  It feeds only the +-0.3 m
comparisons with the measured range.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import geometry as geo
from ..utils.constants import (SENS_FAR_DIST, VOX_FREE, VOX_OCCUPIED,
                               VOX_UNKNOWN)
from ..utils.floats import (cosf_exact, fma_f32, ftz_f32, sinf_exact,
                            sqrt_f32)
from .kernels.carve import atan2f_exact, hypot2_f32


@dataclasses.dataclass
class ScanParam:
    """2-D scan geometry: the first beam's angle, the angle between beams
    (float32 values) and the measured ranges (float32 [scan_num] tensor)."""

    theta_min: float
    theta_inc: float
    ranges: torch.Tensor

    @property
    def scan_num(self) -> int:
        return self.ranges.shape[0]


@dataclasses.dataclass
class CamParam:
    """Pinhole intrinsics (float32 values) and the depth image (float32
    [rows, cols] tensor, the forward distance per pixel; NaN where
    nothing was measured)."""

    fx: float
    fy: float
    cx: float
    cy: float
    depth: torch.Tensor


@dataclasses.dataclass
class MulScanParam:
    """Multi-ring spinning-LiDAR geometry: the first column's azimuth and
    the azimuth step, the lowest ring's elevation and the ring step
    (float32 values), and the horizontal ranges (float32 [ring_num,
    scan_num] tensor)."""

    theta_min: float
    theta_inc: float
    phi_min: float
    phi_inc: float
    rings: torch.Tensor

    @property
    def ring_num(self) -> int:
        return self.rings.shape[0]

    @property
    def scan_num(self) -> int:
        return self.rings.shape[1]


def _f32(v: float, dev) -> torch.Tensor:
    """A float32 scalar tensor of the value v rounded to float32."""
    return torch.tensor(float(np.float32(v)), device=dev)


def _window_coords(pvt, local_size, device=None):
    """(X, Y, Z, 3) float32 global voxel coordinates of the window."""
    loc = geo.local_coord_grid(local_size, device)
    return (loc + torch.as_tensor(np.asarray(pvt, np.int32), device=device)).float()


def _sensor_offsets(c, glb_z, vw, trans, replay):
    """World offsets (c * w - t) of the window voxels from the sensor,
    rounded as the JAX reference's sensor programs round them: fma(c, w, -t)
    in x and y.  In z the per-frame program's vector loop subtracts t_z
    from the rounded product c_z * w (`glb_z`): the vectoriser interleaves
    the three components and the shuffle between z's multiply and its
    subtract keeps them apart.  Its scalar tail (the last voxels mod 8, as
    in Projection.to_local) fuses z as well, and so does the replay's scan
    loop (`replay`), which XLA:CPU emits as a scalar loop
    (pipeline._in_scan_loop)."""
    d = fma_f32(c, vw, -trans)
    if not replay:
        flat, z = d.view(-1, 3), glb_z.reshape(-1)
        n_full = flat.shape[0] // 8 * 8
        flat[:n_full, 2] = z[:n_full] - trans[2]
    return d


def _robot_sphere_mask(local_size, robot_r2_grids, device=None):
    """Voxels within the robot radius of the window centre."""
    loc = geo.local_coord_grid(local_size, device)
    half = torch.tensor([s // 2 for s in local_size], dtype=torch.int32,
                        device=device)
    d = loc - half
    return (d * d).sum(-1) <= robot_r2_grids


def beam_geometry(proj: geo.Projection, param: ScanParam, pvt, local_size,
                  voxel_width, replay: bool = False):
    """Per window voxel: its world height (float32 [X, Y, Z]), its position
    in the sensor frame (float32 [X, Y, Z, 3]), its beam index (int32,
    wrapped into [0, scan_num)) and its planar range (float32, -1 off the
    scan plane), each rounded as the JAX reference's jitted program rounds
    it (the range up to an ulp, see the module docstring).  proj lies on the
    device of param.ranges."""
    dev = param.ranges.device
    c = _window_coords(pvt, local_size, dev)
    vw = _f32(voxel_width, dev)
    glb_z = c[..., 2] * vw
    local_pos = proj.to_local(_sensor_offsets(c, glb_z, vw, proj.trans, replay))
    lx, ly, lz = local_pos[..., 0], local_pos[..., 1], local_pos[..., 2]

    theta = atan2f_exact(ly, lx)
    # a floor remainder: the beam index wraps into [0, scan_num)
    theta_idx = torch.floor((theta - _f32(param.theta_min, dev))
                            / _f32(param.theta_inc, dev) + 0.5) \
        .to(torch.int32).remainder(param.scan_num)
    planar = lz.abs() < float(np.float32(voxel_width))
    idea_depth = torch.where(planar, hypot2_f32(lx, ly), -1.0)
    return glb_z, local_pos, theta_idx, idea_depth


def hokuyo_update(proj: geo.Projection, param: ScanParam, pvt, *, local_size,
                  voxel_width, ogm_min_h, ogm_max_h, for_motion_planner: bool,
                  robot_r2_grids: int, replay: bool = False) -> torch.Tensor:
    """2-D LiDAR inverse model over the window at pivot `pvt` (host ints);
    `replay` rounds as the JAX replay's scan loop (_sensor_offsets).
    proj's rot and trans and param.ranges lie on the device the result
    takes.  Returns inst_type int8 [X, Y, Z]."""
    local_size = tuple(int(s) for s in local_size)
    dev = param.ranges.device
    proj = proj.to(dev)
    glb_z, _, theta_idx, idea_depth = beam_geometry(proj, param, pvt,
                                                    local_size, voxel_width,
                                                    replay)

    real_depth = param.ranges[theta_idx.long()]
    meas_ok = (idea_depth >= 0) & ~torch.isnan(real_depth) & (real_depth > 0.3)
    free = meas_ok & (idea_depth < real_depth - 0.3)
    hgt_ok = (glb_z >= ogm_min_h) & (glb_z <= ogm_max_h)
    occ = (meas_ok & (idea_depth >= real_depth - 0.3)
           & (idea_depth <= real_depth + 0.3) & hgt_ok)
    return _finish(occ, free, local_size, for_motion_planner, robot_r2_grids,
                   dev)


def _finish(occ, free, local_size, for_motion_planner, robot_r2_grids, dev):
    """inst_type int8 of the occupied and free masks; with
    for_motion_planner the robot's sphere is free."""
    inst = torch.where(occ, VOX_OCCUPIED, torch.where(free, VOX_FREE,
                                                      VOX_UNKNOWN))
    if for_motion_planner:
        inst = torch.where(_robot_sphere_mask(local_size, robot_r2_grids, dev),
                           VOX_FREE, inst)
    return inst.to(torch.int8)


def pixel_geometry(proj: geo.Projection, param: CamParam, pvt, local_size,
                   voxel_width, replay: bool = False):
    """Per window voxel: its world height, its forward distance in the
    sensor frame (x) and its pixel column and row (int32, unclipped),
    rounded as the JAX reference's jitted program rounds them: the frame
    change as the 2-D LiDAR's, then floor(-y * fx / d + cx + 0.5) with
    IEEE operations in that order (d = x, or 1e-6 where |x| <= 1e-6).
    proj lies on the device of param.depth."""
    dev = param.depth.device
    c = _window_coords(pvt, local_size, dev)
    vw = _f32(voxel_width, dev)
    glb_z = c[..., 2] * vw
    local_pos = proj.to_local(_sensor_offsets(c, glb_z, vw, proj.trans, replay))
    lx, ly, lz = local_pos[..., 0], local_pos[..., 1], local_pos[..., 2]
    eps = _f32(1e-6, dev)
    safe = torch.where(lx.abs() > eps, lx, eps)
    px = torch.floor(-ly * _f32(param.fx, dev) / safe + _f32(param.cx, dev)
                     + 0.5).to(torch.int32)
    py = torch.floor(-lz * _f32(param.fy, dev) / safe + _f32(param.cy, dev)
                     + 0.5).to(torch.int32)
    return glb_z, lx, px, py


def realsense_update(proj: geo.Projection, param: CamParam, pvt, *,
                     local_size, voxel_width, ogm_min_h, ogm_max_h,
                     for_motion_planner: bool, robot_r2_grids: int,
                     valid_nan: bool = False,
                     replay: bool = False) -> torch.Tensor:
    """Depth-camera inverse model over the window at pivot `pvt` (host
    ints).  Sensor frame: x forward (depth), y left, z up.  A NaN pixel is
    a miss (valid_nan: far, SENS_FAR_DIST; else unmeasured); an +Inf pixel
    is measured: free up to the frustum, never occupied.  proj and
    param.depth lie on the device the result takes.  Returns inst_type
    int8 [X, Y, Z]."""
    local_size = tuple(int(s) for s in local_size)
    dev = param.depth.device
    proj = proj.to(dev)
    rows, cols = param.depth.shape
    glb_z, idea, px, py = pixel_geometry(proj, param, pvt, local_size,
                                         voxel_width, replay)
    in_frustum = ((idea > 0.3) & (idea <= 6.0) & (px >= 0) & (px < cols)
                  & (py >= 0) & (py < rows))
    # the NaN policy on the image side, as the JAX package applies it
    dimg = torch.where(torch.isnan(param.depth),
                       SENS_FAR_DIST if valid_nan else -1.0, param.depth)
    real = dimg[py.clamp(0, rows - 1).long(), px.clamp(0, cols - 1).long()]
    meas_ok = in_frustum & (real > 0.21)
    vw = float(np.float32(voxel_width))
    free = meas_ok & (idea < real - vw)
    hgt_ok = (glb_z >= ogm_min_h) & (glb_z <= ogm_max_h)
    occ = (meas_ok & (idea >= real - vw) & (idea <= real + vw) & hgt_ok)
    return _finish(occ, free, local_size, for_motion_planner, robot_r2_grids,
                   dev)


def ring_geometry(proj: geo.Projection, param: MulScanParam, pvt, local_size,
                  voxel_width, replay: bool = False):
    """Per window voxel: its world height, its azimuth bin (wrapped into
    [0, scan_num)) and elevation bin (int32, unclipped), its horizontal
    range and its distance to the axis of the beam of its bins' angles
    (float32), rounded as the JAX reference's jitted program rounds them:
    atan2 and sin / cos are the C library's, every root correctly rounded,
    the horizontal range sqrt(fma(x, x, y * y)), the axis distance
    sqrt(fma(z, z, fma(x, x, y * y))) of the cross product (x, y, z), and
    each cross-product term a * b - c * d as fma(a, b, -(c * d)): LLVM
    contracts the left product of a sum or difference of two products.
    The axis distance's squares flush subnormal values to zero, as XLA's
    CPU code does.  proj lies on the device of
    param.rings."""
    dev = param.rings.device
    c = _window_coords(pvt, local_size, dev)
    vw = _f32(voxel_width, dev)
    glb_z = c[..., 2] * vw
    local_pos = proj.to_local(_sensor_offsets(c, glb_z, vw, proj.trans, replay))
    lx, ly, lz = local_pos[..., 0], local_pos[..., 1], local_pos[..., 2]

    theta = atan2f_exact(ly, lx)
    theta_idx = torch.floor((theta - _f32(param.theta_min, dev))
                            / _f32(param.theta_inc, dev) + 0.5) \
        .to(torch.int32).remainder(param.scan_num)
    range_hor = hypot2_f32(lx, ly)
    phi = atan2f_exact(lz, range_hor)
    phi_idx = torch.floor((phi - _f32(param.phi_min, dev))
                          / _f32(param.phi_inc, dev) + 0.5).to(torch.int32)

    uz = sinf_exact(phi)
    uxy = cosf_exact(phi)
    ux = uxy * cosf_exact(theta)
    uy = uxy * sinf_exact(theta)
    cxv = fma_f32(uz, ly, -(uy * lz))
    cyv = fma_f32(ux, lz, -(uz * lx))
    czv = fma_f32(uy, lx, -(ux * ly))
    # a voxel on the beam's axis squares a tiny term: XLA flushes the
    # subnormal result to zero
    sq = ftz_f32(fma_f32(cxv, cxv, ftz_f32(cyv * cyv)))
    dist2ray = sqrt_f32(ftz_f32(fma_f32(czv, czv, sq)))
    return glb_z, theta_idx, phi_idx, range_hor, dist2ray


def vlp16_update(proj: geo.Projection, param: MulScanParam, pvt, *,
                 local_size, voxel_width, ogm_min_h, ogm_max_h,
                 for_motion_planner: bool, robot_r2_grids: int,
                 replay: bool = False) -> torch.Tensor:
    """Multi-ring spherical-projection inverse model over the window at
    pivot `pvt` (host ints): a voxel is compared with the range of its
    (elevation, azimuth) bin when it lies within one voxel width of that
    beam's axis; free below the range - 0.3 m, occupied within 0.1 m of
    it.  proj and param.rings lie on the device the result takes.
    Returns inst_type int8 [X, Y, Z]."""
    local_size = tuple(int(s) for s in local_size)
    dev = param.rings.device
    proj = proj.to(dev)
    glb_z, theta_idx, phi_idx, range_hor, dist2ray = ring_geometry(
        proj, param, pvt, local_size, voxel_width, replay)
    phi_ok = (phi_idx >= 0) & (phi_idx < param.ring_num)
    vw = float(np.float32(voxel_width))
    idea = torch.where(phi_ok & (dist2ray < vw), range_hor, -1.0)
    real = param.rings[phi_idx.clamp(0, param.ring_num - 1).long(),
                       theta_idx.long()]
    meas_ok = (idea >= 0) & ~torch.isnan(real) & (real > 0.3)
    free = meas_ok & (idea < real - 0.3)
    hgt_ok = (glb_z >= ogm_min_h) & (glb_z <= ogm_max_h)
    occ = (meas_ok & (idea >= real - 0.1) & (idea <= real + 0.1) & hgt_ok)
    return _finish(occ, free, local_size, for_motion_planner, robot_r2_grids,
                   dev)
