"""Projection ("inverse") sensor model of a 2-D LiDAR.

Counterpart of gie_mapping_tpu/ops/scan_sensors.py::hokuyo_update (with
ScanParam and the window helpers); the depth-camera and multi-ring models
are not ported yet.  Every window voxel is projected into the scan and
compared with the measured range of its beam.

The beam index comes from float trigonometry, so every rounding step
follows the JAX CPU reference's jitted frame program: the window position
minus the sensor origin is one fused multiply-add (c * w - o), the frame
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
from ..utils.constants import VOX_FREE, VOX_OCCUPIED, VOX_UNKNOWN
from ..utils.floats import fma_f32
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


def _window_coords(pvt, local_size, device=None):
    """(X, Y, Z, 3) float32 global voxel coordinates of the window."""
    loc = geo.local_coord_grid(local_size, device)
    return (loc + torch.as_tensor(np.asarray(pvt, np.int32), device=device)).float()


def _robot_sphere_mask(local_size, robot_r2_grids, device=None):
    """Voxels within the robot radius of the window centre."""
    loc = geo.local_coord_grid(local_size, device)
    half = torch.tensor([s // 2 for s in local_size], dtype=torch.int32,
                        device=device)
    d = loc - half
    return (d * d).sum(-1) <= robot_r2_grids


def beam_geometry(proj: geo.Projection, param: ScanParam, pvt, local_size,
                  voxel_width):
    """Per window voxel: its world height (float32 [X, Y, Z]), its position
    in the sensor frame (float32 [X, Y, Z, 3]), its beam index (int32,
    wrapped into [0, scan_num)) and its planar range (float32, -1 off the
    scan plane), each rounded as the JAX reference's jitted program rounds
    it (the range up to an ulp, see the module docstring).  proj lies on the
    device of param.ranges."""
    dev = param.ranges.device
    c = _window_coords(pvt, local_size, dev)
    vw = torch.tensor(float(np.float32(voxel_width)), device=dev)
    glb_z = c[..., 2] * vw
    local_pos = proj.to_local(fma_f32(c, vw, -proj.trans))
    lx, ly, lz = local_pos[..., 0], local_pos[..., 1], local_pos[..., 2]

    theta = atan2f_exact(ly, lx)
    tmin = torch.tensor(float(np.float32(param.theta_min)), device=dev)
    tinc = torch.tensor(float(np.float32(param.theta_inc)), device=dev)
    # a floor remainder: the beam index wraps into [0, scan_num)
    theta_idx = torch.floor((theta - tmin) / tinc + 0.5).to(torch.int32) \
        .remainder(param.scan_num)
    planar = lz.abs() < float(np.float32(voxel_width))
    idea_depth = torch.where(planar, hypot2_f32(lx, ly), -1.0)
    return glb_z, local_pos, theta_idx, idea_depth


def hokuyo_update(proj: geo.Projection, param: ScanParam, pvt, *, local_size,
                  voxel_width, ogm_min_h, ogm_max_h, for_motion_planner: bool,
                  robot_r2_grids: int) -> torch.Tensor:
    """2-D LiDAR inverse model over the window at pivot `pvt` (host ints).
    proj's rot and trans and param.ranges lie on the device the result
    takes.  Returns inst_type int8 [X, Y, Z]."""
    local_size = tuple(int(s) for s in local_size)
    dev = param.ranges.device
    proj = proj.to(dev)
    glb_z, _, theta_idx, idea_depth = beam_geometry(proj, param, pvt,
                                                    local_size, voxel_width)

    real_depth = param.ranges[theta_idx.long()]
    meas_ok = (idea_depth >= 0) & ~torch.isnan(real_depth) & (real_depth > 0.3)
    free = meas_ok & (idea_depth < real_depth - 0.3)
    hgt_ok = (glb_z >= ogm_min_h) & (glb_z <= ogm_max_h)
    occ = (meas_ok & (idea_depth >= real_depth - 0.3)
           & (idea_depth <= real_depth + 0.3) & hgt_ok)
    inst = torch.where(occ, VOX_OCCUPIED, torch.where(free, VOX_FREE,
                                                      VOX_UNKNOWN))
    if for_motion_planner:
        inst = torch.where(_robot_sphere_mask(local_size, robot_r2_grids, dev),
                           VOX_FREE, inst)
    return inst.to(torch.int8)
