"""An RGB-D camera that delivers a point cloud: one point a pixel of a
pinhole depth image [rows, cols], in the sensor frame (x forward, pixel
(u, v) at depth z is (z, -(u - cx) z / fx, -(v - cy) z / fy)), with depth
noise sigma = noise_sigma_per_m2 z^2 along each pixel's ray.  Every pixel
of a closed world hits a surface, so a frame holds rows x cols points.

Engine: VolumetricMapper.process_pointcloud, whose sensor model is
mapper.pointcloud_sensor (the projective carve, ops/raycast.py).
Reference: reference/cloud.py::cloud_model.  (The module interface is set
out in sensors/depth.py.)
"""
from __future__ import annotations

import numpy as np
import torch

from mapbench.reference.cloud import cloud_model
from mapbench.world import depth_images, pixel_rays

SPAN = ("models.mapper", "pointcloud_sensor")
# 4,096 points: the transform's rounding holds for multiples of 4,096
TINY = {"rows": 64, "cols": 64, "fx": 73.9, "fy": 73.9, "cx": 31.5, "cy": 31.5}
TINY_DEPLOYMENT = {"max_raycast_points": 4096}


def size(sensor: dict) -> int:
    return int(sensor["rows"]) * int(sensor["cols"])


def render(boxes, rots, trans, sensor, passes, gen):
    """(data [K, F, rows * cols, 3] float32, live points per frame [F]) of
    F poses in a box world, K noisy passes drawn from `gen`."""
    clean = depth_images(boxes, rots, trans, sensor)              # [F, rows, cols]
    F = clean.shape[0]
    z = clean[None] + sensor["noise_sigma_per_m2"] * clean[None] ** 2 * torch.randn(
        (passes,) + tuple(clean.shape), generator=gen, device=clean.device)
    rays = pixel_rays(sensor, clean.device)                       # [P, 3], unit x
    data = rays[None, None] * z.reshape(passes, F, -1, 1)
    return data, torch.isfinite(clean).reshape(F, -1).sum(1)


def engine_frame(mapper, sensor, proj, data):
    return mapper.process_pointcloud(proj, data)


def reference_frame(ref, sensor, rot, trans, data):
    dep = ref.dep
    if dep.get("fuse_raycast") or dep.get("raycast_mode", "projective") != "projective":
        raise NotImplementedError("the reference takes the projective model "
                                  "with the eager transform")
    trans32 = np.asarray(trans, np.float32)
    pvt, origin, enter, off = ref.place(trans32)
    pts = torch.from_numpy(np.asarray(data, np.float32)).to(ref.dev)
    inst, rc = cloud_model(pts, rot, trans32, pvt, local=ref.g.local, vw=ref.g.vw,
                           min_h=dep["ogm_min_h"], max_h=dep["ogm_max_h"], low=ref.low)
    ref.merge(inst, rc, origin, enter, off)
