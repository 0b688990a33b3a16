"""The depth camera's inverse sensor model of the plain reference.

Every window voxel is put into the camera frame (the published program's
rounding: fma(c, w, -o), z from the rounded product over whole groups of
eight voxels, the rotation as reference/floats.py::to_sensor rounds it),
projected to its pixel, and typed against that pixel's depth: OCCUPIED
within one voxel of it (inside the height band), FREE in front, UNKNOWN
outside the 0.3-6 m frustum or where the pixel holds no depth.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .floats import fma32, to_sensor
from .mapper import FREE, OCCUPIED, UNKNOWN

SENS_FAR = 100.0   # a NaN pixel's depth where the deployment reads NaN as far


def depth_model(ref, pvt, rot, trans, depth, fx, fy, cx, cy):
    """inst_type int8 [X, Y, Z] of the window at pivot pvt of a reference
    map `ref` (reference.mapper.RefMapper: its geometry, settings, device
    and precision), for a depth image [rows, cols] at pose (rot, trans)."""
    g = ref.g
    d = ref.dev
    X, Y, Z = g.local
    axes = [torch.arange(n, dtype=torch.int32, device=d) for n in g.local]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    c = (grid + torch.as_tensor(np.asarray(pvt, np.int32), device=d)).float()
    rot_t = torch.from_numpy(np.asarray(rot, np.float32)).to(d)
    tr = torch.from_numpy(np.asarray(trans, np.float32)).to(d)
    f32 = lambda v: torch.tensor(float(np.float32(v)), device=d)
    if ref.low:
        lo = torch.bfloat16
        c, rot_t, tr = c.to(lo), rot_t.to(lo), tr.to(lo)
        vw = f32(g.vw).to(lo)
        glb_z = c[..., 2] * vw
        rel = c * vw - tr
        loc = rel @ rot_t
        lx, ly, lz = loc[..., 0], loc[..., 1], loc[..., 2]
        eps = f32(1e-6).to(lo)
        safe = torch.where(lx.abs() > eps, lx, eps)
        px = torch.floor(-ly * f32(fx).to(lo) / safe + f32(cx).to(lo) + 0.5)
        py = torch.floor(-lz * f32(fy).to(lo) / safe + f32(cy).to(lo) + 0.5)
        px, py = px.to(torch.int32), py.to(torch.int32)
    else:
        vw = f32(g.vw)
        glb_z = c[..., 2] * vw
        rel = fma32(c, vw, -tr)
        # the published per-frame program subtracts z from the rounded
        # product over whole groups of eight voxels, fused in the tail
        flat, zz = rel.view(-1, 3), glb_z.reshape(-1)
        n = flat.shape[0] // 8 * 8
        flat[:n, 2] = zz[:n] - tr[2]
        loc = to_sensor(rel, rot_t)
        lx, ly, lz = loc[..., 0], loc[..., 1], loc[..., 2]
        eps = f32(1e-6)
        safe = torch.where(lx.abs() > eps, lx, eps)
        px = torch.floor(-ly * f32(fx) / safe + f32(cx) + 0.5).to(torch.int32)
        py = torch.floor(-lz * f32(fy) / safe + f32(cy) + 0.5).to(torch.int32)
    img = torch.from_numpy(np.asarray(depth, np.float32)).to(d)
    if ref.low:
        img = img.to(torch.bfloat16)
    rows, cols = img.shape
    in_frustum = ((lx > 0.3) & (lx <= 6.0) & (px >= 0) & (px < cols)
                  & (py >= 0) & (py < rows))
    img = torch.where(torch.isnan(img), SENS_FAR if ref.dep["valid_nan"] else -1.0, img)
    real = img[py.clamp(0, rows - 1).long(), px.clamp(0, cols - 1).long()]
    ok = in_frustum & (real > 0.21)
    w = float(np.float32(g.vw))
    free = ok & (lx < real - w)
    band = (glb_z >= ref.dep["ogm_min_h"]) & (glb_z <= ref.dep["ogm_max_h"])
    occ = ok & (lx >= real - w) & (lx <= real + w) & band
    inst = torch.where(occ, OCCUPIED, torch.where(free, FREE, UNKNOWN))
    if ref.dep["for_motion_planner"]:
        r2 = int(math.ceil(ref.dep["robot_r"] / g.vw)) ** 2
        half = torch.tensor([s // 2 for s in g.local], device=d)
        inst = torch.where(((grid - half) ** 2).sum(-1) <= r2, FREE, inst)
    return inst.to(torch.int8)
