"""Offline visualization export (rviz-equivalent).

A copy of gie_mapping_tpu/runtime/viz.py for the PyTorch port.

The reference publishes local/global OGM and EDT point clouds to rviz
(include/volumetric_mapper.h:181-317).  Headless here:
the same clouds export to PLY (viewable in MeshLab/CloudCompare/Open3D) or
npz.
"""
from __future__ import annotations

import numpy as np


def write_ply(path, points, scalars=None, scalar_name="intensity"):
    """ASCII PLY writer for [N,3] points with an optional per-point scalar."""
    points = np.asarray(points, np.float32)
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if scalars is not None:
            f.write(f"property float {scalar_name}\n")
        f.write("end_header\n")
        if scalars is None:
            for p in points:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
        else:
            for p, s in zip(points, np.asarray(scalars, np.float32)):
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {s:.4f}\n")
    return n


def export_frame(out, voxel_width, prefix):
    """Write <prefix>_occ.ply and <prefix>_edt.ply for one FrameOutput
    (publish_local_ptcld_2_rviz equivalent)."""
    occ = out.local_occupied_cloud(voxel_width)
    pos, dist = out.local_edt_cloud(voxel_width)
    n1 = write_ply(f"{prefix}_occ.ply", occ)
    n2 = write_ply(f"{prefix}_edt.ply", pos, dist, "distance")
    return n1, n2


def export_global(mirror, voxel_width, prefix):
    """Write the streamed global map clouds (publish_glb_2_rviz equivalent)."""
    occ = mirror.occupied_cloud(voxel_width)
    pos, dist = mirror.edt_cloud(voxel_width)
    n1 = write_ply(f"{prefix}_glb_occ.ply", occ)
    n2 = write_ply(f"{prefix}_glb_edt.ply", pos, dist, "distance")
    return n1, n2
