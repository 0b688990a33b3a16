"""Rigid transforms and voxel-grid frame conversions, in PyTorch.

Counterpart of gie_mapping_tpu/utils/geometry.py (the reference's
SE3/Projection substrate and LocMap frame math).  Points are (..., 3)
float32 tensors and voxel coordinates (..., 3) int32 tensors; host-side
helpers stay numpy.

Float results must equal the JAX package's bit for bit, so every formula
keeps the reference's operation order and rounding (utils/floats.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .floats import fma_f32, recip_f32


def quat_to_rot(qw, qx, qy, qz):
    """Quaternion (w,x,y,z) to 3x3 rotation matrix (numpy, host-side)."""
    n = np.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    return np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
        ],
        dtype=np.float32,
    )


@dataclasses.dataclass
class Projection:
    """Sensor pose: the local(sensor)->global rigid transform.

    rot (3,3) float32 and trans (3,) float32 tensors, on the CPU unless moved
    with `to`."""

    rot: torch.Tensor
    trans: torch.Tensor

    def l2g(self, pts: torch.Tensor) -> torch.Tensor:
        """pts @ rot.T + trans, rounded as the JAX package's eager CPU matmul
        rounds it for point counts that are multiples of 4096 (the mapper's
        staging buckets): output x and y as ((x r0 + y r1) + z r2), output z
        as fma(z, r2, fma(y, r1, x r0)); then + trans.  A library matmul
        would fuse or reorder these differently."""
        r = self.rot.to(pts.device)
        x, y, z = pts[:, 0:1], pts[:, 1:2], pts[:, 2:3]
        xy = (x * r[:2, 0] + y * r[:2, 1]) + z * r[:2, 2]
        zz = fma_f32(z, r[2, 2], fma_f32(y, r[2, 1], x * r[2, 0]))
        return torch.cat([xy, zz], dim=1) + self.trans.to(pts.device)

    def l2g_fused(self, pts: torch.Tensor) -> torch.Tensor:
        """pts @ rot.T + trans, rounded as the JAX package's jitted frame
        program rounds it when the transform runs inside it (fuse_raycast:
        frame_step, scroll_frame_step and the replay scan body): every
        output column fma(z, r[:, 2], fma(y, r[:, 1], x * r[:, 0])), fused
        in all three columns whatever the point count, then one unfused add
        of trans."""
        r = self.rot.to(pts.device)
        x, y, z = pts[:, 0:1], pts[:, 1:2], pts[:, 2:3]
        return (fma_f32(z, r[:, 2], fma_f32(y, r[:, 1], x * r[:, 0]))
                + self.trans.to(pts.device))

    def to_local(self, rel: torch.Tensor) -> torch.Tensor:
        """Sensor-frame coordinates of world offsets rel = p - trans
        ([..., 3], rounded by the caller): rel @ rot, rounded as XLA's CPU
        dot rounds it inside a jitted program.  Over the rows in whole
        groups of eight, output x and y are ((a0 r0 + a1 r1) + a2 r2) and
        output z is fma(a2, r2, fma(a1, r1, a0 r0)); the last (rows mod 8)
        rows take the fused form in every column."""
        r = self.rot.to(rel.device)
        a = rel.reshape(-1, 3)
        x, y, z = a[:, 0:1], a[:, 1:2], a[:, 2:3]
        out = fma_f32(z, r[2], fma_f32(y, r[1], x * r[0]))
        n_full = a.shape[0] // 8 * 8
        out[:n_full, :2] = ((x * r[0, :2] + y * r[1, :2])
                            + z * r[2, :2])[:n_full]
        return out.reshape(rel.shape)

    def g2l(self, pts: torch.Tensor) -> torch.Tensor:
        """World points (..., 3) into the sensor frame: (pts - trans) @ rot,
        rounded as the JAX package's eager g2l (XLA's CPU dot on its own):
        over 32 rows or more, to_local's rule (x and y unfused over whole
        groups of 8 rows, the rest fused); below 32 rows the same where
        16 <= rows and rows mod 8 < 4, else every row fused."""
        rel = pts - self.trans.to(pts.device)
        n = rel.reshape(-1, 3).shape[0]
        if n >= 32 or (n >= 16 and n % 8 < 4):
            return self.to_local(rel)
        r = self.rot.to(rel.device)
        x, y, z = rel[..., 0:1], rel[..., 1:2], rel[..., 2:3]
        return fma_f32(z, r[2], fma_f32(y, r[1], x * r[0]))

    @property
    def origin(self) -> torch.Tensor:
        return self.trans

    def compose_matrix(self, T) -> "Projection":
        """Right-compose with a 4x4 matrix (numpy): new L2G = L2G @ T (the
        cow-lady vicon->camera extrinsic T_V_C).  Rounded as the JAX
        package's eager products: every entry of rot @ T[:3, :3] and of
        rot @ T[:3, 3] is fma(r2, t2, fma(r1, t1, r0 * t0)), then + trans
        unfused."""
        r = self.rot
        T = torch.from_numpy(np.asarray(T, np.float32)).to(r.device)

        def dot(b):  # rot @ b, b [3, k]
            return fma_f32(r[:, 2:3], b[2], fma_f32(r[:, 1:2], b[1],
                                                     r[:, 0:1] * b[0]))

        return Projection(rot=dot(T[:3, :3]),
                          trans=dot(T[:3, 3:4])[:, 0] + self.trans)

    def to(self, device) -> "Projection":
        return Projection(self.rot.to(device), self.trans.to(device))

    @staticmethod
    def identity(device=None) -> "Projection":
        return Projection(rot=torch.eye(3, dtype=torch.float32, device=device),
                          trans=torch.zeros(3, dtype=torch.float32,
                                            device=device))

    @staticmethod
    def from_pose(position, quat_wxyz) -> "Projection":
        """Build from a (3,) position and (w,x,y,z) quaternion (host-side)."""
        rot = quat_to_rot(*[float(q) for q in quat_wxyz])
        return Projection(
            rot=torch.from_numpy(rot),
            trans=torch.from_numpy(np.asarray(position, np.float32).copy()),
        )


def pos2coord(p: torch.Tensor, voxel_width: float) -> torch.Tensor:
    """Metres -> global voxel coordinate; floor(p/width + 0.5), rounded as
    the JAX package's jitted programs round it: XLA folds the division by
    the constant width into a multiply by its float32 reciprocal and fuses
    that with the + 0.5, so floor(fma(p, 1/width, 0.5))."""
    inv = torch.full_like(p, recip_f32(voxel_width))
    return torch.floor(fma_f32(p, inv, torch.full_like(p, 0.5))).to(torch.int32)


def coord2pos(c: torch.Tensor, voxel_width: float) -> torch.Tensor:
    """Global voxel coordinate -> metres of the voxel centre."""
    return c.to(torch.float32) * voxel_width


def glb2loc(c: torch.Tensor, pvt) -> torch.Tensor:
    return c - pvt


def loc2glb(c: torch.Tensor, pvt) -> torch.Tensor:
    return c + pvt


def squared_dist(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Integer squared distance between int coordinate triples (..., 3)."""
    d = (c1 - c2).to(torch.int32)
    return (d * d).sum(dim=-1, dtype=torch.int32)


def block_key_of(glb_coord: torch.Tensor) -> torch.Tensor:
    """Voxel-block key of a glb coordinate: floor division by VB_WIDTH (the
    reference's get_VB_key shift/mask trick, negatives included)."""
    return torch.div(glb_coord, 8, rounding_mode="floor")


def sub_block_index(glb_coord: torch.Tensor) -> torch.Tensor:
    """Index of a voxel inside its 8^3 block (floor modulo)."""
    return torch.remainder(glb_coord, 8)


def calculate_pivot(map_center, voxel_width, local_size):
    """Window pivot so the window is centred on the robot (numpy, host)."""
    center = np.floor(np.asarray(map_center) / voxel_width + 0.5).astype(np.int64)
    return (center - np.asarray(local_size) // 2).astype(np.int32)


def local_coord_grid(local_size, device=None) -> torch.Tensor:
    """Dense (X,Y,Z,3) int32 grid of local voxel coordinates."""
    X, Y, Z = (int(s) for s in local_size)
    axes = [torch.arange(n, dtype=torch.int32, device=device) for n in (X, Y, Z)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def inside_volume(c: torch.Tensor, size) -> torch.Tensor:
    """Boolean mask: coordinate triple within [0, size)."""
    size = torch.as_tensor(size, dtype=torch.int32, device=c.device)
    return ((c >= 0) & (c < size)).all(dim=-1)


def rot_to_quat(R):
    """3x3 rotation matrix to quaternion (w,x,y,z) (numpy, host-side; a
    copy of the JAX package's).

    Shepperd's method: picks the largest of the four squared components
    before dividing, so it is stable for every rotation."""
    R = np.asarray(R, np.float64)
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    cand = np.array([tr, R[0, 0], R[1, 1], R[2, 2]])
    k = int(np.argmax(cand))
    if k == 0:
        s = np.sqrt(1.0 + tr) * 2
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
    elif k == 1:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = [(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s,
             (R[0, 2] + R[2, 0]) / s]
    elif k == 2:
        s = np.sqrt(1.0 - R[0, 0] + R[1, 1] - R[2, 2]) * 2
        q = [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s,
             (R[1, 2] + R[2, 1]) / s]
    else:
        s = np.sqrt(1.0 - R[0, 0] - R[1, 1] + R[2, 2]) * 2
        q = [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
             (R[1, 2] + R[2, 1]) / s, 0.25 * s]
    q = np.asarray(q, np.float64)
    if q[0] < 0:
        q = -q
    return (q / np.linalg.norm(q)).astype(np.float32)
