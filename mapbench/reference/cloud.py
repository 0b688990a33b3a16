"""The projective point-cloud sensor model of the plain reference.

For the points of a frame (sensor frame) and its pose: the sensor-to-world
transform; a (theta, phi) panorama of the least range from the sensor per
bin and the count of points per bin; the points that register in each
window voxel (inside the height band); then per window voxel its bin's
least range and count, and its ray count: the registered points where
there are any, else minus the bin's count (at most 10) where the voxel
lies clear in front of the bin's nearest point, else 0.

Every float that decides a bin follows the engine's published rounding
(the JAX CPU program's): the transform's sums and fused multiply-adds,
norms as sqrt(fma(z, z, fma(y, y, x x))), voxel positions as fma(c, w,
-o), the C library's atan2f (fdlibm's s_atanf.c and e_atan2f.c, a frozen
copy below), and floor(fma(p, 1/w, 0.5)) for a point's voxel.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .floats import fma32

BIG = float(np.float32(1e30))   # a bin without a point


def _f(bits: int) -> float:
    return float(np.array(bits, np.uint32).view(np.float32))


def _atanf(x: torch.Tensor) -> torch.Tensor:
    """fdlibm's single-precision atan, elementwise."""
    one = torch.ones_like(x)
    hx = x.view(torch.int32)
    ix = hx & 0x7FFFFFFF
    ax = x.abs()
    r0 = ((ax + ax) - one) / (ax + 2.0)
    r1 = (ax - one) / (ax + one)
    r2 = (ax - 1.5) / (ax * 1.5 + one)
    r3 = torch.full_like(x, -1.0) / ax
    idn = torch.where(ix < 0x3EE00000, -1, torch.where(
        ix < 0x3F300000, 0, torch.where(ix < 0x3F980000, 1, torch.where(
            ix < 0x401C0000, 2, 3))))
    xr = torch.where(idn < 0, x, torch.where(idn == 0, r0, torch.where(
        idn == 1, r1, torch.where(idn == 2, r2, r3))))
    z = xr * xr
    w = z * z
    s1 = _f(0x3C8569D7) * w
    for c in (0x3D4BDA59, 0x3D886B35, 0x3DBA2E6E, 0x3E124925):
        s1 = (s1 + _f(c)) * w
    s1 = (s1 + _f(0x3EAAAAAB)) * z
    s2 = _f(0xBD15A221) * w
    for c in (0x3D6EF16B, 0x3D9D8795, 0x3DE38E38, 0x3E4CCCCD):
        s2 = (s2 - _f(c)) * w
    xs = (s1 + s2) * xr
    hi = torch.tensor([_f(0x3EED6338), _f(0x3F490FDA), _f(0x3F7B985E),
                       _f(0x3FC90FDA)], dtype=x.dtype, device=x.device)
    lo = torch.tensor([_f(0x31AC3769), _f(0x33222168), _f(0x33140FB4),
                       _f(0x33A22168)], dtype=x.dtype, device=x.device)
    k = idn.clamp(min=0).long()
    r = hi[k] - ((xs - lo[k]) - xr)
    out = torch.where(idn < 0, xr - xs, torch.where(hx < 0, -r, r))
    huge = torch.where(hx > 0, hi[3] + lo[3], -hi[3] - lo[3])
    out = torch.where(ix >= 0x4C000000, huge, out)
    out = torch.where(ix < 0x31000000, x, out)
    return torch.where(ix > 0x7F800000, x + x, out)


def atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """fdlibm's single-precision atan2(y, x), elementwise, finite inputs."""
    pi, pi_o_2 = _f(0x40490FDB), _f(0x3FC90FDB)
    neg_pi_lo, tiny = _f(0x33BBBD2E), _f(0x0DA24260)
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)
    d = iy - ix
    z = _atanf((y / x).abs())
    z = torch.where((hx < 0) & ((d >> 23) < -60), torch.zeros_like(z), z)
    z = torch.where(d > 0x1E7FFFFF, torch.full_like(z, pi_o_2) - _f(0x333BBD2E), z)
    zp = z + neg_pi_lo
    r = torch.where(m == 0, z, torch.where(m == 1, -z, torch.where(
        m == 2, pi - zp, zp - pi)))
    half = torch.where(hy < 0, torch.full_like(r, -pi_o_2) - tiny,
                       torch.full_like(r, tiny) + pi_o_2)
    r = torch.where(ix == 0, half, r)
    at_zero = torch.where(m <= 1, y, torch.where(
        m == 2, torch.full_like(r, pi) + tiny, torch.full_like(r, -pi) - tiny))
    r = torch.where(iy == 0, at_zero, r)
    r = torch.where(hx == 0x3F800000, _atanf(y), r)
    return torch.where((ix > 0x7F800000) | (iy > 0x7F800000), x + y, r)


def _norm3(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.sqrt(fma32(z, z, fma32(y, y, x * x)))


def _hypot(x, y):
    return torch.sqrt(fma32(x, x, y * y))


def _bin(a, shift, scale, n):
    return torch.clamp((a + shift) * scale, 0, n - 1).to(torch.int32)


def to_world(pts: torch.Tensor, rot: torch.Tensor, trans: torch.Tensor):
    """pts [N, 3] @ rot.T + trans as the engine's eager transform rounds it
    (point counts in multiples of 4096): x and y ((x r0 + y r1) + z r2),
    z fma(z, r2, fma(y, r1, x r0)), then + trans."""
    x, y, z = pts[:, 0:1], pts[:, 1:2], pts[:, 2:3]
    xy = (x * rot[:2, 0] + y * rot[:2, 1]) + z * rot[:2, 2]
    zz = fma32(z, rot[2, 2], fma32(y, rot[2, 1], x * rot[2, 0]))
    return torch.cat([xy, zz], dim=1) + trans


def bins_of(local):
    """(n_theta, n_phi): the smallest power-of-two binning that resolves a
    voxel at the longest ray (0.707 X voxels), theta 128..2048."""
    need = 2 * math.pi * 0.707 * local[0]
    nt = 1 << max(7, math.ceil(math.log2(need)))
    return min(nt, 2048), min(nt // 2, 1024)


def cloud_model(points, rot, trans, pvt, *, local, vw, min_h, max_h, low=False):
    """(inst_type int8, ray_count int32) [X, Y, Z] of a frame's points
    (float32 [N, 3], sensor frame, all valid) at window pivot pvt."""
    dev = points.device
    X, Y, Z = local
    nt, npi = bins_of(local)
    f32 = lambda v: float(np.float32(v))
    pi, tsc = f32(math.pi), f32(nt / (2 * math.pi))
    hpi, psc = f32(math.pi / 2), f32(npi / math.pi)
    max_len = f32(0.707 * X * vw)
    o = torch.from_numpy(np.asarray(trans, np.float32)).to(dev)
    r = torch.from_numpy(np.asarray(rot, np.float32)).to(dev)
    if low:
        lo_t = torch.bfloat16
        world = (points.to(lo_t) @ r.to(lo_t).T + o.to(lo_t)).float()
    else:
        world = to_world(points, r, o)
    rel = world - o
    rng = _norm3(rel)
    th = atan2f(rel[:, 1], rel[:, 0])
    ph = atan2f(rel[:, 2], _hypot(rel[:, 0], rel[:, 1]))
    b = (_bin(th, pi, tsc, nt) * npi + _bin(ph, hpi, psc, npi)).long()
    depth = torch.full((nt * npi,), BIG, dtype=torch.float32, device=dev)
    depth.scatter_reduce_(0, b, rng, reduce="amin")
    cnt = torch.zeros(nt * npi, dtype=torch.int32, device=dev)
    cnt.index_add_(0, b, torch.ones_like(b, dtype=torch.int32))
    # the registered endpoints
    inv = torch.full_like(world, f32(np.float32(1) / np.float32(vw)))
    loc = torch.floor(fma32(world, inv, torch.full_like(world, 0.5))).to(torch.int32) \
        - torch.as_tensor(np.asarray(pvt, np.int32), device=dev)
    size = torch.tensor(local, dtype=torch.int32, device=dev)
    reg = ((world[:, 2] >= min_h) & (world[:, 2] <= max_h)
           & ((loc >= 0) & (loc < size)).all(-1))
    flat = torch.where(reg, loc[:, 0] * (Y * Z) + loc[:, 1] * Z + loc[:, 2], 0).long()
    ep = torch.zeros(X * Y * Z, dtype=torch.int32, device=dev)
    ep.index_add_(0, flat, reg.to(torch.int32))
    ep = ep.reshape(X, Y, Z)
    # the carve over the window's voxels
    axes = [torch.arange(n, dtype=torch.int32, device=dev) for n in local]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    c = (grid + torch.as_tensor(np.asarray(pvt, np.int32), device=dev)).float()
    vrel = fma32(c, torch.tensor(f32(vw), device=dev), -o)
    vr = _norm3(vrel)
    vb = (_bin(atan2f(vrel[..., 1], vrel[..., 0]), pi, tsc, nt) * npi
          + _bin(atan2f(vrel[..., 2], _hypot(vrel[..., 0], vrel[..., 1])), hpi, psc, npi)).long()
    vd, vc = depth[vb], cnt[vb]
    freed = (vd < BIG) & (vr + vw < vd) & (vr <= max_len)
    rc = torch.where(ep > 0, ep, torch.where(freed, -torch.clamp(vc, max=10), 0)).to(torch.int32)
    inst = torch.where(rc > 0, 2, torch.where(rc < 0, 1, 0)).to(torch.int8)
    return inst, rc
