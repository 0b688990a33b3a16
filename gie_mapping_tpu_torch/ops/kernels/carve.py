"""Projective free-space carve (per-voxel panorama lookup + sensor model):
kernel wrapper + plain version.

Counterpart of gie_mapping_tpu/ops/pallas/carve.py::panorama_select together
with the per-voxel tail of gie_mapping_tpu/ops/raycast.py::pointcloud_project
(lines 113-154), which the CUDA kernel csrc/carve.cu fuses.

The panorama bins come from float trigonometry, so the plain version
reproduces the JAX CPU reference's rounding exactly and on every device:
XLA contracts `c * w - o` and the squares of its norms into fused
multiply-adds (utils/floats.py::fma_f32), every square root is correctly
rounded (sqrt_f32), and its atan2 is the C library's single-precision
atan2f, re-implemented here operation by operation (`atan2f_exact`;
PyTorch's own atan2 rounds differently on both CPU and GPU).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...utils.constants import VOX_FREE, VOX_OCCUPIED, VOX_UNKNOWN
from ...utils.floats import fma_f32, sqrt_f32
from ...utils.geometry import local_coord_grid
from . import _build

BIG_DEPTH = 1e30  # "no ray in this bin" sentinel of the depth panorama


def _f(bits: int) -> float:
    return float(np.array(bits, np.uint32).view(np.float32))


def _atanf_exact(x: torch.Tensor) -> torch.Tensor:
    """C-library single-precision atan (fdlibm s_atanf.c), elementwise."""
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


def atan2f_exact(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """C-library single-precision atan2(y, x) (fdlibm e_atan2f.c),
    elementwise, for finite inputs (the carve never sees infinities)."""
    pi, pi_o_2 = _f(0x40490FDB), _f(0x3FC90FDB)
    neg_pi_lo, tiny = _f(0x33BBBD2E), _f(0x0DA24260)
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)
    d = iy - ix
    z = _atanf_exact((y / x).abs())
    z = torch.where((hx < 0) & ((d >> 23) < -60), torch.zeros_like(z), z)
    z = torch.where(d > 0x1E7FFFFF, torch.full_like(z, pi_o_2)
                    - _f(0x333BBD2E), z)
    zp = z + neg_pi_lo
    r = torch.where(m == 0, z, torch.where(m == 1, -z, torch.where(
        m == 2, pi - zp, zp - pi)))
    half = torch.where(hy < 0, torch.full_like(r, -pi_o_2) - tiny,
                       torch.full_like(r, tiny) + pi_o_2)
    r = torch.where(ix == 0, half, r)
    at_zero = torch.where(m <= 1, y, torch.where(
        m == 2, torch.full_like(r, pi) + tiny, torch.full_like(r, -pi) - tiny))
    r = torch.where(iy == 0, at_zero, r)
    r = torch.where(hx == 0x3F800000, _atanf_exact(y), r)
    return torch.where((ix > 0x7F800000) | (iy > 0x7F800000), x + y, r)


def norm3_f32(v: torch.Tensor) -> torch.Tensor:
    """|v| of [..., 3] rounded as XLA's CPU norm: sqrt(fma(z,z,fma(y,y,x*x)))."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return sqrt_f32(fma_f32(z, z, fma_f32(y, y, x * x)))


def hypot2_f32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sqrt(x**2 + y**2) rounded as XLA's CPU fusion: sqrt(fma(x,x,y*y))."""
    return sqrt_f32(fma_f32(x, x, y * y))


def bin_index(a: torch.Tensor, shift: float, scale: float, n: int):
    """trunc(clip((a + shift) * scale, 0, n - 1)) as int32."""
    return torch.clamp((a + shift) * scale, 0, n - 1).to(torch.int32)


def carve_consts(n_theta, n_phi, local_size, voxel_width):
    """The float32 constants of the bin and freed tests (Python floats)."""
    f32 = lambda v: float(np.float32(v))
    return dict(pi=f32(math.pi), theta_scale=f32(n_theta / (2 * math.pi)),
                half_pi=f32(math.pi / 2), phi_scale=f32(n_phi / math.pi),
                max_length=f32(0.707 * local_size[0] * voxel_width),
                big=f32(BIG_DEPTH))


def voxel_bins(pvt, origin, *, local_size, voxel_width, n_theta, n_phi,
               device=None):
    """Per window voxel: range from the sensor origin and (theta, phi)
    panorama bin.  Returns (vr f32, vbt int32, vbp int32) [X, Y, Z]."""
    k = carve_consts(n_theta, n_phi, local_size, voxel_width)
    c = (local_coord_grid(local_size, device)
         + torch.as_tensor(np.asarray(pvt, np.int32), device=device)).float()
    o = torch.as_tensor(np.asarray(origin, np.float32), device=device)
    vw = torch.tensor(float(np.float32(voxel_width)), device=device)
    vrel = fma_f32(c, vw, -o)
    vr = norm3_f32(vrel)
    vtheta = atan2f_exact(vrel[..., 1], vrel[..., 0])
    vrho = hypot2_f32(vrel[..., 0], vrel[..., 1])
    vphi = atan2f_exact(vrel[..., 2], vrho)
    return (vr, bin_index(vtheta, k["pi"], k["theta_scale"], n_theta),
            bin_index(vphi, k["half_pi"], k["phi_scale"], n_phi))


def carve_plain(depth, cnt, endpoint_cnt, pvt, origin, *, local_size,
                voxel_width, n_theta, n_phi, for_motion_planner,
                robot_r2_grids):
    """Plain version of `carve` (same arguments and results)."""
    dev = depth.device
    k = carve_consts(n_theta, n_phi, local_size, voxel_width)
    vr, vbt, vbp = voxel_bins(pvt, origin, local_size=local_size,
                              voxel_width=voxel_width, n_theta=n_theta,
                              n_phi=n_phi, device=dev)
    vbin = (vbt * n_phi + vbp).long()
    vdepth = depth.reshape(-1)[vbin]
    vcnt = cnt.reshape(-1)[vbin]
    freed = ((vdepth < k["big"]) & (vr + voxel_width < vdepth)
             & (vr <= k["max_length"]))
    ray_count = torch.where(endpoint_cnt > 0, endpoint_cnt, torch.where(
        freed, -torch.clamp(vcnt, max=10), 0)).to(torch.int32)
    if for_motion_planner:
        half = torch.tensor([s // 2 for s in local_size], dtype=torch.int32,
                            device=dev)
        d = local_coord_grid(local_size, dev) - half
        sphere = (d * d).sum(-1) <= robot_r2_grids
        ray_count = torch.where(sphere, -1, ray_count).to(torch.int32)
    inst_type = torch.where(ray_count > 0, VOX_OCCUPIED, torch.where(
        ray_count < 0, VOX_FREE, VOX_UNKNOWN)).to(torch.int8)
    return inst_type, ray_count


def carve(depth, cnt, endpoint_cnt, pvt, origin, *, local_size, voxel_width,
          n_theta, n_phi, for_motion_planner, robot_r2_grids):
    """Per window voxel: its panorama bin, min depth and ray count, and the
    resulting sensor-model ray count and type.

    depth f32 / cnt int32 [n_theta, n_phi] panorama; endpoint_cnt int32
    [X, Y, Z] registered endpoint hits; pvt (3,) ints window pivot; origin
    (3,) float32 sensor origin (host values).  Returns (inst_type int8,
    ray_count int32) [X, Y, Z].

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    kw = dict(local_size=tuple(local_size), voxel_width=voxel_width,
              n_theta=n_theta, n_phi=n_phi,
              for_motion_planner=for_motion_planner,
              robot_r2_grids=robot_r2_grids)
    if depth.dtype != torch.float32 or cnt.dtype != torch.int32 \
            or endpoint_cnt.dtype != torch.int32:
        raise TypeError("carve wants depth f32, cnt and endpoint_cnt int32")
    if depth.numel() != n_theta * n_phi or cnt.numel() != n_theta * n_phi:
        raise ValueError("panorama size does not match (n_theta, n_phi)")
    if tuple(endpoint_cnt.shape) != tuple(local_size):
        raise ValueError("endpoint_cnt must be shaped like the window")
    dev = depth.device
    if cnt.device != dev or endpoint_cnt.device != dev:
        raise ValueError("carve: depth, cnt and endpoint_cnt on different devices")
    if dev.type == "cpu":
        return carve_plain(depth, cnt, endpoint_cnt, pvt, origin, **kw)
    if dev.type != "cuda":
        raise ValueError(f"carve: unsupported device {dev}")
    X, Y, Z = (int(s) for s in local_size)
    d = depth.contiguous()
    c = cnt.contiguous()
    e = endpoint_cnt.contiguous()
    inst = torch.empty((X, Y, Z), dtype=torch.int8, device=dev)
    rc_out = torch.empty((X, Y, Z), dtype=torch.int32, device=dev)
    k = carve_consts(n_theta, n_phi, local_size, voxel_width)
    p = [int(v) for v in np.asarray(pvt).reshape(3)]
    o = [float(v) for v in np.asarray(origin, np.float32).reshape(3)]
    rc = _build.fn("gie_carve")(
        d.data_ptr(), c.data_ptr(), e.data_ptr(), inst.data_ptr(),
        rc_out.data_ptr(), X, Y, Z, *p, *o, float(np.float32(voxel_width)),
        n_theta, n_phi, k["pi"], k["theta_scale"], k["half_pi"],
        k["phi_scale"], k["max_length"], k["big"], int(for_motion_planner),
        int(robot_r2_grids), _build.stream_of(d))
    carve.launches += 1
    _build.check("gie_carve", rc)
    return inst, rc_out


carve.launches = 0
