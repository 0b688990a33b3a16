"""The projective point-cloud sensor model's two kernels: kernel wrappers
+ plain versions.

  panorama - per point: the (theta, phi) bin's min range and ray count, and
             the registered endpoint hits per window voxel
             (gie_mapping_tpu/ops/raycast.py::pointcloud_project, lines
             83-110: XLA's scatters; no Pallas kernel);
  carve    - per window voxel: its bin's min range and ray count, and the
             sensor model's ray count and type
             (gie_mapping_tpu/ops/pallas/carve.py::panorama_select with the
             per-voxel tail of pointcloud_project, lines 113-154).
The CUDA kernels are csrc/carve.cu.

The panorama bins come from float trigonometry, so the plain version
reproduces the JAX CPU reference's rounding exactly and on every device:
XLA contracts `c * w - o` and the squares of its norms into fused
multiply-adds (utils/floats.py::fma_f32), every square root is correctly
rounded (sqrt_f32), and its atan2 is the C library's single-precision
atan2f, re-implemented here operation by operation (`atan2f_exact`;
PyTorch's own atan2 rounds differently on both CPU and GPU).
"""
from __future__ import annotations

import functools
import math
import struct
from typing import NamedTuple

import numpy as np
import torch

from ...utils.constants import VOX_FREE, VOX_OCCUPIED, VOX_UNKNOWN
from ...utils.floats import fma_f32, recip_f32, sqrt_f32
from ...utils import geometry as geo
from . import _build

BIG_DEPTH = 1e30  # "no ray in this bin" sentinel of the depth panorama
# the launch arguments of gie_panorama and gie_carve, packed into one buffer
# (csrc/carve.cu's PanoramaCall and CarveCall): the pointers and the
# stream, the frame's pivot and origin (per call), then the config's values
# (cached)
_PANORAMA_CALL = struct.Struct("<6Q4i3f")
_PANORAMA_CONFIG = struct.Struct("<3i4f2i4f")
_CARVE_CALL = struct.Struct("<6Q3i3f")
_CARVE_CONFIG = struct.Struct("<3i3f4i4f")


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


class CarveConsts(NamedTuple):
    """The float32 constants of the bin and freed tests (Python floats)."""
    pi: float
    theta_scale: float
    half_pi: float
    phi_scale: float
    max_length: float
    big: float


def carve_consts(n_theta, n_phi, local_size, voxel_width) -> CarveConsts:
    return _carve_consts(int(n_theta), int(n_phi), int(local_size[0]),
                         float(voxel_width))


@functools.lru_cache(maxsize=64)
def _carve_consts(n_theta, n_phi, X, voxel_width):
    f32 = lambda v: float(np.float32(v))
    return CarveConsts(pi=f32(math.pi), theta_scale=f32(n_theta / (2 * math.pi)),
                       half_pi=f32(math.pi / 2), phi_scale=f32(n_phi / math.pi),
                       max_length=f32(0.707 * X * voxel_width),
                       big=f32(BIG_DEPTH))


def panorama_plain(points, valid, origin, pvt, *, local_size, voxel_width,
                   ogm_min_h, ogm_max_h, n_theta, n_phi):
    """Plain version of `panorama` (same arguments and results)."""
    X, Y, Z = local_size
    dev = points.device
    k = carve_consts(n_theta, n_phi, local_size, voxel_width)
    # the min-depth panorama
    rel = points - torch.as_tensor(np.asarray(origin, np.float32), device=dev)
    r = norm3_f32(rel)
    theta = atan2f_exact(rel[:, 1], rel[:, 0])
    phi = atan2f_exact(rel[:, 2], hypot2_f32(rel[:, 0], rel[:, 1]))
    bt = bin_index(theta, k.pi, k.theta_scale, n_theta)
    bp = bin_index(phi, k.half_pi, k.phi_scale, n_phi)
    bin_id = torch.where(valid, bt * n_phi + bp, 0).long()
    depth = torch.full((n_theta * n_phi,), k.big, dtype=torch.float32, device=dev)
    depth.scatter_reduce_(0, bin_id, torch.where(valid, r, k.big), reduce="amin")
    cnt = torch.zeros(n_theta * n_phi, dtype=torch.int32, device=dev)
    cnt.index_add_(0, bin_id, valid.to(torch.int32))
    # the registered endpoints
    loc = geo.pos2coord(points, voxel_width) - torch.as_tensor(
        np.asarray(pvt, np.int32), device=dev)
    hgt_ok = (points[:, 2] >= ogm_min_h) & (points[:, 2] <= ogm_max_h)
    reg = valid & hgt_ok & geo.inside_volume(loc, local_size)
    flat = loc[:, 0] * (Y * Z) + loc[:, 1] * Z + loc[:, 2]
    flat = torch.where(reg, flat, 0).long()
    ep = torch.zeros(X * Y * Z, dtype=torch.int32, device=dev)
    ep.index_add_(0, flat, reg.to(torch.int32))
    return (depth.reshape(n_theta, n_phi), cnt.reshape(n_theta, n_phi),
            ep.reshape(X, Y, Z))


def panorama(points, valid, origin, pvt, *, local_size, voxel_width,
             ogm_min_h, ogm_max_h, n_theta, n_phi):
    """Per (theta, phi) bin of the valid points: their min range from the
    sensor origin and their count; per window voxel: the valid points that
    register there (inside the height band [ogm_min_h, ogm_max_h]).

    points float32 [N, 3] world frame; valid bool [N]; origin (3,) float32
    sensor origin and pvt (3,) ints window pivot (host values).  Returns
    (depth f32 [n_theta, n_phi], cnt int32 [n_theta, n_phi], endpoint_cnt
    int32 [X, Y, Z]); a bin without a point holds BIG_DEPTH.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    X, Y, Z = (int(s) for s in local_size)
    n = points.shape[0]
    if points.dtype != torch.float32 or tuple(points.shape) != (n, 3) \
            or valid.dtype != torch.bool or tuple(valid.shape) != (n,):
        raise TypeError("panorama wants points float32 [N, 3] and valid bool [N]")
    dev = points.device
    if valid.device != dev:
        raise ValueError("panorama: points and valid on different devices")
    if dev.type == "cpu":
        return panorama_plain(points, valid, origin, pvt, local_size=(X, Y, Z),
                              voxel_width=voxel_width, ogm_min_h=ogm_min_h,
                              ogm_max_h=ogm_max_h, n_theta=n_theta, n_phi=n_phi)
    if dev.type != "cuda":
        raise ValueError(f"panorama: unsupported device {dev}")
    if 3 * n >= 1 << 31 or X * Y * Z >= 1 << 31:
        raise ValueError("panorama: the kernel indexes points and voxels in int32")
    pts, val = points.contiguous(), valid.contiguous()
    depth = torch.empty((n_theta, n_phi), dtype=torch.float32, device=dev)
    cnt = torch.empty((n_theta, n_phi), dtype=torch.int32, device=dev)
    ep = torch.empty((X, Y, Z), dtype=torch.int32, device=dev)
    args = _PANORAMA_CALL.pack(
        pts.data_ptr(), val.data_ptr(), depth.data_ptr(), cnt.data_ptr(),
        ep.data_ptr(), _build.stream_of(pts), n, *_host_ints(pvt),
        *_host_floats(origin)) + _panorama_config(
            X, Y, Z, n_theta, n_phi, float(voxel_width), float(ogm_min_h),
            float(ogm_max_h))
    with _build.on_device_of(pts):
        rc = _build.fn("gie_panorama")(args, len(args))
    panorama.launches += 1
    _build.check("gie_panorama", rc)
    return depth, cnt, ep


@functools.lru_cache(maxsize=64)
def _panorama_config(X, Y, Z, n_theta, n_phi, voxel_width, ogm_min_h,
                     ogm_max_h) -> bytes:
    k = carve_consts(n_theta, n_phi, (X, Y, Z), voxel_width)
    return _PANORAMA_CONFIG.pack(X, Y, Z, recip_f32(voxel_width), ogm_min_h,
                                 ogm_max_h,
                                 k.big, n_theta, n_phi, k.pi, k.theta_scale,
                                 k.half_pi, k.phi_scale)


@functools.lru_cache(maxsize=64)
def _carve_config(X, Y, Z, voxel_width, for_motion_planner, robot_r2_grids,
                  n_theta, n_phi) -> bytes:
    k = carve_consts(n_theta, n_phi, (X, Y, Z), voxel_width)
    return _CARVE_CONFIG.pack(X, Y, Z, voxel_width, k.max_length, k.big,
                              int(for_motion_planner), int(robot_r2_grids),
                              n_theta, n_phi, k.pi, k.theta_scale, k.half_pi,
                              k.phi_scale)


def _host_ints(v):
    """The three Python ints of a host vector (numpy array or sequence)."""
    a, b, c = np.asarray(v).tolist()
    return int(a), int(b), int(c)


def _host_floats(v):
    """The three Python floats of a host vector, each rounded to float32."""
    return np.asarray(v, np.float32).tolist()


def voxel_bins(pvt, origin, *, local_size, voxel_width, n_theta, n_phi,
               device=None):
    """Per window voxel: range from the sensor origin and (theta, phi)
    panorama bin.  Returns (vr f32, vbt int32, vbp int32) [X, Y, Z]."""
    k = carve_consts(n_theta, n_phi, local_size, voxel_width)
    c = (geo.local_coord_grid(local_size, device)
         + torch.as_tensor(np.asarray(pvt, np.int32), device=device)).float()
    o = torch.as_tensor(np.asarray(origin, np.float32), device=device)
    vw = torch.tensor(float(np.float32(voxel_width)), device=device)
    vrel = fma_f32(c, vw, -o)
    vr = norm3_f32(vrel)
    vtheta = atan2f_exact(vrel[..., 1], vrel[..., 0])
    vrho = hypot2_f32(vrel[..., 0], vrel[..., 1])
    vphi = atan2f_exact(vrel[..., 2], vrho)
    return (vr, bin_index(vtheta, k.pi, k.theta_scale, n_theta),
            bin_index(vphi, k.half_pi, k.phi_scale, n_phi))


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
    freed = ((vdepth < k.big) & (vr + voxel_width < vdepth)
             & (vr <= k.max_length))
    ray_count = torch.where(endpoint_cnt > 0, endpoint_cnt, torch.where(
        freed, -torch.clamp(vcnt, max=10), 0)).to(torch.int32)
    if for_motion_planner:
        half = torch.tensor([s // 2 for s in local_size], dtype=torch.int32,
                            device=dev)
        d = geo.local_coord_grid(local_size, dev) - half
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
    X, Y, Z = (int(s) for s in local_size)
    if depth.dtype != torch.float32 or cnt.dtype != torch.int32 \
            or endpoint_cnt.dtype != torch.int32:
        raise TypeError("carve wants depth f32, cnt and endpoint_cnt int32")
    if depth.numel() != n_theta * n_phi or cnt.numel() != n_theta * n_phi:
        raise ValueError("panorama size does not match (n_theta, n_phi)")
    if tuple(endpoint_cnt.shape) != (X, Y, Z):
        raise ValueError("endpoint_cnt must be shaped like the window")
    dev = depth.device
    if cnt.device != dev or endpoint_cnt.device != dev:
        raise ValueError("carve: depth, cnt and endpoint_cnt on different devices")
    if dev.type == "cpu":
        return carve_plain(depth, cnt, endpoint_cnt, pvt, origin,
                           local_size=(X, Y, Z), voxel_width=voxel_width,
                           n_theta=n_theta, n_phi=n_phi,
                           for_motion_planner=for_motion_planner,
                           robot_r2_grids=robot_r2_grids)
    if dev.type != "cuda":
        raise ValueError(f"carve: unsupported device {dev}")
    if X * Y * Z >= 1 << 31:
        raise ValueError("carve: the kernel indexes voxels in int32")
    d, c, e = depth.contiguous(), cnt.contiguous(), endpoint_cnt.contiguous()
    inst = torch.empty((X, Y, Z), dtype=torch.int8, device=dev)
    rc_out = torch.empty((X, Y, Z), dtype=torch.int32, device=dev)
    args = _CARVE_CALL.pack(
        d.data_ptr(), c.data_ptr(), e.data_ptr(), inst.data_ptr(),
        rc_out.data_ptr(), _build.stream_of(d), *_host_ints(pvt),
        *_host_floats(origin)) + _carve_config(
            X, Y, Z, float(voxel_width), bool(for_motion_planner),
            int(robot_r2_grids), n_theta, n_phi)
    with _build.on_device_of(d):
        rc = _build.fn("gie_carve")(args, len(args))
    carve.launches += 1
    _build.check("gie_carve", rc)
    return inst, rc_out


panorama.launches = 0
carve.launches = 0
