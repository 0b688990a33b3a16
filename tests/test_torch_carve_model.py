"""The point-cloud sensor model's kernels (csrc/carve.cu), step for step in
numpy, against the port's plain versions (ops/kernels/carve.py), bit for
bit:

  * the branchless atanf / atan2f of csrc/common.cuh against atan2f_exact
    (itself held against XLA's atan2 by test_torch_raycast.py);
  * gie_carve's column-factored voxel pass (per column of a CTA's run of
    voxels: q, the planar range, the theta bin; per voxel: its range and
    phi bin, then the tail) against voxel_bins and carve_plain;
  * gie_panorama's point pass (per point: bins, an atomic min and add on
    the tables, the endpoint voxel) against panorama_plain.

numpy's float32 operations round once each, as the kernels' explicitly
rounded intrinsics do; the fused multiply-adds are _fma below.  The cases
are tests/test_torch_carve_cases.py's, which the GPU tests and
chip_smoke.py also run."""
import numpy as np
import pytest
import torch

from gie_mapping_tpu_torch.ops.kernels import carve as kc
from test_torch_carve_cases import (POINTS, WINDOWS, atan_args, points, tables,
                                    window)

F = np.float32
CARVE_RUN = 512  # csrc/carve.cu kCarveRun: the voxels of one CTA


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _fma(a, b, c):
    """float32 fma(a, b, c) (one rounding): the float64 product is exact,
    and the exact error of the float64 sum settles a sum halfway between
    two floats."""
    a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
    p = a.astype(np.float64) * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    f = s.astype(np.float32)
    up = np.nextafter(f, F(np.inf))
    dn = np.nextafter(f, F(-np.inf))
    half_up = s == (f.astype(np.float64) + up) / 2
    half_dn = s == (f.astype(np.float64) + dn) / 2
    return np.where(half_up & (err > 0), up, np.where(half_dn & (err < 0), dn, f))


def _c(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def atanf_model(x):
    """gie::atanf_exact: every range's quotient formed, one selected, one
    division; atan(hi) and atan(lo) selected."""
    x = np.asarray(x, np.float32)
    hx = x.view(np.int32)
    ix = hx & 0x7FFFFFFF
    ax = np.abs(x)
    r_m1, r0 = ix < 0x3EE00000, ix < 0x3F300000
    r1, r2 = ix < 0x3F980000, ix < 0x401C0000
    with np.errstate(all="ignore"):
        num = np.where(r_m1, x, np.where(r0, (ax + ax) - F(1), np.where(
            r1, ax - F(1), np.where(r2, ax - F(1.5), F(-1)))))
        den = np.where(r_m1, F(1), np.where(r0, ax + F(2), np.where(
            r1, ax + F(1), np.where(r2, ax * F(1.5) + F(1), ax))))
        xr = num / den
        z = xr * xr
        w = z * z
        s1 = _c(0x3C8569D7) * w
        for c in (0x3D4BDA59, 0x3D886B35, 0x3DBA2E6E, 0x3E124925):
            s1 = (s1 + _c(c)) * w
        s1 = (s1 + _c(0x3EAAAAAB)) * z
        s2 = _c(0xBD15A221) * w
        for c in (0x3D6EF16B, 0x3D9D8795, 0x3DE38E38, 0x3E4CCCCD):
            s2 = (s2 - _c(c)) * w
        xs = (s1 + s2) * xr
        hi = _c(np.where(r0, 0x3EED6338, np.where(r1, 0x3F490FDA, np.where(
            r2, 0x3F7B985E, 0x3FC90FDA))).astype(np.uint32))
        lo = _c(np.where(r0, 0x31AC3769, np.where(r1, 0x33222168, np.where(
            r2, 0x33140FB4, 0x33A22168))).astype(np.uint32))
        r = hi - ((xs - lo) - xr)
        h3, l3 = _c(0x3FC90FDA), _c(0x33A22168)
        huge = np.where(ix > 0x7F800000, x + x, np.where(hx > 0, h3 + l3, -h3 - l3))
        return np.where(ix >= 0x4C000000, huge, np.where(
            ix < 0x31000000, x, np.where(r_m1, xr - xs, np.where(hx < 0, -r, r))))


def atan2f_model(y, x):
    """gie::atan2f_exact with atanf_model: its special cases as selects."""
    y, x = np.asarray(y, np.float32), np.asarray(x, np.float32)
    pi, pi_o_2, pi_o_4 = _c(0x40490FDB), _c(0x3FC90FDB), _c(0x3F490FDB)
    neg_pi_lo, tiny = _c(0x33BBBD2E), _c(0x0DA24260)
    hx, hy = x.view(np.int32), y.view(np.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)
    d = iy - ix
    with np.errstate(all="ignore"):
        z = atanf_model(np.abs(y / x))
        z = np.where((hx < 0) & ((d >> 23) < -60), F(0), z)
        z = np.where(d > 0x1E7FFFFF, pi_o_2 - _c(0x333BBD2E), z)
        r = np.where(m == 0, z, np.where(m == 1, -z, np.where(
            m == 2, pi - (z + neg_pi_lo), (z + neg_pi_lo) - pi)))
        inf_x = np.select([m == 0, m == 1, m == 2],
                          [F(0), F(-0.0), pi + tiny], -pi - tiny)
        inf_xy = np.select([m == 0, m == 1, m == 2],
                           [tiny + pi_o_4, -pi_o_4 - tiny, F(3) * pi_o_4 + tiny],
                           F(-3) * pi_o_4 - tiny)
        half = np.where(hy < 0, -pi_o_2 - tiny, tiny + pi_o_2)
        r = np.where(iy == 0x7F800000, half, r)
        r = np.where(ix == 0x7F800000, np.where(iy == 0x7F800000, inf_xy, inf_x), r)
        r = np.where(ix == 0, half, r)
        r = np.where(iy == 0, np.where(m <= 1, y, np.where(m == 2, pi + tiny,
                                                          -pi - tiny)), r)
        r = np.where(hx == 0x3F800000, atanf_model(y), r)
        return np.where((ix > 0x7F800000) | (iy > 0x7F800000), x + y, r)


def _bin(a, shift, scale, n):
    v = (np.asarray(a, np.float32) + F(shift)) * F(scale)
    return np.minimum(np.maximum(v, F(0)), F(n - 1)).astype(np.int32)


def test_branchless_atan2f_matches_atan2f_exact():
    y, x = atan_args()
    got = atan2f_model(y, x)
    want = kc.atan2f_exact(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # atanf's five argument ranges are all exercised, and its own edge
    # values (the range bounds, 2^25 and 2^-29) match too
    with np.errstate(all="ignore"):
        q = np.abs(y / np.where(x == 0, F(1), x))
    assert all(((q >= lo) & (q < hi)).sum() > 1000 for lo, hi in
               ((0, 0.4375), (0.4375, 0.6875), (0.6875, 1.1875),
                (1.1875, 2.4375), (2.4375, np.inf)))
    e = np.asarray([2.0 ** 25, 2.0 ** 25 * 0.99, 2.0 ** -29, 2.0 ** -29 * 1.01,
                    0.4375, 0.6875, 1.1875, 2.4375, np.inf, 7.0], np.float32)
    e = np.concatenate([e, -e, np.nextafter(e, F(0))])
    np.testing.assert_array_equal(
        _bits(atanf_model(e)), _bits(kc._atanf_exact(torch.from_numpy(e)).numpy()))


def carve_voxel_model(win, depth, cnt, ep, for_motion_planner, robot_r2):
    """gie_carve, CTA by CTA: the columns a CTA's run touches, their shared
    values, then each voxel.  Returns (vr, bin, inst_type, ray_count)
    [X, Y, Z]."""
    X, Y, Z = win["local_size"]
    w = F(win["voxel_width"])
    ox, oy, oz = win["origin"]
    px, py, pz = (int(v) for v in win["pvt"])
    k = kc.carve_consts(win["n_theta"], win["n_phi"], win["local_size"], w)
    n = X * Y * Z
    v = np.arange(n)
    v0 = v // CARVE_RUN * CARVE_RUN
    c0 = v0 // Z
    ncols = (np.minimum(v0 + CARVE_RUN, n) - 1) // Z - c0 + 1
    col = v // Z
    t = col - c0
    assert (ncols <= CARVE_RUN).all() and (t >= 0).all() and (t < ncols).all()
    # the column pass (shared memory), once per column
    cols = np.arange(X * Y)
    rx = _fma(F(1) * (cols // Y + px), w, -ox)
    ry = _fma(F(1) * (cols % Y + py), w, -oy)
    q = _fma(ry, ry, rx * rx)
    rho = np.sqrt(_fma(rx, rx, ry * ry))
    bt = _bin(atan2f_model(ry, rx), k.pi, k.theta_scale, win["n_theta"])
    # the voxel pass
    z = v - col * Z
    rz = _fma(F(1) * (z + pz), w, -oz)
    vr = np.sqrt(_fma(rz, rz, q[col]))
    bp = _bin(atan2f_model(rz, rho[col]), k.half_pi, k.phi_scale, win["n_phi"])
    b = bt[col] * win["n_phi"] + bp
    vdepth, vcnt = depth.reshape(-1)[b], cnt.reshape(-1)[b]
    freed = (vdepth < F(k.big)) & (vr + w < vdepth) & (vr <= F(k.max_length))
    e = ep.reshape(-1)
    rc = np.where(e > 0, e, np.where(freed, -np.minimum(vcnt, 10), 0))
    if for_motion_planner:
        dx, dy, dz = col // Y - X // 2, col % Y - Y // 2, z - Z // 2
        rc = np.where(dx * dx + dy * dy + dz * dz <= robot_r2, -1, rc)
    inst = np.where(rc > 0, 2, np.where(rc < 0, 1, 0)).astype(np.int8)
    s = (X, Y, Z)
    return vr.reshape(s), b.reshape(s), inst.reshape(s), rc.astype(np.int32).reshape(s)


@pytest.mark.parametrize("name", WINDOWS)
def test_voxel_pass_model_matches_plain(name):
    win = window(name)
    nt, np_ = win["n_theta"], win["n_phi"]
    kw = dict(local_size=win["local_size"], voxel_width=win["voxel_width"],
              n_theta=nt, n_phi=np_)
    vr, vbt, vbp = kc.voxel_bins(win["pvt"], win["origin"], **kw)
    depth, cnt, ep = tables(name)
    assert (depth == F(kc.BIG_DEPTH)).any()
    fmp = name.endswith("_off")
    m_vr, m_bin, m_inst, m_rc = carve_voxel_model(win, depth, cnt, ep, fmp, 16)
    np.testing.assert_array_equal(_bits(m_vr), _bits(vr.numpy()))
    np.testing.assert_array_equal(m_bin, (vbt * np_ + vbp).numpy())
    inst, rc = kc.carve_plain(torch.from_numpy(depth), torch.from_numpy(cnt),
                              torch.from_numpy(ep), win["pvt"], win["origin"],
                              for_motion_planner=fmp, robot_r2_grids=16, **kw)
    np.testing.assert_array_equal(m_inst, inst.numpy())
    np.testing.assert_array_equal(m_rc, rc.numpy())
    assert (m_rc > 0).any() and (m_rc < 0).any() and (m_rc == 0).any()


def panorama_model(case):
    """gie_panorama, point by point: the bin, an atomic min on the depth
    bits (the float order of ranges >= +0) and an atomic add on the count,
    then the endpoint voxel.  Returns (depth, cnt, endpoint_cnt)."""
    X, Y, Z = case["local_size"]
    nt, np_ = case["n_theta"], case["n_phi"]
    k = kc.carve_consts(nt, np_, case["local_size"], case["voxel_width"])
    p = case["points"][case["valid"]]
    rx, ry, rz = (p[:, i] - case["origin"][i] for i in range(3))
    r = np.sqrt(_fma(rz, rz, _fma(ry, ry, rx * rx)))
    assert (r.view(np.int32) >= 0).all()  # the int order is the float order
    bt = _bin(atan2f_model(ry, rx), k.pi, k.theta_scale, nt)
    bp = _bin(atan2f_model(rz, np.sqrt(_fma(rx, rx, ry * ry))), k.half_pi,
              k.phi_scale, np_)
    b = bt * np_ + bp
    depth_bits = np.full(nt * np_, F(k.big)).view(np.int32)
    np.minimum.at(depth_bits, b, r.view(np.int32))
    cnt = np.zeros(nt * np_, np.int32)
    np.add.at(cnt, b, 1)
    w = F(case["voxel_width"])
    loc = np.floor(_fma(p, F(1) / w, F(0.5))).astype(np.int32) - case["pvt"]
    reg = ((p[:, 2] >= F(case["ogm_min_h"])) & (p[:, 2] <= F(case["ogm_max_h"]))
           & (loc >= 0).all(1) & (loc < np.asarray([X, Y, Z])).all(1))
    ep = np.zeros(X * Y * Z, np.int32)
    l = loc[reg]
    np.add.at(ep, (l[:, 0] * Y + l[:, 1]) * Z + l[:, 2], 1)
    return (depth_bits.view(np.float32).reshape(nt, np_), cnt.reshape(nt, np_),
            ep.reshape(X, Y, Z))


@pytest.mark.parametrize("name", POINTS)
def test_point_pass_model_matches_plain(name):
    case = points(name)
    want = kc.panorama_plain(
        torch.from_numpy(case["points"]), torch.from_numpy(case["valid"]),
        case["origin"], case["pvt"], local_size=case["local_size"],
        voxel_width=case["voxel_width"], ogm_min_h=case["ogm_min_h"],
        ogm_max_h=case["ogm_max_h"], n_theta=case["n_theta"], n_phi=case["n_phi"])
    got = panorama_model(case)
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0].numpy()))
    np.testing.assert_array_equal(got[1], want[1].numpy())
    np.testing.assert_array_equal(got[2], want[2].numpy())
    # the case has what it claims: bins with several points, registered
    # endpoints, and valid points that do not register
    assert (got[1] > 1).any() and got[2].sum() > 0
    assert got[2].sum() < case["valid"].sum()
