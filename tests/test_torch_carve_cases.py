"""Edge cases of the point-cloud sensor model's kernels (csrc/carve.cu):
numpy only, no tests of its own.  tests/test_torch_carve_model.py holds the
kernels' numpy models on them, tests/test_torch_cuda.py and chip_smoke.py
the kernels on the card.

  atan_args()      - (y, x) float32 operands of atan2f: random, the phi
                     domain, special values, and points in each of the
                     five argument ranges of atanf;
  WINDOWS, window  - the voxel pass's windows: the three of
                     test_torch_raycast.py and the ugv_corridor preset's
                     200x200x24 (0.05 m voxels, panorama 1024x512);
  tables           - panorama tables and endpoint counts for a window:
                     empty, near and far bins, counts above 10;
  POINTS, points   - point clouds for the point pass: invalid points,
                     points outside the height band or the window, several
                     points in one bin, a point at the origin, and points
                     on the window's faces.
"""
import math

import numpy as np

# name: (local_size, voxel_width, sensor position)
_WINDOWS = {
    "40x40x16": ((40, 40, 16), 0.1, (0.0, 0.0, 1.2)),
    "40x40x16_off": ((40, 40, 16), 0.1, (0.37, -0.81, 1.13)),
    "100x100x30": ((100, 100, 30), 0.1, (-1.05, 0.55, 0.9)),
    "200x200x24_ugv": ((200, 200, 24), 0.05, (0.61, -0.33, 0.45)),
}
WINDOWS = list(_WINDOWS)
POINTS = ["cloud_40", "cloud_100", "edges_40", "ugv_200"]


def panorama_bins(local_size):
    """The sensor model's (n_theta, n_phi) (ops/raycast.py::panorama_bins)."""
    need = 2 * math.pi * 0.707 * local_size[0]
    n_theta = 1 << max(7, math.ceil(math.log2(need)))
    return min(n_theta, 2048), min(n_theta // 2, 1024)


def pivot(origin, voxel_width, local_size):
    """The window pivot centred on the sensor (geometry.calculate_pivot)."""
    c = np.floor(np.asarray(origin) / voxel_width + 0.5).astype(np.int64)
    return (c - np.asarray(local_size) // 2).astype(np.int32)


def window(name):
    """dict(local_size, voxel_width, origin float32 (3,), pvt int32 (3,),
    n_theta, n_phi) of a window case."""
    local, w, pos = _WINDOWS[name]
    origin = np.asarray(pos, np.float32)
    nt, np_ = panorama_bins(local)
    return dict(local_size=local, voxel_width=w, origin=origin,
                pvt=pivot(origin, w, local), n_theta=nt, n_phi=np_)


def tables(name):
    """(depth f32 [n_theta, n_phi], cnt int32 [n_theta, n_phi], endpoint_cnt
    int32 [X, Y, Z]) for window `name`: 30 % of the bins empty (BIG_DEPTH),
    the others 0.05-6 m, counts 0-24, 2 % of the voxels with endpoints."""
    win = window(name)
    rng = np.random.default_rng(WINDOWS.index(name))
    shape = (win["n_theta"], win["n_phi"])
    depth = rng.uniform(0.05, 6.0, shape).astype(np.float32)
    depth[rng.random(shape) < 0.3] = np.float32(1e30)
    cnt = rng.integers(0, 25, shape).astype(np.int32)
    local = win["local_size"]
    ep = np.where(rng.random(local) < 0.02, rng.integers(1, 4, local),
                  0).astype(np.int32)
    return depth, cnt, ep


def atan_args(seed=0, n=1 << 18):
    """(y, x) float32 [M]: random operands, a quarter in the phi domain
    (|y| <= 2, x in [0.05, 10]), every pair of special values with normal
    results (signed zeros, +-1, tiny and huge, the range edges of atanf),
    and 4096 quotients y / x in each of atanf's five argument ranges."""
    rng = np.random.default_rng(seed)
    y = (rng.normal(size=n) * 4).astype(np.float32)
    x = (rng.normal(size=n) * 4).astype(np.float32)
    y[: n // 4] = rng.uniform(-2, 2, n // 4)
    x[: n // 4] = rng.uniform(0.05, 10, n // 4)
    special = np.asarray([0.0, -0.0, 1.0, -1.0, 1e-10, -1e-10, 1e10, 3e-37,
                          0.4375, 0.6875, 1.1875, 2.4375], np.float32)
    yy, xx = np.meshgrid(special, special)
    ranges = [(1e-8, 0.4375), (0.4375, 0.6875), (0.6875, 1.1875),
              (1.1875, 2.4375), (2.4375, 1e7)]
    ry, rx = [], []
    for lo, hi in ranges:
        q = np.exp(rng.uniform(np.log(lo), np.log(hi), 4096))
        xs = rng.uniform(0.1, 10, 4096) * rng.choice([-1, 1], 4096)
        ry.append((q * np.abs(xs) * rng.choice([-1, 1], 4096)).astype(np.float32))
        rx.append(xs.astype(np.float32))
    return (np.concatenate([y, yy.ravel(), *ry]).astype(np.float32),
            np.concatenate([x, xx.ravel(), *rx]).astype(np.float32))


def points(name):
    """dict(points float32 [N, 3] world frame, valid bool [N], ogm_min_h,
    ogm_max_h, and the window's entries) of a point case."""
    rng = np.random.default_rng(POINTS.index(name) + 100)
    win = window({"cloud_40": "40x40x16_off", "cloud_100": "100x100x30",
                  "edges_40": "40x40x16", "ugv_200": "200x200x24_ugv"}[name])
    o = win["origin"].astype(np.float64)
    w, local = win["voxel_width"], win["local_size"]
    if name == "edges_40":
        # voxel centres and faces of the window's boundary, the height
        # band's edges, the origin itself and repeated points
        pvt = win["pvt"].astype(np.float64)
        lo, hi = pvt * w, (pvt + np.asarray(local)) * w
        g = rng.uniform(lo - 0.3, hi + 0.3, (6000, 3))
        g[:1000] = np.round(g[:1000] / w) * w            # voxel centres
        g[1000:2000] = (np.floor(g[1000:2000] / w) + 0.5) * w  # faces
        g[2000:2100, 2] = 0.0
        g[2100:2200, 2] = 2.5
        g[2200:2300] = o
        g[2300:2600] = g[2600:2900]
        pts = g
    else:
        n = {"cloud_40": 4096, "cloud_100": 16384, "ugv_200": 32768}[name]
        d = rng.normal(size=(n, 3))
        d[:, 2] *= 0.3
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        rng_m = rng.uniform(0.2, 0.75 * local[0] * w, n)
        rng_m[::5] = rng.uniform(0.5, 2.0, len(rng_m[::5]))  # near walls
        pts = o + d * rng_m[:, None]
        # two points on one ray (one bin, two ranges) and exact repeats
        i = np.arange(1, n, 7)
        pts[i] = o + (pts[i - 1] - o) * 0.6
        i = np.arange(2, n - 1, 11)
        pts[i] = pts[i + 1]
    pts = pts.astype(np.float32)
    valid = rng.random(len(pts)) > 0.1
    mn, mx = (0.0, 2.5) if win["voxel_width"] == 0.1 else (-10.0, 10.0)
    if name == "cloud_100":
        mn, mx = 0.3, 1.4   # a band that cuts the cloud
    return dict(points=pts, valid=valid, ogm_min_h=mn, ogm_max_h=mx, **win)
