"""Synthetic worlds, the four sensors' simulators and trajectories (numpy
only), and the paths the port is driven along on the GPU.

BoxWorld and circular_trajectory are copies from
gie_mapping_tpu/runtime/datasets.py (the machine that runs the port on a
GPU has no JAX, and the JAX package's module imports its JAX geometry):
worlds, clouds, scans, depth images and ring images made from one seed are
identical in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import geometry as geo


@dataclasses.dataclass
class BoxWorld:
    """Axis-aligned boxes [M, 2, 3] (ll, ur) in metres + bounding walls."""

    boxes: np.ndarray
    bounds_ll: np.ndarray
    bounds_ur: np.ndarray

    @staticmethod
    def corridor(seed=0, n_pillars=6, extent=8.0, height=3.0):
        rng = np.random.default_rng(seed)
        boxes = []
        for _ in range(n_pillars):
            c = rng.uniform(-extent * 0.7, extent * 0.7, 2)
            w = rng.uniform(0.2, 0.8, 2)
            h = rng.uniform(0.8, height, 1)[0]
            boxes.append([[c[0] - w[0], c[1] - w[1], 0.0], [c[0] + w[0], c[1] + w[1], h]])
        return BoxWorld(
            boxes=np.asarray(boxes, np.float32),
            bounds_ll=np.asarray([-extent, -extent, 0.0], np.float32),
            bounds_ur=np.asarray([extent, extent, height], np.float32),
        )

    def occupied(self, pts):
        """Boolean: world points inside any box or outside the bounds walls."""
        pts = np.asarray(pts)
        inside_box = np.zeros(pts.shape[:-1], bool)
        for ll, ur in self.boxes:
            inside_box |= np.all((pts >= ll) & (pts <= ur), -1)
        outside = np.any(pts < self.bounds_ll, -1) | np.any(pts > self.bounds_ur, -1)
        return inside_box | outside

    # -- analytic sensors ----------------------------------------------
    def ray_march(self, origin, dirs, max_range=30.0, step=0.02):
        """First-hit range along each direction, on the same sample grid as
        dense marching (t = step, 2*step, ... < max_range; first sample
        inside any box — inclusive bounds — or strictly outside the world
        walls).

        Implemented analytically (slab ray-AABB intervals in float64 +
        searchsorted onto the float32 sample grid); the JAX package's copy
        keeps the dense-sampling oracle it is tested against."""
        o = np.asarray(origin, np.float64)
        d = np.asarray(dirs, np.float64)
        R = d.shape[0]
        ts = np.arange(step, max_range, step, dtype=np.float32)
        n_t = len(ts)
        ts64 = ts.astype(np.float64)

        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / d  # +-inf where d==0 (IEEE semantics)

            def interval_k(tn, tf, strict_lo=False):
                """First sample index inside [tn, tf] (or (tn, ...) when
                strict_lo), n_t when none."""
                side = "right" if strict_lo else "left"
                k0 = np.searchsorted(ts64, tn, side=side)
                kk = np.minimum(k0, n_t - 1)
                ok = (k0 < n_t) & (ts64[kk] <= tf)
                return np.where(ok, k0, n_t)

            def slab(ll, ur):
                # d==0 outside the slab: +-inf same sign -> empty interval;
                # inside: -inf/+inf -> full.  NaN (o exactly on a face with
                # d==0) counts inside, matching p >= ll & p <= ur.
                t0 = (np.asarray(ll, np.float64)[None, :] - o[None, :]) * inv
                t1 = (np.asarray(ur, np.float64)[None, :] - o[None, :]) * inv
                lo = np.where(np.isnan(np.fmin(t0, t1)), -np.inf,
                              np.fmin(t0, t1))
                hi = np.where(np.isnan(np.fmax(t0, t1)), np.inf,
                              np.fmax(t0, t1))
                return lo.max(axis=1), hi.min(axis=1)

            first_k = np.full(R, n_t, np.int64)
            for ll, ur in self.boxes:
                tn, tf = slab(ll, ur)
                first_k = np.minimum(first_k, interval_k(tn, tf))
            # outside the bounding walls (STRICT inequalities): occupied for
            # every sample strictly past the world-box exit, and before a
            # (re)entry for rays starting outside
            tn, tf = slab(self.bounds_ll, self.bounds_ur)
            first_k = np.minimum(first_k, interval_k(tf, np.inf,
                                                     strict_lo=True))
            outside0 = np.any(o < self.bounds_ll.astype(np.float64)) or \
                np.any(o > self.bounds_ur.astype(np.float64))
            if outside0:
                first_k = np.minimum(first_k, interval_k(
                    np.full(R, -np.inf), np.minimum(tn, np.inf) - 1e-12))

        hit = first_k < n_t
        return np.where(hit, ts[np.minimum(first_k, n_t - 1)],
                        np.nan).astype(np.float32)

    def ray_march_dense(self, origin, dirs, max_range=30.0, step=0.02):
        """Dense-sampling marcher (the analytic ray_march's oracle;
        O(rays x samples) memory and compute: test scale only)."""
        origin = np.asarray(origin, np.float32)
        dirs = np.asarray(dirs, np.float32)
        t = np.arange(step, max_range, step, dtype=np.float32)
        pts = origin[None, None, :] + dirs[:, None, :] * t[None, :, None]
        occ = self.occupied(pts)  # [R, T]
        first = occ.argmax(1)
        hit = occ.any(1)
        return np.where(hit, t[first], np.nan).astype(np.float32)

    def scan_2d(self, proj: geo.Projection, n_beams=360, theta_min=-np.pi,
                theta_inc=None, max_range=30.0):
        """Simulated planar LiDAR in the sensor frame (z=0 plane): (ranges
        float32 [n_beams], NaN where nothing is hit; theta_min; theta_inc)."""
        if theta_inc is None:
            theta_inc = 2 * np.pi / n_beams
        th = theta_min + np.arange(n_beams) * theta_inc
        dirs_local = np.stack([np.cos(th), np.sin(th), np.zeros_like(th)], -1)
        rot = np.asarray(proj.rot)
        dirs_world = dirs_local @ rot.T
        ranges = self.ray_march(np.asarray(proj.trans), dirs_world, max_range)
        return ranges, theta_min, theta_inc

    def pointcloud(self, proj: geo.Projection, n_rays=4096, max_range=12.0, seed=0):
        """Simulated omnidirectional pointcloud: endpoints in SENSOR frame."""
        rng = np.random.default_rng(seed)
        v = rng.normal(size=(n_rays, 3)).astype(np.float32)
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        rot = np.asarray(proj.rot)
        ranges = self.ray_march(np.asarray(proj.trans), v @ rot.T, max_range)
        ok = ~np.isnan(ranges)
        return (v[ok] * ranges[ok, None]).astype(np.float32)

    def depth_image(self, proj: geo.Projection, rows=48, cols=64, fx=40.0,
                    fy=40.0, cx=None, cy=None, max_range=12.0):
        """Simulated depth camera (x forward, y left, z up): (depth float32
        [rows, cols], the forward component of the hit's range, NaN where
        nothing is hit; fx; fy; cx; cy)."""
        cx = cols / 2 if cx is None else cx
        cy = rows / 2 if cy is None else cy
        px, py = np.meshgrid(np.arange(cols), np.arange(rows))
        y = (cx - px) / fx
        z = (cy - py) / fy
        d = np.stack([np.ones_like(y), y, z], -1).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        rot = np.asarray(proj.rot)
        rng = self.ray_march(np.asarray(proj.trans), d.reshape(-1, 3) @ rot.T,
                             max_range)
        fwd = rng * d.reshape(-1, 3)[:, 0]
        return fwd.reshape(rows, cols).astype(np.float32), fx, fy, cx, cy

    def multiscan(self, proj: geo.Projection, ring_num=16, scan_num=360,
                  phi_min=np.deg2rad(-15.0), phi_inc=np.deg2rad(2.0),
                  theta_min=-np.pi, theta_inc=None, max_range=25.0):
        """Simulated 16-ring spinning LiDAR: (horizontal ranges float32
        [ring_num, scan_num], NaN where nothing is hit; theta_min;
        theta_inc; phi_min; phi_inc)."""
        if theta_inc is None:
            theta_inc = 2 * np.pi / scan_num
        th = theta_min + np.arange(scan_num) * theta_inc
        ph = phi_min + np.arange(ring_num) * phi_inc
        T, P = np.meshgrid(th, ph)
        dirs = np.stack([np.cos(P) * np.cos(T), np.cos(P) * np.sin(T),
                         np.sin(P)], -1)
        rot = np.asarray(proj.rot)
        rng = self.ray_march(np.asarray(proj.trans),
                             dirs.reshape(-1, 3) @ rot.T, max_range)
        horiz = rng * np.cos(P).reshape(-1)
        return (horiz.reshape(ring_num, scan_num).astype(np.float32),
                theta_min, theta_inc, phi_min, phi_inc)


def circular_trajectory(n_frames=20, radius=2.0, height=1.0, closed=False):
    """Poses orbiting the origin, always facing forward along the orbit.

    closed: spread the frames over the FULL circle so frame n-1 is adjacent
    to frame 0 (replaying the sequence wraps with an ordinary scroll)."""
    out = []
    for i in range(n_frames):
        a = 2 * np.pi * i / max(n_frames, 1) * (1.0 if closed else 0.5)
        pos = np.asarray([radius * np.cos(a), radius * np.sin(a), height], np.float32)
        yaw = a + np.pi / 2
        quat = (np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2))
        out.append(geo.Projection.from_pose(pos, quat))
    return out


def yaw_then_translate(n_yaw=8, n_move=4, start=(0.0, 0.0, 1.2),
                       yaw_step=np.pi / 4, step_x=0.05):
    """(position float32 [3], quaternion (w, x, y, z)) poses that turn in
    place through `n_yaw` headings `yaw_step` apart, then translate
    +`step_x` m per frame in x for `n_move` frames at the last heading.

    Plain numpy pairs, so that either package builds its own Projection
    from them (`Projection.from_pose(*pose)`)."""
    pos = np.asarray(start, np.float32)
    quat = lambda yaw: (np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2))
    out = [(pos.copy(), quat(i * yaw_step)) for i in range(n_yaw)]
    last = (n_yaw - 1) * yaw_step
    for i in range(1, n_move + 1):
        out.append((pos + np.asarray([step_x * i, 0.0, 0.0], np.float32),
                    quat(last)))
    return out


COW_SLICE_RAYS = 131072  # live points per frame of the cow-lady slice


def cow_lady_slice():
    """(MapConfig overrides, world, poses) of the port's cow-lady slice: the
    cow_lady preset with 131072 points per frame and streaming off, the
    corridor world of the headline bench, and the 12-pose yaw-then-translate
    trajectory (which never leaves the canvas after frame 0).  Frame i's
    cloud is world.pointcloud(proj_i, n_rays=COW_SLICE_RAYS, max_range=8.0,
    seed=i)."""
    overrides = dict(max_raycast_points=COW_SLICE_RAYS, display_glb_edt=False,
                     display_glb_ogm=False)
    world = BoxWorld.corridor(seed=11, n_pillars=8, extent=4.0, height=2.5)
    return overrides, world, yaw_then_translate()


def scroll_trajectory(start=(0.0, 0.0, 1.2), n_yaw=3, yaw_step=np.pi / 4,
                      step_x=0.3, n_out=6, dz=0.8, n_back=6, teleport_x=20.0,
                      n_after=1):
    """(position, quaternion) poses that move the canvas every way a robot
    can: `n_yaw` headings in place, `n_out` steps of +step_x m, one step of
    +dz m in z, `n_back` steps of -step_x m (archived blocks re-enter), a
    jump of +teleport_x m in x and one back, then `n_after` more -step_x
    steps.  The heading stays the last yaw after the turn."""
    quat = lambda yaw: (np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2))
    q = quat((n_yaw - 1) * yaw_step)
    pos = np.asarray(start, np.float32)
    out = [(pos.copy(), quat(i * yaw_step)) for i in range(n_yaw)]

    def step(d):
        nonlocal pos
        pos = (pos + np.asarray(d, np.float32)).astype(np.float32)
        out.append((pos.copy(), q))

    for _ in range(n_out):
        step((step_x, 0.0, 0.0))
    step((0.0, 0.0, dz))
    for _ in range(n_back):
        step((-step_x, 0.0, 0.0))
    step((teleport_x, 0.0, 0.0))
    step((-teleport_x, 0.0, 0.0))
    for _ in range(n_after):
        step((-step_x, 0.0, 0.0))
    return out


def cow_lady_scroll():
    """(MapConfig overrides, world, poses) of the port's cow-lady scroll
    path: the cow_lady preset at its own defaults (streaming on, 64
    block-columns per tick) with 131072 points per frame, and a 26-pose
    scroll_trajectory from (-2.5, 0, 1.2): 3 headings, 10 steps of +0.5 m
    in x, +1.0 m in z, 10 steps back, a 25 m jump (beyond the 15.2 m
    canvas) and back.  The world is the slice's corridor generator at 20 m
    across with 24 pillars: in the slice's 8 m world every observed block
    stays inside the 15.2 m canvas, so only a teleport would archive
    anything.  Frame i's cloud is world.pointcloud(proj_i,
    n_rays=COW_SLICE_RAYS, max_range=8.0, seed=i)."""
    overrides = dict(max_raycast_points=COW_SLICE_RAYS)
    world = BoxWorld.corridor(seed=11, n_pillars=24, extent=10.0, height=2.5)
    return overrides, world, scroll_trajectory(
        start=(-2.5, 0.0, 1.2), n_yaw=3, step_x=0.5, n_out=10, dz=1.0,
        n_back=10, teleport_x=25.0, n_after=0)


def cow_lady_bench(n_frames=40, n_online=3, rays=COW_SLICE_RAYS):
    """(MapConfig overrides, world, poses, n_online, chunk) of the headline
    benchmark's replay (bench.py): the cow_lady preset with `rays` points
    per frame, the sensor model in the frame program (fuse_raycast) and
    streaming off; the slice's corridor world; a closed `n_frames`-pose
    circle of radius 1.5 m at 1.2 m, its first `n_online` poses repeated in
    front.  The first `n_online` frames go through process_pointcloud, the
    `n_frames` after them through one process_pointcloud_batch call with
    `chunk` = min(40, n_frames).  Frame i's cloud is
    world.pointcloud(poses[i], n_rays=rays, max_range=8.0, seed=i)."""
    overrides = dict(max_raycast_points=rays, fuse_raycast=True,
                     display_glb_edt=False, display_glb_ogm=False)
    world = BoxWorld.corridor(seed=11, n_pillars=8, extent=4.0, height=2.5)
    loop = circular_trajectory(n_frames=n_frames, radius=1.5, height=1.2,
                               closed=True)
    return overrides, world, loop[:n_online] + loop, n_online, min(40, n_frames)


# A Hokuyo UTM-30LX, from its data sheet: 1,081 beams over 270 degrees
# (0.25 degrees apart), 30 m range
HOKUYO_BEAMS = 1081
HOKUYO_THETA_MIN = -3 * np.pi / 4
HOKUYO_THETA_INC = np.pi / 720
HOKUYO_RANGE = 30.0


def scan2d_world():
    """The 2-D LiDAR paths' world: the cow-lady scroll path's 20 m corridor
    (24 pillars, some below the 1 m scan plane)."""
    return BoxWorld.corridor(seed=11, n_pillars=24, extent=10.0, height=2.5)


def hokuyo_scan(world, pose):
    """(ranges, theta_min, theta_inc) of the Hokuyo geometry at a
    (position, quaternion) pose."""
    return world.scan_2d(geo.Projection.from_pose(*pose), n_beams=HOKUYO_BEAMS,
                         theta_min=HOKUYO_THETA_MIN,
                         theta_inc=HOKUYO_THETA_INC, max_range=HOKUYO_RANGE)


def scan2d_path():
    """16 poses of the scan2D preset's path, with the sensor 1 m up: 5
    headings a quarter turn apart at (-3, 1), then 11 steps of +0.6 m in x
    along a lane free of pillars (the 100 x 100 x 30 window scrolls its
    128 x 128 x 56 canvas every second step or so)."""
    return yaw_then_translate(n_yaw=5, n_move=11, start=(-3.0, 1.0, 1.0),
                              yaw_step=np.pi / 2, step_x=0.6)


def scan2d_flat_path():
    """10 poses of the true 2-D map's path, on the same lane: 3 headings
    half a turn apart, then 7 steps of +0.6 m in x."""
    return yaw_then_translate(n_yaw=3, n_move=7, start=(-3.0, 1.0, 1.0),
                              yaw_step=np.pi, step_x=0.6)


# bench_suite.py's frames and trajectory for the preset-scale sensor cases
SUITE_BASE_FRAMES = 40
SUITE_DEPTH = dict(rows=96, cols=128, fx=80.0, fy=80.0, max_range=6.0)
SUITE_RAYS = 16384  # bench_suite.py's live points for point-cloud cases


def suite_world_circle(local_size_m, n_frames=SUITE_BASE_FRAMES):
    """bench_suite.py's case_world_poses at chunk 40: the corridor world
    (seed 11, 8 pillars) scaled to the window, and a closed `n_frames`-pose
    circle (40 in bench_suite.py) of radius 0.35 * extent at 0.4 * the
    window's height."""
    extent = min(local_size_m[0] * 0.45, 4.5)
    world = BoxWorld.corridor(seed=11, n_pillars=8, extent=extent,
                              height=max(local_size_m[2], 2.5))
    loop = circular_trajectory(n_frames=n_frames,
                               radius=extent * 0.35,
                               height=local_size_m[2] * 0.4, closed=True)
    return world, loop


def depthcam_bench():
    """(MapConfig overrides, world, poses, n_online, chunk) of the depthcam
    path: the depthcam preset (100 x 100 x 30 window of 0.1 m, 240 x 240 x
    168 canvas with one slack block, fast_mode off, 6 m cutoff) with
    streaming off, as bench_suite.py runs it; the closed 40-pose circle of
    radius 1.575 m at 1.2 m, its first 2 poses in front (bench_suite's
    warm-up frames).  The first `n_online` frames go through process_depth,
    the 40 after them through one process_depth_batch call with `chunk` =
    40.  Frame i is depth_frames(world, poses)[i]."""
    world, loop = suite_world_circle((10.0, 10.0, 3.0))
    overrides = dict(display_glb_edt=False, display_glb_ogm=False)
    return overrides, world, loop[:2] + loop, 2, SUITE_BASE_FRAMES


def laser3d_bench():
    """(MapConfig overrides, world, poses, n_online, chunk) of the laser3D
    path: the laser3D preset at its own defaults (80 x 80 x 10 window of
    0.2 m, 112 x 112 x 40 canvas, fast_mode, for_motion_planner, streaming
    on); bench_suite.py's circle for its window (radius 1.575 m at 0.8 m),
    its first 2 poses in front, as depthcam_bench."""
    world, loop = suite_world_circle((16.0, 16.0, 2.0))
    return {}, world, loop[:2] + loop, 2, SUITE_BASE_FRAMES


def dda_path(n_frames=12):
    """(MapConfig overrides, world, poses) of the DDA path: the
    uav_raycast_fine preset (50 x 50 x 15 window of 0.2 m, 80 x 80 x 40
    canvas, streaming on) with raycast_mode "dda" and bench_suite.py's
    point-cloud overrides (16384 points, fuse_raycast, which the DDA mode
    does not use); the first `n_frames` poses of its circle (radius 1.575
    m at 1.2 m).  Frame i's cloud is world.pointcloud(poses[i],
    n_rays=SUITE_RAYS, max_range=8.0, seed=i)."""
    world, loop = suite_world_circle((10.0, 10.0, 3.0))
    overrides = dict(raycast_mode="dda", max_raycast_points=SUITE_RAYS,
                     fuse_raycast=True)
    return overrides, world, loop[:n_frames]


def depth_frames(world, poses):
    """(depth images float32 [K, 96, 128], (fx, fy, cx, cy)) of
    bench_suite.py's depth camera at each pose."""
    imgs = [world.depth_image(p, **SUITE_DEPTH) for p in poses]
    return np.stack([im[0] for im in imgs]), imgs[0][1:]


def ring_frames(world, poses):
    """(ring images float32 [K, 16, 360], (theta_min, theta_inc, phi_min,
    phi_inc)) of bench_suite.py's 16-ring LiDAR at each pose."""
    scans = [world.multiscan(p) for p in poses]
    return np.stack([s[0] for s in scans]), scans[0][1:]


def save_frames_npz(path, frames):
    """Persist a replayable frame sequence (the bag converter's output):
    frame i's field k is stored as "{i:05d}/{k}" (a copy of the JAX
    package's, so a file moves between the two)."""
    flat = {}
    for i, fr in enumerate(frames):
        for k, v in fr.items():
            flat[f"{i:05d}/{k}"] = v
    np.savez_compressed(path, **flat)


def load_frames_npz(path):
    """The frames of a save_frames_npz file, as a list of dicts."""
    raw = np.load(path, allow_pickle=False)
    frames: dict = {}
    for k in raw.files:
        idx, field = k.split("/", 1)
        frames.setdefault(int(idx), {})[field] = raw[k]
    return [frames[i] for i in sorted(frames)]


def ring_cloud(world, proj, ring_num=16, scan_num=360):
    """(points [N, 3] float32 in the sensor frame, ring ids [N] int32,
    phi_min, phi_inc): a raw multi-ring LiDAR cloud at `proj`, one point per
    hit bin of world.multiscan's ring image (at the bin's azimuth and
    elevation, at its horizontal range), for process_multiscan_cloud."""
    img, tmin, tinc, pmin, pinc = world.multiscan(proj, ring_num=ring_num,
                                                  scan_num=scan_num)
    rr, tt = np.meshgrid(np.arange(ring_num), np.arange(scan_num),
                         indexing="ij")
    ok = ~np.isnan(img)
    theta = tmin + tt[ok] * tinc
    phi = pmin + rr[ok] * pinc
    horiz = img[ok]
    pts = np.stack([horiz * np.cos(theta), horiz * np.sin(theta),
                    horiz * np.tan(phi)], -1).astype(np.float32)
    return pts, rr[ok].astype(np.int32), pmin, pinc


def multiscan_cloud_path(n_frames=4):
    """(world, poses) of the raw ring-cloud path: the laser3D path's world
    and the first `n_frames` poses of its circle (laser3d_bench); frame i
    is ring_cloud(world, poses[i])."""
    _, world, loop, _, _ = laser3d_bench()
    return world, loop[:n_frames]


def there_and_back(n, step, start, y=0.0, z=1.2):
    """n poses facing +x along y = `y`: out from x = `start` in steps of
    `step` for n // 2 steps, then back the same way."""
    half = n // 2
    xs = [start + step * min(i, half) - step * max(0, i - half)
          for i in range(n)]
    return [geo.Projection.from_pose(np.asarray([x, y, z], np.float32),
                                     (1.0, 0.0, 0.0, 0.0)) for x in xs]


EXT_CHURN_RAYS = 8192


def ext_churn_path():
    """The fence-churn scenario at the cow_lady preset's width: (MapConfig
    overrides, world, poses, boxes, ext_cloud, split, chunk).  Sixteen
    there-and-back poses from x = -4.4 m in 1.1 m steps (the 10 m window
    scrolls every frame); two fence boxes `boxes` [(ll, ur)] beyond each
    end of the path, appended to the default fence, whose activation
    toggles as the window passes them; and an external-observer cluster
    `ext_cloud` (8 points within 5 cm) near the path.  The frames before
    `split` replay in one process_pointcloud_batch call with `chunk`, then
    process_ext_cloud(ext_cloud) resets the boxes to the default fence plus
    the cluster's box, then the rest replay in a second call.  Frame i's
    cloud is world.pointcloud(poses[i], n_rays=EXT_CHURN_RAYS,
    max_range=8.0, seed=i); fuse_raycast is on (the replay needs it) and
    streaming off."""
    overrides = dict(max_raycast_points=EXT_CHURN_RAYS, fuse_raycast=True,
                     display_glb_edt=False, display_glb_ogm=False)
    world = BoxWorld.corridor(seed=3, n_pillars=8, extent=6.0, height=2.5)
    poses = there_and_back(16, step=1.1, start=-4.4)
    boxes = [(np.asarray([8.4, -0.5, 0.0], np.float32),
              np.asarray([9.0, 0.8, 1.4], np.float32)),
             (np.asarray([-9.6, -0.4, 0.0], np.float32),
              np.asarray([-9.0, 0.6, 1.2], np.float32))]
    rng = np.random.default_rng(9)
    ext_cloud = (np.asarray([1.0, 0.6, 0.5], np.float32)
                 + rng.uniform(-0.05, 0.05, (8, 3)).astype(np.float32))
    return overrides, world, poses, boxes, ext_cloud, 9, 4
