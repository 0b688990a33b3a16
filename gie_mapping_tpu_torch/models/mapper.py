"""VolumetricMapper of the PyTorch port: the engine's user entry point.

Counterpart of gie_mapping_tpu/models/mapper.py for the point-cloud frame:
`process_pointcloud` (sensor->world transform, projective carve, merge),
`stage_pointcloud`, `warmup` and the per-frame output.  Not ported yet:
the other three sensors, changed-block streaming to the host mirror, the
batched replay API, checkpoints, the capacity monitor, and every canvas
scroll after the first placement of a fresh map (`_run` raises
NotImplementedError when the robot leaves the canvas's hysteresis box).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..map_state import MapState, canvas_geometry, place_fresh
from ..ops import raycast as rc
from ..utils import geometry as geo
from ..utils.config import (DEFAULT_FENCE_LL, DEFAULT_FENCE_UR, MapConfig,
                            unported_options)
from ..utils.constants import VB_WIDTH, VOX_UNKNOWN
from .pipeline import merge_frame


class FrameOutput:
    """Per-frame results (the reference's CostMap).  Fields are device
    tensors in `raw`; attribute access converts one to numpy on first use."""

    _FIELDS = ("edt", "glb_type", "dist_sq", "coc", "relax_iters",
               "fnt_count", "arch_dropped", "gate_level", "gate_slab_vox",
               "gate_sync_ms", "changed_blk", "ogm_changed")

    def __init__(self, raw: dict, origin, pvt):
        self.raw = raw
        self.origin = origin
        self.pvt = pvt
        self.ogm_time_ms = 0.0
        self.edt_time_ms = 0.0
        self._cache: dict = {}

    def __getattr__(self, name):
        if name in FrameOutput._FIELDS:
            cache = self.__dict__["_cache"]
            if name not in cache:
                v = self.__dict__["raw"][name]
                v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                cache[name] = v.item() if v.ndim == 0 else v
            return cache[name]
        raise AttributeError(name)

    @property
    def seen(self):
        return self.glb_type != VOX_UNKNOWN

    def cost_map(self):
        """SeenDist payload: (d, s, o) per voxel."""
        return {"d": self.edt, "o": self.glb_type, "s": self.seen,
                "origin": self.origin}


class _ExtObs:
    """Virtual fence / external-observer AABB set (host side)."""

    def __init__(self, cfg: MapConfig):
        self.cfg = cfg
        M = cfg.max_ext_obs
        self.ll = np.zeros((M, 3), np.float32)
        self.ur = np.zeros((M, 3), np.float32)
        self.n = 0
        self.assign([DEFAULT_FENCE_LL], [DEFAULT_FENCE_UR])

    def assign(self, lls, urs):
        self.n = min(len(lls), self.cfg.max_ext_obs)
        for i in range(self.n):
            self.ll[i] = lls[i]
            self.ur[i] = urs[i]

    def activate(self, win_ll, win_ur):
        """AABB-vs-window activation; box 0 (the inverted flyable-region
        fence) stays inactive, as in the reference."""
        act = np.zeros(self.cfg.max_ext_obs, bool)
        for i in range(1, self.n):
            act[i] = np.all(self.ll[i] <= win_ur) and np.all(self.ur[i] >= win_ll)
        return act


class VolumetricMapper:
    """The mapping engine: feed poses + point clouds, read cost maps."""

    _SELF = object()  # sentinel: "use self._origin"

    def __init__(self, cfg: MapConfig, device=None):
        bad = unported_options(cfg)
        if bad:
            raise NotImplementedError(
                "not ported to PyTorch yet: " + ", ".join(bad))
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.state = MapState.create(cfg, self.device)
        self.ext_obs = _ExtObs(cfg)
        self._origin = None  # host mirror of the canvas origin
        self._last_pvt = None
        self._fence_cache = None
        self.map_ct = 0
        self.last_output: Optional[FrameOutput] = None

    def warmup(self, robot_pos=(0.0, 0.0, 0.0)):
        """Run one empty frame on a throwaway state so the first real frame
        pays no one-time cost (kernel build, allocator growth).  Records the
        pivot like the JAX package's warmup does (`_frame_geometry`), so the
        first real frame's placement matches it."""
        cfg = self.cfg
        pvt, origin_blk, off = self._frame_geometry(
            np.asarray(robot_pos, np.float32))
        throwaway, shift = place_fresh(MapState.create(cfg, self.device),
                                       origin_blk, cfg)
        fence, fence_on = self._fence_args(pvt)
        zeros8 = torch.zeros(cfg.local_size, dtype=torch.int8, device=self.device)
        zeros32 = torch.zeros(cfg.local_size, dtype=torch.int32, device=self.device)
        merge_frame(throwaway, zeros8, zeros32, pvt, origin_blk, off, fence,
                    cfg=cfg, input_pointcloud=False, use_fence=fence_on,
                    enter_shift=shift)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def _frame_geometry(self, robot_pos, origin=_SELF, motion=_SELF):
        """Window pivot + canvas origin with scroll hysteresis (see the JAX
        package); placement is motion-biased when the origin must move."""
        cfg = self.cfg
        if origin is VolumetricMapper._SELF:
            origin = self._origin
        pvt = geo.calculate_pivot(robot_pos, cfg.voxel_width, cfg.local_size)
        if motion is VolumetricMapper._SELF:
            last = self._last_pvt
            motion = None if last is None else pvt - last
            self._last_pvt = pvt.copy()
        if origin is not None:
            off = pvt - origin * VB_WIDTH
            lo_ok = (off >= cfg.halo_grids).all()
            hi_ok = (off + np.asarray(cfg.local_size) + cfg.halo_grids
                     <= np.asarray(cfg.canvas_size)).all()
            if lo_ok and hi_ok:
                return pvt, origin.copy(), off.astype(np.int32)
        origin_blk, _, off = canvas_geometry(cfg, pvt, motion)
        return pvt, origin_blk, off

    def _fence_args(self, pvt):
        cfg = self.cfg
        win_ll = pvt.astype(np.float32) * cfg.voxel_width
        win_ur = win_ll + np.asarray(cfg.local_size_m, np.float32)
        act = self.ext_obs.activate(win_ll, win_ur)
        key = (self.ext_obs.ll.tobytes(), self.ext_obs.ur.tobytes(),
               act.tobytes(), self.ext_obs.n)
        if self._fence_cache is None or self._fence_cache[0] != key:
            dev = self.device
            args = (torch.from_numpy(self.ext_obs.ll.copy()).to(dev),
                    torch.from_numpy(self.ext_obs.ur.copy()).to(dev),
                    torch.from_numpy(act).to(dev), int(self.ext_obs.n))
            self._fence_cache = (key, args)
        return self._fence_cache[1], bool(act.any())

    def _run(self, inst_type, ray_count, pvt, origin_blk, off, *,
             input_pointcloud, t_sensor0):
        cfg = self.cfg
        fence, fence_on = self._fence_args(pvt)
        t_ogm = time.perf_counter()
        enter_shift = None
        if self._origin is None or not np.array_equal(self._origin, origin_blk):
            # place_fresh raises NotImplementedError unless the map is fresh
            self.state, enter_shift = place_fresh(self.state, origin_blk, cfg)
            self._origin = np.asarray(origin_blk).copy()
        self.state, out = merge_frame(
            self.state, inst_type, ray_count, pvt, origin_blk, off, fence,
            cfg=cfg, input_pointcloud=input_pointcloud, use_fence=fence_on,
            enter_shift=enter_shift)
        t_end = time.perf_counter()
        self.map_ct += 1
        result = FrameOutput(out, origin=pvt.astype(np.float32) * cfg.voxel_width,
                             pvt=pvt)
        result.ogm_time_ms = (t_ogm - t_sensor0) * 1e3
        result.edt_time_ms = (t_end - t_ogm) * 1e3
        self.last_output = result
        return result

    def _sensor_proj(self, proj: geo.Projection) -> geo.Projection:
        """ugv_height override: ground vehicles clamp the sensor origin's z."""
        if self.cfg.ugv_height > 0:
            t = proj.trans.clone()
            t[2] = self.cfg.ugv_height
            return geo.Projection(proj.rot, t)
        return proj

    @staticmethod
    def _pc_bucket(n, cap):
        """Smallest power-of-2 staging capacity covering n live points
        (>= 4096, <= cap)."""
        b = 4096
        while b < n:
            b *= 2
        return min(b, cap)

    def stage_pointcloud(self, points_sensor, pad_to=None, valid=None):
        """Upload a point cloud to the device, padded to the live-point
        bucket (or `pad_to`).  Returns (points, valid) tensors accepted by
        process_pointcloud."""
        cfg = self.cfg
        pts = np.asarray(points_sensor, np.float32)
        n = min(len(pts), cfg.max_raycast_points)
        cap = pad_to or self._pc_bucket(n, cfg.max_raycast_points)
        buf = np.zeros((cap, 3), np.float32)
        buf[:n] = pts[:n]
        vmask = np.zeros(cap, bool)
        vmask[:n] = True if valid is None else np.asarray(valid, bool)[:n]
        return (torch.from_numpy(buf).to(self.device),
                torch.from_numpy(vmask).to(self.device))

    def process_pointcloud(self, proj: geo.Projection, points_sensor,
                           valid=None):
        """Point-cloud frame: points_sensor [N, 3] float32 in the SENSOR
        frame (a numpy array, or a tensor pair from stage_pointcloud)."""
        t0 = time.perf_counter()
        proj = self._sensor_proj(proj)
        cfg = self.cfg
        origin = proj.trans.cpu().numpy().astype(np.float32)
        pvt, origin_blk, off = self._frame_geometry(origin)
        if isinstance(points_sensor, torch.Tensor) and valid is not None:
            buf, vmask = points_sensor.to(self.device), valid.to(self.device)
        else:
            buf, vmask = self.stage_pointcloud(points_sensor, valid=valid)
        world = proj.to(self.device).l2g(buf)
        nt, np_ = rc.panorama_bins(cfg.local_size)
        inst, counts = rc.pointcloud_project(
            world, vmask, origin, pvt, local_size=cfg.local_size,
            voxel_width=cfg.voxel_width, ogm_min_h=cfg.ogm_min_h,
            ogm_max_h=cfg.ogm_max_h, for_motion_planner=cfg.for_motion_planner,
            robot_r2_grids=cfg.robot_r2_grids, n_theta=nt, n_phi=np_)
        return self._run(inst, counts, pvt, origin_blk, off,
                         input_pointcloud=True, t_sensor0=t0)
