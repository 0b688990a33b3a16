"""VolumetricMapper of the PyTorch port: the engine's user entry point.

Counterpart of gie_mapping_tpu/models/mapper.py for two map makers:
`process_pointcloud` (sensor->world transform, projective carve, the
host-gated canvas scroll, merge) with `stage_pointcloud`, and
`process_scan2d` (the 2-D LiDAR model, scroll, merge); `warmup`, the
per-frame output, changed-block streaming to the host mirror
(`_stream` / `flush_stream`) and the capacity monitor (`CapacityWarning`).
The mapper runs on the CUDA device unless it is given another.  Not ported
yet: the depth-camera and multi-ring sensors, the batched replay API and
checkpoints.
"""
from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..map_state import (MapState, canvas_geometry, resolve_device,
                         shift_block_mask, stream_extract)
from ..ops import raycast as rc
from ..ops.scan_sensors import ScanParam, hokuyo_update
from ..utils import geometry as geo
from ..utils.config import (DEFAULT_FENCE_LL, DEFAULT_FENCE_UR, MapConfig,
                            unported_options)
from ..utils.constants import VB_WIDTH, VOX_UNKNOWN
from .pipeline import kernel_limits, merge_frame, scroll_step


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


class CapacityWarning(UserWarning):
    """A capacity edge was hit: archive full (scrolled-out map data dropped)
    or the streaming backlog not draining.  Raised as RuntimeError instead
    with cfg.capacity_strict."""


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
    """The mapping engine: feed poses + point clouds or 2-D scans, read cost
    maps.  `device` defaults to "cuda" (an error without a card); pass
    device="cpu" to run the kernels' plain versions on the CPU."""

    _SELF = object()  # sentinel: "use self._origin"

    def __init__(self, cfg: MapConfig, device=None):
        bad = unported_options(cfg)
        if bad:
            raise NotImplementedError(
                "not ported to PyTorch yet: " + ", ".join(bad))
        if torch.device("cuda" if device is None else device).type == "cuda":
            bad = kernel_limits(cfg)
            if bad:
                raise NotImplementedError(
                    "beyond the CUDA kernels' limits: " + ", ".join(bad))
        self.cfg = cfg
        self.device = resolve_device(device, "VolumetricMapper")
        self.state = MapState.create(cfg, self.device)
        self.ext_obs = _ExtObs(cfg)
        self._origin = None  # host mirror of the canvas origin
        self._last_pvt = None
        self._fence_cache = None
        self.map_ct = 0
        self.last_output: Optional[FrameOutput] = None
        self.mirror = None  # runtime.host_mirror.HostMirror, made on first use
        # streaming: device carry of unserved blocks, round-robin offset,
        # the in-flight tick (host copies + event), ingested on the next one
        self._stream_carry = None
        self._stream_rot = 0
        self._stream_k_cols = 64
        self._stream_pending = None
        self.stream_ingested = 0  # blocks ingested into the mirror so far
        # capacity monitor: each frame ingests the previous frame's scalars
        self._cap_pending = None
        self._cap_dropped_seen = 0
        self._stream_stall = 0
        self._stall_reported = False
        self._last_leftover = 0
        self._pinned: dict = {}

    def warmup(self, robot_pos=(0.0, 0.0, 0.0)):
        """Run one empty frame on a throwaway state so the first real frame
        pays no one-time cost (kernel build, allocator growth).  Records the
        pivot like the JAX package's warmup does (`_frame_geometry`), so the
        first real frame's placement matches it."""
        cfg = self.cfg
        pvt, origin_blk, off = self._frame_geometry(
            np.asarray(robot_pos, np.float32))
        throwaway, shift = scroll_step(MapState.create(cfg, self.device),
                                       origin_blk, cfg=cfg)
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

    def _scroll_compact_cols(self, origin_blk, prev):
        """Block-column bucket that sizes this scroll's row buffers (the
        column half of the JAX package's _scroll_compact_rows): an upper
        bound on the columns that exit or enter, NCOLS - prod(cb.xy -
        |shift.xy|), or every column when the shift has a z component,
        rounded up to 32 / 64 / 128 / NCOLS so few shapes occur."""
        shift = np.abs(np.asarray(origin_blk, np.int64) - np.asarray(prev, np.int64))
        cb = np.asarray(self.cfg.canvas_blocks, np.int64)
        ncols = int(cb[0] * cb[1])
        if shift[2] != 0:
            col_bound = ncols
        else:
            col_bound = ncols - int(np.maximum(cb[:2] - shift[:2], 0).prod())
        return next((s for s in (32, 64, 128) if col_bound <= s <= ncols), ncols)

    def _run(self, inst_type, ray_count, pvt, origin_blk, off, *,
             input_pointcloud, t_sensor0):
        cfg = self.cfg
        fence, fence_on = self._fence_args(pvt)
        t_ogm = time.perf_counter()
        enter_shift = None
        # host-gated scroll: only block-crossing frames pay it
        if self._origin is None or not np.array_equal(self._origin, origin_blk):
            prev = (self._origin if self._origin is not None
                    else self.state.origin_blk.cpu().numpy())
            cols = self._scroll_compact_cols(origin_blk, prev)
            if self._stream_carry is not None:
                # un-served streamed blocks are indexed in canvas coords:
                # the carry moves with the canvas (exposed region: False)
                self._stream_carry = shift_block_mask(
                    self._stream_carry, np.asarray(origin_blk, np.int64) - prev)
            self._origin = np.asarray(origin_blk).copy()
            self.state, enter_shift = scroll_step(
                self.state, origin_blk, cfg=cfg, compact_cols=cols,
                old_origin_blk=prev)
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
        if (cfg.display_glb_edt or cfg.display_glb_ogm) and (
                self.map_ct % cfg.vis_interval == 0):
            self._stream(out, origin_blk)
        self._queue_capacity_guard(
            out["arch_dropped"],
            out["relax_iters"] if cfg.merge_mode == "relax" else None)
        return result

    # -- device -> host copies ---------------------------------------------
    def _to_host(self, tag, tensors):
        """Start copies of `tensors` to the host.  On a CUDA device they go
        to pinned buffers (reused per tag; the previous copies under the
        tag must have been consumed) without blocking, and an event marks
        their end.  Returns (host tensors, event or None)."""
        if self.device.type != "cuda":
            return list(tensors), None
        out = []
        for i, t in enumerate(tensors):
            key = (tag, i)
            buf = self._pinned.get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                self._pinned[key] = buf
            buf.copy_(t, non_blocking=True)
            out.append(buf)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return out, ev

    # -- capacity monitor ----------------------------------------------------
    def _alert(self, msg: str):
        if self.cfg.capacity_strict:
            raise RuntimeError(msg)
        if self.cfg.capacity_warn:
            warnings.warn(msg, CapacityWarning, stacklevel=3)

    def check_capacity(self):
        """Ingest the previous frame's capacity scalars and report
        saturation.  Called at every frame; call it after the last frame to
        drain the last pending check."""
        p, self._cap_pending = self._cap_pending, None
        if p is None:
            return
        (dropped,), ev, relax_iters = p
        if ev is not None:
            ev.synchronize()
        dropped = int(dropped)
        if dropped > self._cap_dropped_seen:
            n = dropped - self._cap_dropped_seen
            self._cap_dropped_seen = dropped
            self._alert(
                f"archive capacity exhausted: {n} scrolled-out block(s) "
                f"dropped this frame ({dropped} total) — map data is being "
                f"lost; increase cfg.max_blocks (currently "
                f"{self.cfg.max_blocks})")
        if relax_iters is not None and relax_iters >= self.cfg.relax_iters:
            self._alert(
                f"relaxation hit its sweep cap ({relax_iters} >= "
                f"{self.cfg.relax_iters}): the wavefront fixed point may "
                f"not have converged; raise cfg.max_relax_iters")

    def _queue_capacity_guard(self, arch_dropped, relax_iters: int | None):
        """relax_iters: the frame's sweep count on the relax engine, else
        None (the sweep-cap check applies to the relax engine only)."""
        self.check_capacity()
        self._cap_pending = (*self._to_host("capacity", (arch_dropped,)),
                             relax_iters)

    def capacity_report(self) -> dict:
        """Current saturation counters (host view)."""
        return {
            "arch_dropped": self._cap_dropped_seen,
            "n_arch": int(self.state.n_arch),
            "stream_leftover": self._last_leftover,
            "stream_stall_ticks": self._stream_stall,
        }

    # -- changed-block streaming ---------------------------------------------
    def _stream(self, out, origin_blk):
        """Changed-block device->host streaming into the host mirror, in two
        phases: this tick runs the on-device compaction (stream_extract) and
        starts the copies; the rows are ingested on the NEXT tick (or by
        flush_stream), so the copy overlaps the following frames.  Columns
        beyond the per-tick cap carry over in a device-resident mask."""
        if self.mirror is None:
            from ..runtime.host_mirror import HostMirror

            self.mirror = HostMirror(self.cfg)
        self.flush_stream()
        cb = self.cfg.canvas_blocks
        ncols = cb[0] * cb[1]
        if self._stream_carry is None:
            self._stream_carry = torch.zeros(cb, dtype=torch.bool,
                                             device=self.device)
        k_cols = min(self.cfg.stream_k_cols or min(ncols, 64), ncols)
        ids, valid, rows, blk_mask, leftover = stream_extract(
            self.state, out["changed_blk"], self._stream_carry,
            self._stream_rot, cfg=self.cfg, k_cols=k_cols)
        # round-robin service offset: bounded staleness when more columns
        # change per tick than k_cols can serve
        self._stream_rot = (self._stream_rot + k_cols) % ncols
        self._stream_carry = leftover
        self._stream_k_cols = k_cols
        lo_cnt = leftover.any(2).sum(dtype=torch.int32)
        host, ev = self._to_host("stream", (ids, valid, rows, blk_mask, lo_cnt))
        self._stream_pending = (host, ev, np.asarray(origin_blk).copy())

    def flush_stream(self):
        """Ingest the in-flight streamed rows into the host mirror; returns
        the number of blocks ingested."""
        p, self._stream_pending = self._stream_pending, None
        if p is None:
            return 0
        (ids, valid, rows, blk_mask, lo_cnt), ev, origin_blk = p
        if ev is not None:
            ev.synchronize()
        n = self.mirror.ingest_rows(
            ids.numpy(), valid.numpy(), rows.numpy().view(np.uint32),
            blk_mask.numpy(), origin_blk)
        self.stream_ingested += n
        # backlog stall: a leftover the rotation cannot cycle through within
        # stream_stall_ticks ticks, for that many consecutive ticks
        self._last_leftover = int(lo_cnt)
        k = self._stream_k_cols
        if self._last_leftover > self.cfg.stream_stall_ticks * k:
            self._stream_stall += 1
            if (self._stream_stall >= self.cfg.stream_stall_ticks
                    and not self._stall_reported):
                self._stall_reported = True
                self._alert(
                    f"streaming backlog: {self._last_leftover} changed "
                    f"block-column(s) undrained for {self._stream_stall} "
                    f"consecutive ticks (service rate {k} cols/tick) — the "
                    f"host mirror is falling behind; raise "
                    f"cfg.stream_k_cols or lower cfg.vis_interval")
        else:
            self._stream_stall = 0
            self._stall_reported = False
        return n

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

    def process_scan2d(self, proj: geo.Projection, ranges, theta_min,
                       theta_inc):
        """2-D LiDAR frame: ranges [scan_num] (NaN where nothing was hit) of
        beams at theta_min + i * theta_inc in the sensor's z = 0 plane (a
        numpy array or a tensor)."""
        t0 = time.perf_counter()
        cfg, dev = self.cfg, self.device
        proj = self._sensor_proj(proj)
        origin = proj.trans.cpu().numpy().astype(np.float32)
        pvt, origin_blk, off = self._frame_geometry(origin)
        # the pose in float32, as the JAX package packs it into its frame
        # upload (hokuyo_update rounds the angles to float32 too)
        pose = geo.Projection(proj.rot.to(device=dev, dtype=torch.float32),
                              torch.from_numpy(origin).to(dev))
        param = ScanParam(theta_min=float(theta_min),
                          theta_inc=float(theta_inc),
                          ranges=torch.as_tensor(ranges,
                                                 dtype=torch.float32).to(dev))
        inst = hokuyo_update(
            pose, param, pvt, local_size=cfg.local_size,
            voxel_width=cfg.voxel_width, ogm_min_h=cfg.ogm_min_h,
            ogm_max_h=cfg.ogm_max_h,
            for_motion_planner=cfg.for_motion_planner,
            robot_r2_grids=cfg.robot_r2_grids)
        counts = torch.zeros(cfg.local_size, dtype=torch.int32, device=dev)
        return self._run(inst, counts, pvt, origin_blk, off,
                         input_pointcloud=False, t_sensor0=t0)

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
