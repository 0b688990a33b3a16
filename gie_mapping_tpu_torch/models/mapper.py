"""VolumetricMapper of the PyTorch port: the engine's user entry point.

Counterpart of gie_mapping_tpu/models/mapper.py for the four map makers:
`process_pointcloud` (sensor->world transform, the projective carve or the
exact DDA walk, the host-gated canvas scroll, merge) with
`stage_pointcloud`, `process_scan2d` (the 2-D LiDAR model, scroll, merge),
`process_depth` (the depth camera) and `process_multiscan` (the multi-ring
LiDAR); their replay forms `process_pointcloud_batch` (with
`stage_pointcloud_batch`; projective only), `process_scan2d_batch`,
`process_depth_batch` and `process_multiscan_batch`, which plan runs of
frames ahead and dispatch each run through pipeline.replay_frames;
`warmup`, the per-frame output (`FrameOutput`, with the CostMap message
and the planner queries), changed-block streaming to the host mirror
(`_stream` / `flush_stream`) and the capacity monitor
(`CapacityWarning`); the side channels `process_ext_cloud` (DBSCAN fence
boxes) and `process_multiscan_cloud` (a raw ring cloud), checkpoints
(`save` / `load`, the JAX package's file format), the CSV log
(`log_path`) and the ground-truth RMSE checks (`profile_loc_rms`,
`profile_glb_rms`).  The mapper runs on the CUDA device unless it is
given another, or over a device mesh (`mesh=`, parallel/mesh.py: the
canvas sharded along x and the archive along blocks between frames, every
stage run on the shards; one process or one per rank of a process group).
"""
from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..map_state import (MapState, canvas_geometry, resolve_device,
                         shift_block_mask, state_from_numpy, stream_extract)
from ..parallel.mesh import to_numpy
from ..runtime import profiler
from ..utils import geometry as geo
from ..utils.config import (DEFAULT_FENCE_LL, DEFAULT_FENCE_UR, MapConfig,
                            unported_options)
from ..utils.constants import EMPTY_VALUE, VB_WIDTH, VOX_OCCUPIED, VOX_UNKNOWN
from .pipeline import (SENSORS, kernel_limits, merge_frame,
                       pointcloud_sensor, replay_frames, scroll_step)


def _host(v):
    v = np.asarray(v)
    return v.item() if v.ndim == 0 else v


class FrameOutput:
    """Per-frame results (the reference's CostMap).  Fields are device
    tensors (or host numbers) in `raw`; attribute access converts one to
    numpy on first use, `fetch` all of them at once.  A replay's output
    also carries `per_frame`: its run's SCALAR_OUTPUTS as [n] tensors."""

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
                cache[name] = _host(v.cpu().numpy() if isinstance(v, torch.Tensor)
                                    else v)
            return cache[name]
        raise AttributeError(name)

    @property
    def seen(self):
        return self.glb_type != VOX_UNKNOWN

    def device(self, name):
        """The un-fetched tensor (or host number) of a raw output field."""
        return self.raw[name]

    def fetch(self):
        """Bring every field to the host with one copy and one
        synchronisation: the tensors are packed into one byte buffer on
        their device, copied once, and cut apart on the host."""
        names = [k for k in FrameOutput._FIELDS if k in self.raw]
        tens = [k for k in names if isinstance(self.raw[k], torch.Tensor)]
        if tens:
            flat = torch.cat([self.raw[k].contiguous().reshape(-1)
                              .view(torch.uint8) for k in tens]).cpu().numpy()
            at = 0
            for k in tens:
                t = self.raw[k]
                n = t.numel() * t.element_size()
                dt = np.dtype(str(t.dtype).replace("torch.", ""))
                self._cache[k] = _host(flat[at:at + n].view(dt).reshape(t.shape))
                at += n
        for k in names:
            if k not in tens:
                self._cache[k] = _host(self.raw[k])
        return self

    def cost_map(self):
        """SeenDist payload: (d, s, o) per voxel."""
        return {"d": self.edt, "o": self.glb_type, "s": self.seen,
                "origin": self.origin}

    # 8-byte SeenDist record: float d + bool s + bool o + 2 pad bytes (the
    # reference's C struct; float aligns it to 4, so sizeof == 8)
    PAYLOAD8_DTYPE = np.dtype(
        [("d", "<f4"), ("s", "u1"), ("o", "u1"), ("_pad", "V2")])

    def cost_map_msg(self, voxel_width: float):
        """Byte-compatible CostMap message, so a consumer of the reference's
        planner topic parses it unchanged.

        `payload8` is the raw copy of SeenDist[volume] in the reference's
        linear order, x fastest.  The reference's quirks are kept: only `d`
        (the EDT in GRID units; consumers scale by `width`) and `o` (the
        raw glb_type coerced to bool, so truthy = known) are written; `s`
        is never assigned by the reference and is 0 here; the carrot fields
        exist but are never set."""
        d = np.asarray(self.edt, np.float32)
        X, Y, Z = d.shape
        rec = np.zeros((Z, Y, X), dtype=FrameOutput.PAYLOAD8_DTYPE)
        rec["d"] = d.transpose(2, 1, 0)
        rec["o"] = (self.glb_type.transpose(2, 1, 0) != 0).astype(np.uint8)
        origin = np.asarray(self.origin, np.float32)
        return {
            "x_size": X, "y_size": Y, "z_size": Z,
            "x_origin": float(origin[0]),
            "y_origin": float(origin[1]),
            "z_origin": float(origin[2]),
            "width": float(voxel_width),
            "x_carrot": 0.0, "y_carrot": 0.0, "z_carrot": 0.0,
            "type": 1,  # CostMap::TYPE_EDT
            "payload8": rec.tobytes(),
        }

    def local_occupied_cloud(self, voxel_width: float):
        """World positions of the occupied window voxels."""
        idx = np.argwhere(self.glb_type == VOX_OCCUPIED)
        return (idx + self.pvt) * voxel_width

    def local_edt_cloud(self, voxel_width: float):
        """(world positions, distances in metres) of the seen window
        voxels."""
        sel = self.seen
        idx = np.argwhere(sel)
        return (idx + self.pvt) * voxel_width, self.edt[sel] * voxel_width

    def debug_voxel(self, point_world, voxel_width: float):
        """The window voxel that holds a world point: a dict (grid coords,
        type, dist_m, coc in global coords), or None outside the window."""
        g = np.floor(np.asarray(point_world, np.float64) / voxel_width
                     + 0.5).astype(np.int64) - self.pvt
        if np.any(g < 0) or np.any(g >= np.asarray(self.edt.shape)):
            return None
        i, j, k = (int(v) for v in g)
        return {
            "loc": (i, j, k),
            "glb": tuple(int(v) for v in (g + self.pvt)),
            "type": int(self.glb_type[i, j, k]),
            "dist_m": float(self.edt[i, j, k]) * voxel_width,
            "dist_sq_grids": int(self.dist_sq[i, j, k]),
            "coc": tuple(int(v) for v in self.coc[i, j, k]),
        }

    def query_distance(self, points_world, voxel_width: float):
        """Trilinearly interpolated obstacle distance and its gradient at
        world points [..., 3] (metres), for motion planners (host numpy).

        Returns (dist_m [...], grad [..., 3] (d dist / d position,
        unitless), valid [...]: inside the window with all 8 corners
        seen)."""
        pts = np.asarray(points_world, np.float64)
        shp = np.asarray(self.edt.shape)
        g = pts / voxel_width - self.pvt  # voxel centres sit on integers
        g0 = np.floor(g).astype(np.int64)
        inb = np.all((g >= 0) & (g <= shp - 1), axis=-1)
        g0c = np.clip(g0, 0, shp - 2)
        f = np.clip(g - g0c, 0.0, 1.0)

        edt = self.edt
        seen = self.seen
        c = np.empty(pts.shape[:-1] + (2, 2, 2))
        ok = np.ones(pts.shape[:-1], bool)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    ix, iy, iz = g0c[..., 0] + dx, g0c[..., 1] + dy, g0c[..., 2] + dz
                    c[..., dx, dy, dz] = edt[ix, iy, iz]
                    ok &= seen[ix, iy, iz]

        fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
        cz = c[..., 0] * (1 - fz[..., None, None]) + c[..., 1] * fz[..., None, None]
        cy = cz[..., 0] * (1 - fy[..., None]) + cz[..., 1] * fy[..., None]
        s = cy[..., 0] * (1 - fx) + cy[..., 1] * fx
        # analytic trilinear partials (dist is s * voxel_width, position
        # g * voxel_width: the ratio is unitless)
        gx = cy[..., 1] - cy[..., 0]
        by = cz[..., 0, :] * (1 - fx[..., None]) + cz[..., 1, :] * fx[..., None]
        gy = by[..., 1] - by[..., 0]
        bz0 = c[..., 0, 0, :] * (1 - fy[..., None]) + c[..., 0, 1, :] * fy[..., None]
        bz1 = c[..., 1, 0, :] * (1 - fy[..., None]) + c[..., 1, 1, :] * fy[..., None]
        bz = bz0 * (1 - fx[..., None]) + bz1 * fx[..., None]
        gz = bz[..., 1] - bz[..., 0]
        grad = np.stack([gx, gy, gz], axis=-1)
        return s * voxel_width, grad, inb & ok


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

    def append(self, ll, ur):
        """Add one box while there is a free slot (silently full, as in the
        JAX package)."""
        if self.n < self.cfg.max_ext_obs:
            self.ll[self.n] = ll
            self.ur[self.n] = ur
            self.n += 1

    def activate(self, win_ll, win_ur):
        """AABB-vs-window activation; box 0 (the inverted flyable-region
        fence) stays inactive, as in the reference."""
        act = np.zeros(self.cfg.max_ext_obs, bool)
        for i in range(1, self.n):
            act[i] = np.all(self.ll[i] <= win_ur) and np.all(self.ur[i] >= win_ll)
        return act


class VolumetricMapper:
    """The mapping engine: feed poses + sensor frames, read cost maps.
    `device` defaults to "cuda" (an error without a card); pass
    device="cpu" to run the kernels' plain versions on the CPU.  `mesh`
    (parallel.mesh.make_mesh; exclusive with `device`) shards the state
    over the mesh as the JAX package does (the canvas along x, the archive
    along blocks where max_blocks divides) and runs every stage on the
    shards, with results equal to one device's; the window outputs are
    assembled on every process's home device.  With `log_path` (or a profile
    flag) every frame writes a CSV row (runtime/logger.py; in memory when
    log_path is None)."""

    _SELF = object()  # sentinel: "use self._origin"

    def __init__(self, cfg: MapConfig, device=None,
                 log_path: Optional[str] = None, mesh=None):
        with profiler.span("mapper.create"):
            self._create(cfg, device, log_path, mesh)

    def _create(self, cfg: MapConfig, device, log_path, mesh):
        if device is not None and mesh is not None:
            raise ValueError("device and mesh are mutually exclusive: a mesh "
                             "places state across its own devices")
        bad = unported_options(cfg)
        if bad:
            raise NotImplementedError(
                "not ported to PyTorch yet: " + ", ".join(bad))
        if mesh is not None:
            device = mesh.devices[0]
        # shards see the full X in phase 2 and the full Z in phase 3, so
        # the limits are the same under a mesh
        if torch.device("cuda" if device is None else device).type == "cuda":
            bad = kernel_limits(cfg)
            if bad:
                raise NotImplementedError(
                    "beyond the CUDA kernels' limits: " + ", ".join(bad))
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device, "VolumetricMapper")
        self.state = self._fresh_state()
        self.ext_obs = _ExtObs(cfg)
        self._origin = None  # host mirror of the canvas origin
        self._last_pvt = None
        self._fence_cache = None
        self.map_ct = 0
        # replay: frames run inside planned runs and the scrolls among them
        # (the rest went through the per-frame path)
        self.replay_scanned_frames = 0
        self.replay_scanned_scrolls = 0
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
        self.logger = None
        if log_path is not None or cfg.profile_loc_rms or cfg.profile_glb_rms:
            from ..runtime.logger import CsvLogger

            self.logger = CsvLogger(log_path)
        self.gt_checker = None
        if cfg.profile_loc_rms or cfg.profile_glb_rms:
            from ..runtime.gt_checker import GroundTruthChecker

            self.gt_checker = GroundTruthChecker()

    def _fresh_state(self) -> MapState:
        """A fresh map on the mapper's device or placed on its mesh."""
        if self.mesh is None:
            return MapState.create(self.cfg, self.device)
        return MapState.create(self.cfg, mesh=self.mesh)

    def warmup(self, robot_pos=(0.0, 0.0, 0.0)):
        """Run one empty frame on a throwaway state so the first real frame
        pays no one-time cost (kernel build, allocator growth).  Records the
        pivot like the JAX package's warmup does (`_frame_geometry`), so the
        first real frame's placement matches it."""
        cfg = self.cfg
        pvt, origin_blk, off = self._frame_geometry(
            np.asarray(robot_pos, np.float32))
        throwaway, shift = scroll_step(self._fresh_state(), origin_blk, cfg=cfg)
        fence, fence_on = self._fence_args(pvt)
        zeros8 = torch.zeros(cfg.local_size, dtype=torch.int8, device=self.device)
        zeros32 = torch.zeros(cfg.local_size, dtype=torch.int32, device=self.device)
        merge_frame(throwaway, zeros8, zeros32, pvt, origin_blk, off, fence,
                    cfg=cfg, input_pointcloud=False, use_fence=fence_on,
                    enter_shift=shift, mesh=self.mesh)
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

    def _scroll_compact_rows(self, origin_blk, prev):
        """(rows, cols) of a scroll, as the JAX package buckets them: rows
        upper-bounds the blocks that exit or enter, NB - prod(cb - |shift|),
        rounded up to 256 / 1024 / 2048; a larger scroll gets (NB, NCOLS)
        when NB <= 8192, else (None, None).  The port's scroll sizes its
        buffers by `cols` alone; the replay planner breaks a run where rows
        is None or NB (a teleport-scale scroll), as the JAX planner does."""
        shift = np.abs(np.asarray(origin_blk, np.int64) - np.asarray(prev, np.int64))
        cb = np.asarray(self.cfg.canvas_blocks, np.int64)
        nb = int(cb.prod())
        cols = self._scroll_compact_cols(origin_blk, prev)
        bound = nb - int(np.maximum(cb - shift, 0).prod())
        rows = next((s for s in (256, 1024, 2048) if bound <= s <= nb), None)
        if rows is None and nb <= 8192:
            return nb, int(cb[0] * cb[1])
        return rows, (cols if rows is not None else None)

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
            with profiler.span("scroll"):
                self.state, enter_shift = scroll_step(
                    self.state, origin_blk, cfg=cfg, compact_cols=cols,
                    old_origin_blk=prev)
        self.state, out = merge_frame(
            self.state, inst_type, ray_count, pvt, origin_blk, off, fence,
            cfg=cfg, input_pointcloud=input_pointcloud, use_fence=fence_on,
            enter_shift=enter_shift, mesh=self.mesh)
        t_end = time.perf_counter()
        self.map_ct += 1
        result = FrameOutput(out, origin=pvt.astype(np.float32) * cfg.voxel_width,
                             pvt=pvt)
        result.ogm_time_ms = (t_ogm - t_sensor0) * 1e3
        result.edt_time_ms = (t_end - t_ogm) * 1e3
        self.last_output = result
        if (cfg.display_glb_edt or cfg.display_glb_ogm) and (
                self.map_ct % cfg.vis_interval == 0):
            with profiler.span("stream"):
                self._stream(out, origin_blk)
        self._queue_capacity_guard(
            out["arch_dropped"],
            out["relax_iters"] if cfg.merge_mode == "relax" else None)
        # profiling (the reference's visualize(): RMSE check and CSV row):
        # profile_loc_rms checks the window EDT, profile_glb_rms the
        # streamed global mirror
        if self.gt_checker is not None and self.map_ct % cfg.vis_interval == 0:
            if cfg.profile_loc_rms:
                self.gt_checker.check_frame(result, cfg.voxel_width,
                                            self.logger)
            if cfg.profile_glb_rms and self.mirror is not None:
                self.flush_stream()  # ingest the in-flight rows first
                self.gt_checker.check_global(self.mirror, cfg.voxel_width,
                                             self.logger)
        if self.logger is not None:
            self.logger.log_frame(result.ogm_time_ms, result.edt_time_ms,
                                  self.logger.take_pending_rmse(),
                                  self._cap_dropped_seen, self._last_leftover)
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
        with profiler.span("capacity.wait"):
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

    # -- side channels -------------------------------------------------------
    def process_ext_cloud(self, points, premap_ll=None, premap_ur=None):
        """External-observer point cloud -> DBSCAN clusters -> fence boxes
        (the reference's CB_ext_cld): the box set is reset to the prior map
        (the default fence unless given), then one AABB per cluster is
        appended.  Returns the number of boxes."""
        from ..runtime.clustering import cloud_to_fence_boxes

        if premap_ll is None:
            premap_ll, premap_ur = [DEFAULT_FENCE_LL], [DEFAULT_FENCE_UR]
        self.ext_obs.assign(premap_ll, premap_ur)
        for ll, ur in cloud_to_fence_boxes(points, self.cfg.is_ext_obsv_3D):
            self.ext_obs.append(ll, ur)
        return self.ext_obs.n

    def process_multiscan_cloud(self, proj: geo.Projection, points, ring_idx,
                                ring_num=16, scan_num=360,
                                phi_min=-0.2617994, phi_inc=0.0349066):
        """Multi-ring LiDAR frame from a raw cloud (points [N, 3] in the
        sensor frame, ring_idx [N]): binned into range rings on the host
        (runtime/rings.py), then process_multiscan."""
        from ..runtime.rings import cloud_to_rings

        rings_img, tmin, tinc = cloud_to_rings(points, ring_idx, ring_num,
                                               scan_num)
        return self.process_multiscan(proj, rings_img, tmin, tinc, phi_min,
                                      phi_inc)

    # -- checkpoints -----------------------------------------------------------
    CHECKPOINT_FIELDS = ("origin_blk", "occ_val", "vox_type", "dist_sq", "coc",
                         "present", "arch_keys", "n_arch", "a_packed",
                         "arch_dropped")

    @property
    def _host_owner(self) -> bool:
        """Whether this process owns the host-side products (the mirror,
        checkpoint files): the single controller, or rank 0 of a group."""
        return self.mesh is None or self.mesh.rank == 0

    def save(self, path: str):
        """Write the map to a compressed npz in the JAX package's format
        (version 3: the same keys and dtypes, a_packed as uint32), so a file
        loads in either package.  Under a process group every rank takes
        part in the gather and rank 0 writes."""
        arrays = {}
        for k in self.CHECKPOINT_FIELDS:
            a = to_numpy(getattr(self.state, k))  # a sharded field gathered
            arrays[f"state/{k}"] = a.view(np.uint32) if k == "a_packed" else a
        arrays["meta/map_ct"] = np.asarray(self.map_ct)
        arrays["meta/version"] = np.asarray(3)  # v3: relative coc anchors
        if self._host_owner:  # every rank gathers; rank 0 writes
            np.savez_compressed(path, **arrays)

    def load(self, path: str):
        """Read a version-3 checkpoint of either package (the flat [B, 1536]
        archive or the older [B, 512, 3]) onto the mapper's device.  As in
        the JAX package, the per-cell distance bound and the phase-1 cache
        are not stored: the bound resets to EMPTY_VALUE and the cache is
        marked stale (the gate's first frame runs its full branch), and the
        next frame re-places the canvas.  Under a mesh each process copies
        its own shards of the file's arrays to its devices."""
        raw = np.load(path)
        version = int(raw["meta/version"]) if "meta/version" in raw.files else 1
        if version != 3:
            raise ValueError(
                f"checkpoint format v{version} not supported (current: v3 — "
                "canvas/block-relative coc anchors)")
        arrays = {k.split("/", 1)[1]: raw[k] for k in raw.files
                  if k.startswith("state/")}
        ap = arrays["a_packed"]
        if ap.ndim == 3:  # [B, 512, 3] from before the flat-row archive
            arrays["a_packed"] = ap.reshape(ap.shape[0], -1)
        arrays["dmax_cell"] = np.full(
            tuple(c // 4 for c in self.cfg.canvas_size), EMPTY_VALUE, np.int32)
        arrays["p1c"] = np.zeros((1, 1, 1), np.int32)  # replaced below
        arrays["p1c_ok"] = np.zeros((), bool)
        p1c = self.state.p1c  # kept, as in the JAX package (marked stale)
        self.state = (state_from_numpy(arrays, self.device) if self.mesh is None
                      else state_from_numpy(arrays, mesh=self.mesh))
        self.state.p1c = p1c
        self.map_ct = int(raw["meta/map_ct"])
        self._origin = None  # the next frame re-syncs the canvas
        return self

    # -- changed-block streaming ---------------------------------------------
    def _stream(self, out, origin_blk):
        """Changed-block device->host streaming into the host mirror, in two
        phases: this tick runs the on-device compaction (stream_extract) and
        starts the copies; the rows are ingested on the NEXT tick (or by
        flush_stream), so the copy overlaps the following frames.  Columns
        beyond the per-tick cap carry over in a device-resident mask.  Under
        a mesh the compaction sums the shards' rows on every process; only
        the mirror's owner (rank 0 of a process group) copies them."""
        if self.mirror is None and self._host_owner:
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
        if not self._host_owner:
            return
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
        with profiler.span("stream.wait"):
            if ev is not None:
                ev.synchronize()
        n = self.mirror.ingest_rows(
            ids.numpy(), valid.numpy(), rows.numpy().view(np.uint32),
            blk_mask.numpy(), origin_blk)
        self.stream_ingested += n
        # backlog stall: a leftover the rotation cannot cycle through within
        # stream_stall_ticks ticks, for that many consecutive ticks
        self._last_leftover = int(lo_cnt)
        profiler.count("stream.backlog_cols", self._last_leftover)
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

    def _process_sensor(self, kind, proj, data, row7, row8=()):
        """One frame of a projection sensor (`kind`, a key of
        pipeline.SENSORS): data is its measurement (a numpy array or a
        tensor); row7 and row8 its scalars, carried as float32 as the JAX
        package packs them into pose rows 7-8."""
        with profiler.span("frame", frame=self.map_ct + 1):
            t0 = time.perf_counter()
            proj = self._sensor_proj(proj)
            origin = proj.trans.cpu().numpy().astype(np.float32)
            pvt, origin_blk, off = self._frame_geometry(origin)
            sc = self._sensor_scalars(1, row7, row8)[0]
            with profiler.span("sensor.stage"):
                data = torch.as_tensor(data, dtype=torch.float32).to(self.device)
            rot = proj.rot.cpu().numpy()
            with profiler.span("sensor"):
                inst, counts = SENSORS[kind](data, rot, origin, sc[0], sc[1],
                                             pvt, cfg=self.cfg)
            del data  # the staged measurement is freed before the merge
            return self._run(inst, counts, pvt, origin_blk, off,
                             input_pointcloud=False, t_sensor0=t0)

    def process_scan2d(self, proj: geo.Projection, ranges, theta_min,
                       theta_inc):
        """2-D LiDAR frame: ranges [scan_num] (NaN where nothing was hit) of
        beams at theta_min + i * theta_inc in the sensor's z = 0 plane (a
        numpy array or a tensor)."""
        return self._process_sensor("scan", proj, ranges,
                                    (theta_min, theta_inc))

    def process_depth(self, proj: geo.Projection, depth, fx, fy, cx, cy):
        """Depth-camera frame: depth [rows, cols], the forward (x) distance
        per pixel (NaN where nothing was measured; cfg.valid_nan reads NaN
        as far), with pinhole intrinsics fx, fy, cx, cy; pixel (u, v) of a
        sensor-frame point (x, y, z) is (-y fx / x + cx, -z fy / x + cy)."""
        return self._process_sensor("depth", proj, depth, (fx, fy, cx),
                                    (cy,))

    def process_multiscan(self, proj: geo.Projection, rings, theta_min,
                          theta_inc, phi_min, phi_inc):
        """Multi-ring spinning-LiDAR frame: rings [ring_num, scan_num], the
        horizontal range of the beam at elevation phi_min + i * phi_inc and
        azimuth theta_min + j * theta_inc (NaN where nothing was hit)."""
        return self._process_sensor("multiscan", proj, rings,
                                    (theta_min, theta_inc, phi_min),
                                    (phi_inc,))

    def process_pointcloud(self, proj: geo.Projection, points_sensor,
                           valid=None):
        """Point-cloud frame: points_sensor [N, 3] float32 in the SENSOR
        frame (a numpy array, or a tensor pair from stage_pointcloud).  With
        cfg.fuse_raycast on the projective model the sensor->world
        transform rounds as the JAX package's frame program rounds it (it
        moves there), else (and always with raycast_mode "dda") as its
        eager transform."""
        with profiler.span("frame", frame=self.map_ct + 1):
            t0 = time.perf_counter()
            proj = self._sensor_proj(proj)
            origin = proj.trans.cpu().numpy().astype(np.float32)
            pvt, origin_blk, off = self._frame_geometry(origin)
            with profiler.span("sensor.stage"):
                if isinstance(points_sensor, torch.Tensor) and valid is not None:
                    buf, vmask = (points_sensor.to(self.device),
                                  valid.to(self.device))
                else:
                    buf, vmask = self.stage_pointcloud(points_sensor,
                                                       valid=valid)
            rot = proj.rot.cpu().numpy()
            with profiler.span("sensor"):
                inst, counts = pointcloud_sensor(
                    buf, vmask, rot, origin, pvt, cfg=self.cfg,
                    fused=(self.cfg.fuse_raycast
                           and self.cfg.raycast_mode == "projective"))
            return self._run(inst, counts, pvt, origin_blk, off,
                             input_pointcloud=True, t_sensor0=t0)

    # -- batched replay (throughput mode) ------------------------------------
    # the smallest compacted-scroll buckets; a canvas smaller than both
    # scrolls any shift inside a run
    REPLAY_ROWS, REPLAY_COLS = 256, 32

    def stage_pointcloud_batch(self, clouds, pad_to=None):
        """Upload K point clouds as stacked tensors ([K, N, 3] float32,
        [K, N] bool) for process_pointcloud_batch; N is the batch's
        live-point bucket (one for the whole batch), or `pad_to`."""
        cfg = self.cfg
        K = len(clouds)
        sizes = [min(len(np.asarray(p)), cfg.max_raycast_points)
                 for p in clouds]
        cap = pad_to or self._pc_bucket(max(sizes, default=0),
                                        cfg.max_raycast_points)
        buf = np.zeros((K, cap, 3), np.float32)
        vmask = np.zeros((K, cap), bool)
        for i, pts in enumerate(clouds):
            n = sizes[i]
            buf[i, :n] = np.asarray(pts, np.float32)[:n]
            vmask[i, :n] = True
        return (torch.from_numpy(buf).to(self.device),
                torch.from_numpy(vmask).to(self.device))

    def process_pointcloud_batch(self, projs, points, valids, chunk: int = 10):
        """Replay mode: K point-cloud frames whose poses are known ahead.
        The host plans runs of up to `chunk` frames (scroll decisions and
        their bounds, fence activation) and runs each through
        pipeline.replay_frames, whose frames before the last build no
        window outputs; frames no run can take (a fresh map, a
        teleport-scale scroll, a fence flip, a tail shorter than every
        rung of the ladder) go through process_pointcloud.  The state
        evolves bit for bit as in the per-frame loop.  Streaming runs once
        per run over the union of its changed blocks.

        projs: K Projections; points [K, N, 3] float32 sensor-frame clouds
        and valids [K, N] bool, tensors (see stage_pointcloud_batch) or
        host arrays.  Requires
        raycast_mode "projective" and fuse_raycast, as the JAX package
        does.  Returns the last frame's FrameOutput; when that frame ran
        in a run, `.per_frame` holds the run's scalars."""
        cfg = self.cfg
        if not (cfg.raycast_mode == "projective" and cfg.fuse_raycast):
            raise ValueError(
                "process_pointcloud_batch requires raycast_mode='projective' "
                "and fuse_raycast (the in-scan sensor path)")
        points = torch.as_tensor(points, dtype=torch.float32).to(self.device)
        valids = torch.as_tensor(valids, dtype=torch.bool).to(self.device)
        return self._process_batch(
            projs, chunk=chunk, input_pointcloud=True, sensor_kind=None,
            data={"points": points, "pts_valid": valids}, scalars=None,
            fallback=lambda i: self.process_pointcloud(
                projs[i], points[i], valids[i]))

    def _sensor_batch(self, kind, projs, data, row7, row8=(), chunk=10):
        """Replay of projection-sensor frames (see process_pointcloud_batch):
        data [K, ...] is the frames' measurements; row7 and row8 hold the
        scalars of pose rows 7-8, each a scalar or a [K] array."""
        K = len(projs)
        sc = self._sensor_scalars(K, [np.broadcast_to(v, K) for v in row7],
                                  [np.broadcast_to(v, K) for v in row8])
        data = torch.as_tensor(data, dtype=torch.float32).to(self.device)
        return self._process_batch(
            projs, chunk=chunk, input_pointcloud=False, sensor_kind=kind,
            data={"sensor_data": data}, scalars=sc,
            fallback=lambda i: self._process_sensor(kind, projs[i], data[i],
                                                    sc[i, 0], sc[i, 1]))

    def process_scan2d_batch(self, projs, ranges, theta_min, theta_inc,
                             chunk: int = 10):
        """Replay of 2-D LiDAR frames (see process_pointcloud_batch).
        `ranges` is [K, n_beams]; theta_min and theta_inc are scalars or
        [K] arrays, carried as float32."""
        return self._sensor_batch("scan", projs, ranges,
                                  (theta_min, theta_inc), chunk=chunk)

    def process_depth_batch(self, projs, depths, fx, fy, cx, cy,
                            chunk: int = 10):
        """Replay of depth-camera frames (see process_pointcloud_batch).
        `depths` is [K, rows, cols]; the intrinsics are scalars or [K]
        arrays, carried as float32."""
        return self._sensor_batch("depth", projs, depths, (fx, fy, cx), (cy,),
                                  chunk=chunk)

    def process_multiscan_batch(self, projs, rings, theta_min, theta_inc,
                                phi_min, phi_inc, chunk: int = 10):
        """Replay of multi-ring LiDAR frames (see process_pointcloud_batch).
        `rings` is [K, ring_num, scan_num]; the bin geometry is scalars or
        [K] arrays, carried as float32."""
        return self._sensor_batch("multiscan", projs, rings,
                                  (theta_min, theta_inc, phi_min), (phi_inc,),
                                  chunk=chunk)

    @staticmethod
    def _sensor_scalars(K, row0, row1=()):
        """[K, 2, 3] float32 per-frame sensor scalars (pose rows 7-8)."""
        sc = np.zeros((K, 2, 3), np.float32)
        for c, v in enumerate(row0):
            sc[:, 0, c] = v
        for c, v in enumerate(row1):
            sc[:, 1, c] = v
        return sc

    def _fence_key(self, pvt):
        """Fence-box activation at a window pivot: a run holds one, so runs
        break where the per-frame path would see it change."""
        win_ll = pvt.astype(np.float32) * self.cfg.voxel_width
        win_ur = win_ll + np.asarray(self.cfg.local_size_m, np.float32)
        return self.ext_obs.activate(win_ll, win_ur).tobytes()

    def _plan_run(self, projs, i, chunk, use_compact):
        """Up to `chunk` frames from frame i that one run can take: [(pvt,
        origin_blk, off, scrolled, frame index, compact cols)].  Walks the
        canvas origin and the motion anchor ahead without moving either."""
        cfg = self.cfg
        nb = int(np.prod(cfg.canvas_blocks))
        prev = None if self._origin is None else self._origin.copy()
        prev_pvt = self._last_pvt
        plan, fkey0 = [], None
        for j in range(i, min(i + chunk, len(projs))):
            trans = projs[j].trans.cpu().numpy().astype(np.float32)
            pvt, origin_blk, off = self._frame_geometry(
                trans, origin=prev,
                motion=(None if prev_pvt is None else
                        geo.calculate_pivot(trans, cfg.voxel_width,
                                            cfg.local_size) - prev_pvt))
            prev_pvt = pvt.copy()
            scroll = prev is None or not np.array_equal(prev, origin_blk)
            cols = None
            if scroll:
                if prev is None:
                    break  # a fresh map: the per-frame path places it
                rows, cols = self._scroll_compact_rows(origin_blk, prev)
                if use_compact and (rows is None or rows >= nb):
                    break  # teleport-scale: the per-frame path
                if not use_compact:
                    cols = None  # every column
            fkey = self._fence_key(pvt)
            if fkey0 is None:
                fkey0 = fkey
            elif fkey != fkey0:
                break  # the fence activation flips
            plan.append((pvt, origin_blk, off, scroll, j, cols))
            if scroll:
                prev = origin_blk.copy()
        return plan

    def _process_batch(self, projs, *, chunk, input_pointcloud, sensor_kind,
                       data, scalars, fallback):
        """The replay driver of both sensors: plans a run, runs the longest
        rung of the ladder {chunk, chunk/2, chunk/4, 5, 2} that the plan
        covers through pipeline.replay_frames, or one frame through
        `fallback(i)` when no rung fits, and repeats."""
        cfg = self.cfg
        projs = [self._sensor_proj(p) for p in projs]
        K = len(projs)
        cb = np.asarray(cfg.canvas_blocks, np.int64)
        # a canvas smaller than the minimum buckets scrolls any shift
        # inside a run (every column moves)
        use_compact = (int(cb.prod()) >= self.REPLAY_ROWS
                       and int(cb[0] * cb[1]) >= self.REPLAY_COLS)
        ladder = sorted({chunk, max(chunk // 2, 2), max(chunk // 4, 2), 5, 2},
                        reverse=True)
        ladder = [L for L in ladder if L <= max(chunk, 2)]
        result = None
        i = 0
        while i < K:
            plan = self._plan_run(projs, i, chunk, use_compact)
            run_len = next((L for L in ladder if len(plan) >= L), 0)
            if run_len == 0:
                result = fallback(i)
                i += 1
                continue
            plan = plan[:run_len]
            with profiler.span("frame", frame=self.map_ct + 1):
                t0 = time.perf_counter()
                n = len(plan)
                pose_h = np.zeros((n, 9, 3), np.float32)
                scrolled = np.zeros(n, bool)
                for k, (pvt, origin_blk, off, scr, idx, _) in enumerate(plan):
                    pose_h[k, 0], pose_h[k, 1], pose_h[k, 2] = pvt, origin_blk, off
                    pose_h[k, 3:6] = projs[idx].rot.cpu().numpy()
                    pose_h[k, 6] = projs[idx].trans.cpu().numpy()
                    if scalars is not None:
                        pose_h[k, 7:9] = scalars[idx]
                    scrolled[k] = scr
                fence, fence_on = self._fence_args(plan[0][0])
                start_origin = self._origin.copy()
                if sensor_kind is None:
                    frames = {"points": data["points"][i:i + n],
                              "pts_valid": data["pts_valid"][i:i + n]}
                else:
                    frames = {"sensor_data": data["sensor_data"][i:i + n],
                              "sensor_kind": sensor_kind}
                self.state, out, changed_union, per_frame = replay_frames(
                    self.state, pose_h, scrolled, fence, cfg=cfg,
                    origin_blk=start_origin, input_pointcloud=input_pointcloud,
                    use_fence=fence_on, compact_cols=[c for *_, c in plan],
                    has_scrolls=bool(scrolled.any()), mesh=self.mesh, **frames)
                last = plan[-1]
                self._origin = np.asarray(last[1]).copy()
                self._last_pvt = np.asarray(last[0]).copy()  # motion-bias anchor
                self.map_ct += n
                self.replay_scanned_frames += n
                self.replay_scanned_scrolls += int(scrolled.sum())
                result = FrameOutput(
                    out, origin=last[0].astype(np.float32) * cfg.voxel_width,
                    pvt=last[0])
                result.per_frame = per_frame
                dt = (time.perf_counter() - t0) * 1e3 / n
                result.edt_time_ms = dt  # the run's dispatch time per frame
                self.last_output = result
                if cfg.display_glb_edt or cfg.display_glb_ogm:
                    # once per run, whatever vis_interval says
                    if self._stream_carry is not None:
                        self._stream_carry = shift_block_mask(
                            self._stream_carry,
                            self._origin.astype(np.int64) - start_origin)
                    with profiler.span("stream"):
                        self._stream({"changed_blk": changed_union},
                                     self._origin)
                # arch_dropped is cumulative (the last frame covers the run);
                # the sweep cap is checked on the run's largest sweep count
                self._queue_capacity_guard(
                    per_frame["arch_dropped"][-1],
                    int(per_frame["relax_iters"].max())
                    if cfg.merge_mode == "relax" else None)
                if self.logger is not None:  # a row per frame, no RMSE check
                    for _ in range(n):
                        self.logger.log_frame(0.0, dt,
                                              self.logger.take_pending_rmse(),
                                              self._cap_dropped_seen,
                                              self._last_leftover)
            i += n
        return result
