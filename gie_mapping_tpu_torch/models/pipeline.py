"""The per-frame map update of the PyTorch port.

Counterpart of gie_mapping_tpu/models/pipeline.py: the frames' sensor
models (`pointcloud_sensor`, `scan_sensor`, `depth_sensor`,
`multiscan_sensor`), the host-gated canvas
scroll (`scroll_step`, the scroll half of scroll_frame_step), the replay
of a planned run of frames (`replay_frames`), block
allocation, occupancy fusion, the change-gated exact canvas EDT
(`_gated_canvas_merge`, with its slab menu, block P-test, phase-1 cache and
zero-site constant fill), the ungated full EDT below `edt_gate_min_vox`, the relax engine
(merge_mode="relax": window EDT, reconciliation, raise wave, fixed point;
one host sync per four sweeps), frontier marking and changed-block
tracking.  Every output is bit-identical to the JAX package's.

Where the JAX package chooses a branch on the device (`lax.switch` over the
EDT slab menu and over the phase-1 patch size), the port reads the choice
back once per frame and runs the chosen branch: the branches have different
static slab shapes.  That is one small device-to-host copy and a host sync
per frame.

Window offsets, pivots and origins are host integers (numpy), as the JAX
mapper computes them; every crop is a plain slice.

Under a device mesh (`mesh=`, parallel/mesh.py) the canvas fields are
x-shards (parallel.mesh.Sharded) between frames and within them: every
canvas stage is written once over the parts this process drives
(parallel.mesh.smap, sbuild, splice), the window crops and the frontier
halo are gathered x-ranges of the window's size, the block and cell masks
reduce over the shards, and the gate's nine scalars come from one
all-reduce, so every shard and process takes the same branch.  The canvas
EDT takes the JAX package's sharded arms: batch_edt_sharded for the full
branch, batch_edt_sharded_slab (y lanes only: the slab spans all of x) for
the gate's slabs, and no phase-1 cache.  The gate runs under a mesh only
where sharded_edt_ok holds, as in the JAX package.  The window, the sensor
model and the block grids are replicated (on each process's home device).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..map_state import (COC_INVALID16, MapState, scroll_canvas,
                         shift_block_mask)
from ..ops import raycast as rc
from ..ops.edt_batch import (batch_edt, batch_edt_sharded,
                              batch_edt_sharded_slab, batch_edt_slab,
                              sharded_edt_ok)
from ..ops.fusion import _fence_mask, _lowpass
from ..ops.kernels.envelope import ENVELOPE_MID_MAX_N, ENVELOPE_PACKED_MAX_N
from ..ops.kernels.phase1 import phase1_fits, phase1_packed
from ..ops.scan_sensors import (CamParam, MulScanParam, ScanParam,
                                hokuyo_update, realsense_update, vlp16_update)
from ..ops.wave import (invalidate_disappeared, mark_frontiers,
                        reconcile_window, relax_fixed_point)
from ..parallel.mesh import (Sharded, all_reduce, block_reduce, crop,
                             parts_of, sbuild, smap, splice)
from ..runtime import profiler
from ..utils import constants as _c
from ..utils import geometry as geo
from ..utils.config import MapConfig
from ..utils.floats import div_const, sqrt_f32
from ..utils.constants import (EMPTY_VALUE, VB_WIDTH, VOX_FNT, VOX_FREE,
                               VOX_OCCUPIED, VOX_UNKNOWN)

DEFAULT_MENU_FRACS = ((3, 16), (5, 16), (3, 8), (5, 8))
INV16 = int(COC_INVALID16)
# the per-frame scalars every merge_frame returns (the replay's per_frame)
SCALAR_OUTPUTS = ("relax_iters", "fnt_count", "arch_dropped", "gate_level",
                  "gate_slab_vox")


def _slab_menu(canvas_size, fracs=DEFAULT_MENU_FRACS):
    """Static (SX, SY) slab-size ladder for the change-gated EDT (multiples
    of 8, ascending, each strictly smaller than the canvas)."""
    X, Y, _ = canvas_size
    r8 = lambda v, n: min(-(-v // 8) * 8, n)
    menu = []
    for num, den in fracs:
        sx, sy = r8(X * num // den, X), r8(Y * num // den, Y)
        if (sx, sy) not in menu and sx < X and sy < Y:
            menu.append((sx, sy))
    return menu


def _menu_fracs(cfg):
    return cfg.edt_gate_menu or DEFAULT_MENU_FRACS


def gate_enabled(cfg, mesh=None) -> bool:
    """Whether this config runs the change-gated EDT (else one full EDT);
    under a mesh only where the sharded EDT takes the canvas."""
    X, Y, Z = cfg.canvas_size
    return (cfg.merge_mode == "canvas_edt" and cfg.edt_gate and Z > 1
            and bool(_slab_menu(cfg.canvas_size, _menu_fracs(cfg)))
            and (mesh is None or sharded_edt_ok(cfg.canvas_size, mesh))
            and X * Y * Z >= cfg.edt_gate_min_vox)


def p1_cache_enabled(cfg, mesh=None) -> bool:
    """Whether this config maintains the phase-1 cache (MapState.p1c);
    never under a mesh."""
    return (mesh is None and gate_enabled(cfg) and cfg.edt_p1_cache
            and phase1_fits(cfg.canvas_size[1]))


def kernel_limits(cfg) -> list:
    """What the card's kernels cannot take in this config's EDT (empty when
    they take it all).  The canvas engine's EDT runs on the canvas, the
    relax engine's on the window.  Phase 1 needs Y <= 1024; on a 3-D grid
    the phase-2 envelope takes X <= ENVELOPE_PACKED_MAX_N sites and the
    phase-3 one Z <= ENVELOPE_MID_MAX_N; a Z == 1 grid runs phase 2 through
    the generic envelope, which takes X <= ENVELOPE_MID_MAX_N."""
    grid = cfg.canvas_size if cfg.merge_mode == "canvas_edt" else cfg.local_size
    X, Y, Z = grid
    what = "canvas" if cfg.merge_mode == "canvas_edt" else "window"
    bad = []
    if not phase1_fits(Y):
        bad.append(f"{what} Y = {Y} > 1024 (phase 1)")
    if Z > 1 and X > ENVELOPE_PACKED_MAX_N:
        bad.append(f"{what} X = {X} > {ENVELOPE_PACKED_MAX_N} (phase 2)")
    if Z == 1 and X > ENVELOPE_MID_MAX_N:
        bad.append(f"{what} X = {X} > {ENVELOPE_MID_MAX_N} (phase 2, Z == 1)")
    if Z > ENVELOPE_MID_MAX_N:
        bad.append(f"{what} Z = {Z} > {ENVELOPE_MID_MAX_N} (phase 3)")
    return bad


def _axis_lohi(mask1d: torch.Tensor):
    """(first, last) true index of a bool [n] (sentinels (n, -1) if none)."""
    n = mask1d.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=mask1d.device)
    lo = torch.where(mask1d, idx, n).amin()
    hi = torch.where(mask1d, idx, -1).amax()
    return lo, hi


def _expand_blocks(blk: torch.Tensor) -> torch.Tensor:
    """bool block grid -> voxel grid (x VB_WIDTH per axis)."""
    for ax in range(3):
        blk = blk.repeat_interleave(VB_WIDTH, dim=ax)
    return blk


def _block_any(m: torch.Tensor, g: int) -> torch.Tensor:
    X, Y, Z = m.shape
    return m.reshape(X // g, g, Y // g, g, Z // g, g).any(5).any(3).any(1)


def _box(off, size):
    return tuple(slice(int(o), int(o) + int(s)) for o, s in zip(off, size))


def _clip(v, lo, hi):
    return min(max(v, lo), hi)


def _in_box(t, box):
    """t[box], part by part; on a Sharded field the box spans all of x (the
    sharded axis)."""
    if not isinstance(t, Sharded):
        return t[box]
    if (box[0].start, box[0].stop) != (0, t.extent):
        raise ValueError("a box over an x-sharded field must span all of x")
    return smap(lambda q: q[(slice(None),) + tuple(box[1:])], t)


def _with_box(t, box, v):
    """A copy of t with t[box] = v (v laid out as _in_box gives it)."""
    rest = (slice(None),) + tuple(box[1:]) if isinstance(t, Sharded) else box

    def put(q, w):
        q = q.clone()
        q[rest] = w
        return q

    return smap(put, t, v)


def _expanded(like_t, blk):
    """The voxel mask of block grid `blk`, placed as `like_t` (of the
    mask's extent): each part takes its own x-range."""
    vox = _expand_blocks(blk)
    return sbuild(like_t, lambda lo, hi, d: vox[lo:hi].to(d))


def _window_mask(like_t, wb):
    """bool canvas, True in the window box wb, placed as like_t."""
    z = sbuild(like_t, lambda lo, hi, d: torch.zeros(
        (hi - lo,) + tuple(like_t.shape[1:3]), dtype=torch.bool, device=d))
    ones = torch.ones(tuple(s.stop - s.start for s in wb), dtype=torch.bool,
                      device=parts_of(z)[0].device)
    return splice(z, wb, ones, inplace=True)


def _window_blocks(m, off, cb):
    """Block-any of a window mask m (at canvas offset off) as a [bx, by,
    bz] grid (the window lies inside the canvas)."""
    lo = [int(o) // VB_WIDTH for o in off]
    hi = [-(-(int(o) + n) // VB_WIDTH) for o, n in zip(off, m.shape)]
    q = torch.zeros(tuple((h - l) * VB_WIDTH for l, h in zip(lo, hi)),
                    dtype=torch.bool, device=m.device)
    q[_box([int(o) - l * VB_WIDTH for o, l in zip(off, lo)], m.shape)] = m
    out = torch.zeros(cb, dtype=torch.bool, device=m.device)
    out[tuple(slice(l, h) for l, h in zip(lo, hi))] = _block_any(q, VB_WIDTH)
    return out


def _finalize_parts(cfg, dist_state, coc_state, edt, obs, pres, win):
    """_finalize over the parts of (possibly) sharded fields."""
    return smap(lambda d, c, v, ed, ec, o, p, w: _finalize(
        cfg, d, c, {"valid": v, "dist_sq": ed, "coc": ec}, o, p, w),
        dist_state, coc_state, edt["valid"], edt["dist_sq"], edt["coc"], obs,
        pres, win)


def _finalize(cfg, dist_state_s, coc_state_s, edt, obs_s, pres_s, win_s):
    """keep_old (limited-observation memory) + take selects on a crop."""
    cs_arr = torch.tensor(cfg.canvas_size, dtype=torch.int32,
                          device=dist_state_s.device)
    valid = edt["valid"]
    new_dist = torch.where(valid, edt["dist_sq"], EMPTY_VALUE)
    new_coc = torch.where(valid[..., None], edt["coc"].to(torch.int16), INV16)
    old_rel = coc_state_s.to(torch.int32)
    old_valid = coc_state_s[..., 0] != INV16
    old_in_canvas = ((old_rel >= 0) & (old_rel < cs_arr)).all(-1)
    keep_old = old_valid & ~old_in_canvas & (dist_state_s < new_dist)
    dist_s = torch.where(keep_old, dist_state_s, new_dist)
    coc_s = torch.where(keep_old[..., None], coc_state_s, new_coc)
    take = win_s & obs_s & pres_s & (dist_s != EMPTY_VALUE)
    if not cfg.fast_mode:
        take = take | (obs_s & ~win_s)
    fin_d = torch.where(take, dist_s, dist_state_s)
    fin_c = torch.where(take[..., None], coc_s, coc_state_s)
    return fin_d, fin_c, dist_s, coc_s


def _gate_readback(vec, mesh=None):
    """The change gate's one readback of a frame: `vec`, each part's nine
    int32 branch scalars (over a mesh max-reduced across the shards), as
    host ints, and the host ms it took, waiting for the device to reach it
    included."""
    with profiler.timed("merge.gate_wait") as wait:
        vals = (all_reduce(mesh, vec, "max") if mesh is not None
                else vec[0]).tolist()
    return vals, wait.ms


def _alloc_blocks(present, observed, off, cfg: MapConfig):
    """Block allocation (dense: flip present flags): every block that holds
    an observed window voxel (observed bool [X, Y, Z] at canvas offset
    `off`, host ints) becomes present.  Returns (present [bx, by, bz], the
    window's mask of voxels in present blocks [X, Y, Z])."""
    local_size = cfg.local_size
    cb = cfg.canvas_blocks
    bx, by, bz = cb
    dev = present.device
    lb = tuple(ls // VB_WIDTH + 2 for ls in local_size)
    start_bk = [o // VB_WIDTH for o in off]
    sub = [o - s * VB_WIDTH for o, s in zip(off, start_bk)]
    cov = torch.zeros(tuple(b * VB_WIDTH for b in lb), dtype=torch.bool,
                      device=dev)
    cov[_box(sub, local_size)] = observed
    nb = _block_any(cov, VB_WIDTH)
    pad = tuple(b + 2 for b in cb)
    st = [_clip(s, 0, p - l) for s, p, l in zip(start_bk, pad, lb)]
    needed = torch.zeros(pad, dtype=torch.bool, device=dev)
    needed[_box(st, lb)] = nb
    present = present | needed[:bx, :by, :bz]
    pres_pad = torch.zeros(pad, dtype=torch.bool, device=dev)
    pres_pad[:bx, :by, :bz] = present
    pres_cov = pres_pad[_box(st, lb)]
    return present, _expand_blocks(pres_cov)[_box(sub, local_size)]


def _fuse_window(state: MapState, inst_type, ray_count, pvt, fence,
                 present_vox_win, wb, cfg: MapConfig, input_pointcloud: bool,
                 use_fence: bool):
    """Occupancy fusion over the window box wb: the hit / miss low-pass of
    the occupancy values and the re-thresholded types, where the voxel's
    block is present (present_vox_win).  Returns (old_occ_win,
    old_type_win, new_occ_win, new_type_win, glb_type): the window's values
    before and after, and the new types with absent blocks UNKNOWN."""
    local_size = cfg.local_size
    dev = present_vox_win.device
    loc_grid = geo.local_coord_grid(local_size, device=dev)
    pvt_t = torch.tensor(np.asarray(pvt, np.int32), device=dev)
    old_occ_win = crop(state.occ_val, wb)
    old_type_win = crop(state.vox_type, wb)
    if use_fence:
        glb_pos = geo.coord2pos(loc_grid + pvt_t, cfg.voxel_width)
        occ_flag = _fence_mask(glb_pos, *fence)
    else:
        occ_flag = torch.zeros(local_size, dtype=torch.bool, device=dev)
    if input_pointcloud:
        hit = (ray_count > 0) | occ_flag
        miss = (ray_count < 0) & ~hit
        # / 10.0 in a jitted program: a multiply by float32(0.1)
        pbty = torch.clamp(div_const((-ray_count).to(torch.float32), 10.0),
                           max=1.0)
        occ_h, type_h = _lowpass(old_occ_win, old_type_win, _c.OCC_HIT_VAL,
                                 1.0, cfg.occupancy_threshold)
        occ_m, type_m = _lowpass(old_occ_win, old_type_win, _c.OCC_FREE_VAL,
                                 pbty, cfg.occupancy_threshold)
    else:
        hit = (inst_type == VOX_OCCUPIED) | occ_flag
        miss = (inst_type == VOX_FREE) & ~hit
        occ_h, type_h = _lowpass(old_occ_win, old_type_win, _c.OCC_HIT_VAL,
                                 _c.LOWPASS_SENSOR_OCC, cfg.occupancy_threshold)
        occ_m, type_m = _lowpass(old_occ_win, old_type_win, _c.OCC_FREE_VAL,
                                 _c.LOWPASS_SENSOR_FREE, cfg.occupancy_threshold)
    upd = present_vox_win & (hit | miss)
    new_occ_win = torch.where(upd, torch.where(hit, occ_h, occ_m), old_occ_win)
    new_type_win = torch.where(upd, torch.where(hit, type_h, type_m),
                               old_type_win)
    glb_type = torch.where(present_vox_win, new_type_win,
                           VOX_UNKNOWN).to(torch.int8)
    return old_occ_win, old_type_win, new_occ_win, new_type_win, glb_type


def _changed_blocks(present, canvas_blk, win_vox, off, enter_shift, cb):
    """The frame's changed_blk: the canvas's changed blocks (canvas_blk)
    or-ed with the blocks of the window's changed voxels (win_vox at canvas
    offset off), within the present blocks, and on a canvas move the
    present blocks that entered (enter_shift in voxels, host ints, or
    None)."""
    changed_blk = (canvas_blk | _window_blocks(win_vox, off, cb)) & present
    if enter_shift is not None:
        entering = torch.zeros(cb, dtype=torch.bool, device=present.device)
        for a in range(3):
            s = int(enter_shift[a]) // VB_WIDTH
            bi = torch.arange(cb[a], device=present.device).reshape(
                [-1 if i == a else 1 for i in range(3)])
            entering |= (bi >= cb[a] - s) if s > 0 else (bi < -s)
        changed_blk = changed_blk | (entering & present)
    return changed_blk


def _gated_canvas_merge(state: MapState, canvas_type, new_type_win,
                        old_type_win, win_off, window_mask, present_blk,
                        enter_shift, cfg: MapConfig, mesh=None):
    """Change-gated exact canvas EDT (see the JAX package's docstring for
    the affected-region argument).  Under a mesh the slabs span all of x
    (x is the sharded axis).  Returns (final_dist, final_coc, dist_win,
    coc_win, changed_blk_dist, gate_level, slab_vox, dmax_new, p1c_new).
    Under a mesh canvas_type and the state's canvas fields are x-shards and
    every canvas-sized result stays so."""
    dev = state.present.device
    sharded = isinstance(canvas_type, Sharded)
    cs = cfg.canvas_size
    local_size = cfg.local_size
    X, Y, Z = cs
    menu = _slab_menu(cs, _menu_fracs(cfg))
    if mesh is not None:
        menu = [(X, sy) for _, sy in menu]
    n_menu = len(menu)
    off = [int(v) for v in win_off]
    es = [int(v) for v in enter_shift]

    with profiler.span("merge.gate"):
        # ---- change set: occupancy flips + UNKNOWN transitions (window) ------
        site_flip = ((old_type_win == VOX_OCCUPIED)
                     != (new_type_win == VOX_OCCUPIED))
        unk_flip = ((old_type_win == VOX_UNKNOWN)
                    != (new_type_win == VOX_UNKNOWN))
        chg = site_flip | unk_flip
        flo, fhi = [], []
        for a in range(3):
            other = tuple(i for i in range(3) if i != a)
            lo, hi = _axis_lohi(site_flip.any(dim=other))
            flo.append(lo + off[a])
            fhi.append(hi + off[a])
        boxes = [(torch.stack(flo), torch.stack(fhi), ~site_flip.any())]
        # entering and exiting slabs of this frame's canvas move (dead boxes on
        # frames that do not move the canvas)
        t3 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
        for a in range(3):
            s = es[a]
            lo, hi = [0, 0, 0], [c - 1 for c in cs]
            lo[a], hi[a] = (cs[a] - s, cs[a] - 1) if s > 0 else (0, -s - 1)
            boxes.append((t3(lo), t3(hi), t3(s == 0).bool()))
        for a in range(3):
            s = es[a]
            lo, hi = [0, 0, 0], [c - 1 for c in cs]
            lo[a], hi[a] = (-s, -1) if s > 0 else (cs[a], cs[a] - s - 1)
            boxes.append((t3(lo), t3(hi), t3(s == 0).bool()))

        # ---- block P test on the per-cell dist bound -------------------------
        big = 1 << 30
        G = 4
        cgrid = tuple(c // G for c in cs)
        cidx = [(torch.arange(n, dtype=torch.int32, device=dev) * G,
                 torch.arange(n, dtype=torch.int32, device=dev) * G + (G - 1))
                for n in cgrid]
        bd = None
        for lo, hi, dead in boxes:
            parts = []
            for a, n in enumerate(cs):
                ilo, ihi = cidx[a]
                d = torch.clamp(torch.maximum(lo[a] - ihi, ilo - hi[a]), min=0)
                d = torch.clamp(d, max=n)
                parts.append(d * d)
            b = (parts[0][:, None, None] + parts[1][None, :, None]
                 + parts[2][None, None, :])
            b = torch.where(dead, big, b)
            bd = b if bd is None else torch.minimum(bd, b)
        p_cell = bd <= state.dmax_cell
        if cfg.fast_mode:
            ov = [((cidx[a][0] <= off[a] + local_size[a] - 1)
                   & (cidx[a][1] >= off[a])) for a in range(3)]
            p_cell = p_cell & ov[0][:, None, None] & ov[1][None, :, None] \
                & ov[2][None, None, :]
        bx_lo, bx_hi = _axis_lohi(p_cell.any(2).any(1))
        by_lo, by_hi = _axis_lohi(p_cell.any(2).any(0))
        cx_lo, cx_hi = _axis_lohi(chg.any(2).any(1))
        cy_lo, cy_hi = _axis_lohi(chg.any(2).any(0))
        x0 = torch.minimum(bx_lo * G, cx_lo + off[0])
        x1 = torch.maximum(bx_hi * G + (G - 1), cx_hi + off[0])
        y0 = torch.minimum(by_lo * G, cy_lo + off[1])
        y1 = torch.maximum(by_hi * G + (G - 1), cy_hi + off[1])

        # ---- one readback: every host-side branch choice of this frame -------
        # (over a mesh one all-reduce: each shard adds whether it holds a site
        # before and after, so every shard and process takes the same branch)
        vec = [torch.stack([x0, x1, y0, y1, flo[0], fhi[0],
                            (a == VOX_OCCUPIED).any().to(dev, torch.int32),
                            (b == VOX_OCCUPIED).any().to(dev, torch.int32),
                            state.p1c_ok.to(torch.int32)])
               for a, b in zip(parts_of(canvas_type), parts_of(state.vox_type))]
    vals, sync_ms = _gate_readback(vec, canvas_type.mesh if sharded else None)
    with profiler.span("merge.edt"):
        x0, x1, y0, y1, flo0, fhi0, any_new, any_old, p1c_ok = vals
        need_x = max(x1 - x0 // 8 * 8 + 1, 0)
        need_y = max(y1 - y0 // 8 * 8 + 1, 0)
        sel = next((k for k, (sx, sy) in enumerate(menu)
                    if need_x <= sx and need_y <= sy), n_menu)
        if not (any_new and any_old):
            sel = n_menu  # zero-site epoch or its exit: full recompute
        if not any_new:
            sel = n_menu + 1  # no sites at all: constant fill

        # ---- phase-1 cache: patch the site-flip x-slab, or rebuild -----------
        use_p1c = p1_cache_enabled(cfg, mesh)
        p1c_new = state.p1c
        mw = sum(cs)
        if use_p1c:
            fx_menu = [sx for sx, _ in menu]
            pneed = max(fhi0 - flo0 // 8 * 8 + 1, 0)
            psel = next((k for k, fx in enumerate(fx_menu) if pneed <= fx),
                        len(fx_menu))
            if not p1c_ok:
                psel = len(fx_menu)
            if psel < len(fx_menu):
                FX = fx_menu[psel]
                o = _clip(flo0 // 8 * 8, 0, X - FX)
                p1c_new = state.p1c.clone()
                phase1_packed(canvas_type[o:o + FX], mw, out=p1c_new[o:o + FX])
            else:
                p1c_new = phase1_packed(canvas_type, mw)

        # ---- the chosen branch -----------------------------------------------
        p1 = p1c_new if use_p1c else None
        if sel < n_menu:
            SX, SY = menu[sel]
            ox = _clip(x0 // 8 * 8, 0, X - SX)
            oy = _clip(y0 // 8 * 8, 0, Y - SY)
            box = _box((ox, oy, 0), (SX, SY, Z))
            if sharded:
                slab = batch_edt_sharded_slab(canvas_type, oy, sy=SY,
                                              max_width=mw, mesh=mesh)
            else:
                slab = batch_edt_slab(canvas_type, ox, oy, sx=SX, sy=SY,
                                      max_width=mw, p1_packed=p1)
            win_s = _in_box(window_mask, box)
            dist_state_s = _in_box(state.dist_sq, box)
            coc_state_s = _in_box(state.coc, box)
            obs_s = smap(lambda t: t != VOX_UNKNOWN, _in_box(canvas_type, box))
            pres_s = _expanded(win_s, present_blk[ox // 8:ox // 8 + SX // 8,
                                                  oy // 8:oy // 8 + SY // 8, :])
            fin_d, fin_c, _, _ = _finalize_parts(cfg, dist_state_s, coc_state_s,
                                                 slab, obs_s, pres_s, win_s)
            final_dist = _with_box(state.dist_sq, box, fin_d)
            final_coc = _with_box(state.coc, box, fin_c)
            changed = torch.zeros(cfg.canvas_blocks, dtype=torch.bool,
                                  device=dev)
            changed[ox // 8:ox // 8 + SX // 8, oy // 8:oy // 8 + SY // 8] = \
                block_reduce(smap(torch.ne, fin_d, dist_state_s), 8, "any",
                             False)
            dm_s = block_reduce(smap(lambda o, f: torch.where(o, f, -1), obs_s,
                                     fin_d), 4, "max", -1)
            dmax_new = state.dmax_cell.clone()
            dmax_new[ox // 4:ox // 4 + SX // 4,
                     oy // 4:oy // 4 + SY // 4] = dm_s
            wb = _box(off, local_size)
            dist_win, coc_win = crop(final_dist, wb), crop(final_coc, wb)
            slab_vox = SX * SY * Z
        else:
            zero_site = sel == n_menu + 1
            if zero_site:
                zeros = lambda dt, tail=(): sbuild(
                    canvas_type, lambda lo, hi, d: torch.zeros(
                        (hi - lo,) + cs[1:] + tail, dtype=dt, device=d))
                full = {"valid": zeros(torch.bool),
                        "dist_sq": zeros(torch.int32),
                        "coc": zeros(torch.int32, (3,))}
            elif sharded:
                full = batch_edt_sharded(canvas_type, mw, mesh)
            else:
                full = batch_edt(canvas_type, mw, p1_packed=p1)
            obs = smap(lambda t: t != VOX_UNKNOWN, canvas_type)
            final_dist, final_coc, dist_pre, coc_pre = _finalize_parts(
                cfg, state.dist_sq, state.coc, full, obs,
                _expanded(canvas_type, present_blk), window_mask)
            changed = block_reduce(smap(torch.ne, final_dist, state.dist_sq), 8,
                                   "any", False)
            dmax_new = block_reduce(smap(lambda o, f: torch.where(o, f, -1),
                                         obs, final_dist), 4, "max", -1)
            wb = _box(off, local_size)
            dist_win, coc_win = crop(dist_pre, wb), crop(coc_pre, wb)
            slab_vox = 0 if zero_site else X * Y * Z
    profiler.count("gate.slab_vox", slab_vox)
    return (final_dist, final_coc, dist_win, coc_win, changed, sel, slab_vox,
            dmax_new, p1c_new, sync_ms)


def _canvas_edt(canvas_type, max_width, mesh):
    """The full canvas EDT of the ungated branch: the sharded chain over
    x-shards where sharded_edt_ok holds, else batch_edt (a whole canvas; an
    x-sharded canvas whose z does not divide the mesh is gathered for it and
    its outputs split again, the one frame-time gather of the canvas)."""
    if not isinstance(canvas_type, Sharded):
        return batch_edt(canvas_type, max_width)
    if sharded_edt_ok(canvas_type.shape, canvas_type.mesh):
        return batch_edt_sharded(canvas_type, max_width)
    from ..parallel.mesh import canvas_sharding, gather, put

    full = batch_edt(gather(canvas_type), max_width)
    return {k: put(v, canvas_sharding(canvas_type.mesh)) for k, v in full.items()}


def merge_frame(state: MapState, inst_type, ray_count, pvt, canvas_origin_blk,
                win_off, fence, *, cfg: MapConfig, input_pointcloud: bool,
                use_fence: bool = True, enter_shift=None,
                emit_outputs: bool = True, mesh=None):
    """Fuse one local observation into the global map and refresh the EDT
    (the JAX package's merge_frame_impl with do_scroll=False).

    inst_type int8 / ray_count int32 [X, Y, Z] window tensors on the state's
    device; pvt, canvas_origin_blk, win_off host int triples; fence =
    (ll, ur, active, n) tensors; enter_shift: this frame's canvas move in
    voxels (host ints) or None.  Returns (state', outputs dict).  With
    emit_outputs=False the outputs are only changed_blk and the scalars of
    SCALAR_OUTPUTS: the window tensors (edt, glb_type, dist_sq, coc,
    ogm_changed) are not built, and the state is the same.  mesh: the
    parallel.mesh.Mesh the state is placed on (shard_state); every stage
    runs on the shards (module docstring)."""
    with profiler.span("merge"):
        return _merge_frame(state, inst_type, ray_count, pvt,
                            canvas_origin_blk, win_off, fence, cfg,
                            input_pointcloud, use_fence, enter_shift,
                            emit_outputs, mesh)


def _merge_frame(state: MapState, inst_type, ray_count, pvt,
                 canvas_origin_blk, win_off, fence, cfg: MapConfig,
                 input_pointcloud: bool, use_fence: bool, enter_shift,
                 emit_outputs: bool, mesh):
    """merge_frame's body, its stages in spans: merge.fuse, the gate's
    (merge.gate, merge.gate_wait, merge.edt) or merge.edt, merge.tail."""
    local_size = cfg.local_size
    cb = cfg.canvas_blocks
    cs = cfg.canvas_size
    dev = state.present.device
    if mesh is not None and cs[0] % mesh.size == 0 \
            and not isinstance(state.vox_type, Sharded):
        raise ValueError("merge_frame: the state is not placed on the mesh "
                         "(parallel.mesh.shard_state)")
    off = [int(v) for v in win_off]
    wb = _box(off, local_size)

    old_dist = state.dist_sq
    old_type = state.vox_type

    # ---- block allocation, occupancy fusion --------------------------------
    with profiler.span("merge.fuse"):
        observed = ((ray_count != 0) if input_pointcloud
                    else (inst_type != VOX_UNKNOWN))
        present, present_vox_win = _alloc_blocks(state.present, observed, off,
                                                 cfg)
        old_occ_win, old_type_win, new_occ_win, new_type_win, glb_type = \
            _fuse_window(state, inst_type, ray_count, pvt, fence,
                         present_vox_win, wb, cfg, input_pointcloud, use_fence)
        canvas_occ = splice(state.occ_val, wb, new_occ_win)
        canvas_type = splice(state.vox_type, wb, new_type_win)
        window_mask = _window_mask(state.vox_type, wb)

    gated = gate_enabled(cfg, mesh)
    relax_iters = 0
    if gated:
        es = [0, 0, 0] if enter_shift is None else enter_shift
        (final_dist, final_coc, dist_win, coc_win, changed_blk_d, gate_level,
         slab_vox, dmax_new, p1c_new, sync_ms) = _gated_canvas_merge(
            state, canvas_type, new_type_win, old_type_win, off, window_mask,
            present, es, cfg, mesh)
    else:
        with profiler.span("merge.edt"):
            if cfg.merge_mode == "canvas_edt":
                # one exact EDT over the whole canvas, then the same
                # keep-old / take
                full = _canvas_edt(canvas_type, sum(cs), mesh)
                obs = smap(lambda t: t != VOX_UNKNOWN, canvas_type)
                final_dist, final_coc, dist, coc = _finalize_parts(
                    cfg, state.dist_sq, state.coc, full, obs,
                    _expanded(canvas_type, present), window_mask)
                dist_win, coc_win = crop(dist, wb), crop(coc, wb)
            else:
                # the relax engine: the window's batch EDT reconciled with
                # the stored canvas, the raise wave (fast_mode off), then
                # the lower fixed point over the canvas
                outside_observed = smap(lambda t, w: (t != VOX_UNKNOWN) & ~w,
                                        canvas_type, window_mask)
                batch = batch_edt(glb_type, cfg.max_width)
                seed_dist, seed_coc = reconcile_window(
                    batch, crop(state.dist_sq, wb), crop(state.coc, wb),
                    glb_type, off, local_size)
                dist = splice(state.dist_sq, wb, seed_dist)
                coc = splice(state.coc, wb, seed_coc)
                raised = None
                if not cfg.fast_mode:
                    dead_win = ((old_type_win == VOX_OCCUPIED)
                                & (glb_type != VOX_OCCUPIED)
                                & (glb_type != VOX_UNKNOWN))
                    dist, coc, raised = invalidate_disappeared(
                        dist, coc, outside_observed, state.coc, dead_win, off,
                        max_sweeps=cfg.relax_iters)
                can_update = window_mask if cfg.fast_mode else smap(
                    torch.logical_or, window_mask, outside_observed)
                dist, coc, relax_iters = relax_fixed_point(
                    dist, coc, can_update, outside_observed, window_mask,
                    cutoff_sq=cfg.cutoff_grids_sq, max_iters=cfg.relax_iters)
                # copies: the write-back below splices into dist and coc
                # in place
                dist_win = crop(dist, wb).clone()
                coc_win = crop(coc, wb).clone()

    with profiler.span("merge.tail"):
        # ---- frontiers -------------------------------------------------------
        fnt = mark_frontiers(canvas_type, glb_type, off, local_size)

        pair_valid = dist_win != EMPTY_VALUE
        observed_win = glb_type != VOX_UNKNOWN
        writeback = observed_win & pair_valid
        vt_win = torch.where(fnt & writeback, VOX_FNT,
                             new_type_win).to(torch.int8)
        canvas_type = splice(canvas_type, wb, vt_win, inplace=True)
        if cfg.merge_mode == "relax":
            # pair-invalid window voxels keep the OLD stored value, except
            # where the raise wave reached them (the reference's wave
            # mutates the stored map in place, so they stay raised)
            old_dist_win = crop(state.dist_sq, wb)
            old_coc_win = crop(state.coc, wb)
            if raised is not None:
                rw = crop(raised, wb)
                old_dist_win = torch.where(rw, EMPTY_VALUE, old_dist_win)
                old_coc_win = torch.where(rw[..., None], INV16, old_coc_win)
            final_dist = splice(dist, wb, torch.where(
                writeback, dist_win, old_dist_win), inplace=True)
            final_coc = splice(coc, wb, torch.where(
                writeback[..., None], coc_win, old_coc_win), inplace=True)

        # ---- changed-block tracking ------------------------------------------
        occ_changed_win = new_occ_win != old_occ_win
        if gated:
            changed_blk = _changed_blocks(
                present, changed_blk_d,
                (vt_win != old_type_win) | occ_changed_win, off, enter_shift,
                cb)
        else:
            changed_vox = smap(lambda fd, od, ct, ot: (fd != od) | (ct != ot),
                               final_dist, old_dist, canvas_type, old_type)
            changed_blk = _changed_blocks(
                present, block_reduce(changed_vox, VB_WIDTH, "any", False),
                occ_changed_win, off, enter_shift, cb)

        state = dataclasses.replace(
            state, occ_val=canvas_occ, vox_type=canvas_type, dist_sq=final_dist,
            coc=final_coc, present=present,
            dmax_cell=(dmax_new if gated else torch.full(
                tuple(c // 4 for c in cs), EMPTY_VALUE, dtype=torch.int32,
                device=dev)),
            p1c=p1c_new if gated else state.p1c,
            p1c_ok=torch.tensor(gated and p1_cache_enabled(cfg, mesh),
                                device=dev),
        )

        outputs = {
            "changed_blk": changed_blk,
            "relax_iters": relax_iters,
            "arch_dropped": state.arch_dropped,
            "fnt_count": fnt.sum(dtype=torch.int32),
            "gate_level": gate_level if gated else -1,
            "gate_slab_vox": slab_vox if gated else cs[0] * cs[1] * cs[2],
        }
        if not emit_outputs:
            return state, outputs
        canvas_origin_vox = torch.tensor(
            np.asarray(canvas_origin_blk, np.int64) * VB_WIDTH,
            dtype=torch.int32, device=dev)
        outputs.update({
            # host ms spent in the gate's one readback (waiting for the device
            # to reach it included); 0.0 when the gate is off
            "gate_sync_ms": sync_ms if gated else 0.0,
            "edt": torch.where(
                observed_win,
                torch.where(pair_valid, sqrt_f32(dist_win.to(torch.float32)),
                            float(cfg.max_loc_dist_sq)),
                0.0),
            "glb_type": torch.where(fnt, VOX_FNT, glb_type).to(torch.int8),
            "dist_sq": torch.where(observed_win, dist_win, EMPTY_VALUE),
            "coc": torch.where(
                (observed_win & (coc_win[..., 0] != INV16))[..., None],
                coc_win.to(torch.int32) + canvas_origin_vox, INV16),
            "ogm_changed": present_vox_win & (new_type_win != old_type_win),
        })
        return state, outputs


def scroll_step(state: MapState, new_origin_blk, *, cfg: MapConfig,
                compact_cols: int | None = None, old_origin_blk=None):
    """Host-gated canvas scroll, called only when the canvas origin moves
    (the scroll half of the JAX package's scroll_frame_step).  Returns
    (state', enter_shift): the frame's canvas move in voxels (host ints),
    which merge_frame's change gate and changed-block mask take."""
    old = (state.origin_blk.cpu().numpy() if old_origin_blk is None
           else np.asarray(old_origin_blk))
    new = np.asarray(new_origin_blk)
    enter_shift = ((new.astype(np.int64) - old.astype(np.int64))
                   * VB_WIDTH).astype(np.int32)
    state = scroll_canvas(state, new, cfg, compact_cols=compact_cols,
                          old_origin_blk=old)
    return state, enter_shift


def _pose(rot, origin, dev) -> geo.Projection:
    return geo.Projection(torch.from_numpy(np.array(rot, np.float32)).to(dev),
                          torch.from_numpy(np.array(origin, np.float32)).to(dev))


def _sensor_kw(cfg: MapConfig) -> dict:
    return dict(local_size=cfg.local_size, voxel_width=cfg.voxel_width,
                ogm_min_h=cfg.ogm_min_h, ogm_max_h=cfg.ogm_max_h,
                for_motion_planner=cfg.for_motion_planner,
                robot_r2_grids=cfg.robot_r2_grids)


def pointcloud_sensor(points, pts_valid, rot, origin, pvt, *, cfg: MapConfig,
                      fused: bool):
    """One frame's point-cloud model: the sensor->world transform of
    points [N, 3] (sensor frame), then the projective carve, or with
    cfg.raycast_mode "dda" the exact ray walk.  rot [3, 3] and origin (3,)
    float32 (host numpy), pvt host ints.  `fused` rounds the transform as
    the JAX package's jitted frame program does (fuse_raycast, projective
    only), else as its eager l2g.  Returns (inst_type, ray_count) window
    tensors."""
    proj = _pose(rot, origin, points.device)
    world = proj.l2g_fused(points) if fused else proj.l2g(points)
    origin = np.asarray(origin, np.float32)
    if cfg.raycast_mode == "dda":
        return rc.pointcloud_raycast(world, pts_valid, origin, pvt,
                                     **_sensor_kw(cfg))
    nt, np_ = rc.panorama_bins(cfg.local_size)
    return rc.pointcloud_project(world, pts_valid, origin, pvt,
                                 n_theta=nt, n_phi=np_, **_sensor_kw(cfg))


def scan_sensor(ranges, rot, origin, s1, s2, pvt, *, cfg: MapConfig,
                replay: bool = False):
    """One frame's 2-D LiDAR model: ranges [n_beams] float32 on the device;
    rot / origin float32 (host numpy); the beam angles as the JAX package
    packs them in pose rows 7-8, s1 = (theta_min, theta_inc, ...), float32;
    pvt host ints; `replay` rounds as the JAX replay's scan loop does
    (scan_sensors._sensor_offsets).  Returns (inst_type, ray_count =
    zeros)."""
    dev = ranges.device
    f = [float(np.float32(v)) for v in s1[:2]]
    inst = hokuyo_update(_pose(rot, origin, dev), ScanParam(*f, ranges), pvt,
                         replay=replay, **_sensor_kw(cfg))
    return inst, torch.zeros(cfg.local_size, dtype=torch.int32, device=dev)


def depth_sensor(depth, rot, origin, s1, s2, pvt, *, cfg: MapConfig,
                 replay: bool = False):
    """One frame's depth-camera model: depth [rows, cols] float32 on the
    device; the intrinsics as the JAX package packs them in pose rows 7-8,
    s1 = (fx, fy, cx) and s2 = (cy, ...), float32; `replay` as in
    scan_sensor.  Returns (inst_type, ray_count = zeros)."""
    dev = depth.device
    f = [float(np.float32(v)) for v in (*s1[:3], s2[0])]
    inst = realsense_update(_pose(rot, origin, dev), CamParam(*f, depth), pvt,
                            valid_nan=cfg.valid_nan, replay=replay,
                            **_sensor_kw(cfg))
    return inst, torch.zeros(cfg.local_size, dtype=torch.int32, device=dev)


def multiscan_sensor(rings, rot, origin, s1, s2, pvt, *, cfg: MapConfig,
                     replay: bool = False):
    """One frame's multi-ring LiDAR model: rings [ring_num, scan_num]
    float32 on the device; the bin geometry as the JAX package packs it in
    pose rows 7-8, s1 = (theta_min, theta_inc, phi_min) and s2 = (phi_inc,
    ...), float32; `replay` as in scan_sensor.  Returns (inst_type,
    ray_count = zeros)."""
    dev = rings.device
    f = [float(np.float32(v)) for v in (*s1[:3], s2[0])]
    inst = vlp16_update(_pose(rot, origin, dev), MulScanParam(*f, rings), pvt,
                        replay=replay, **_sensor_kw(cfg))
    return inst, torch.zeros(cfg.local_size, dtype=torch.int32, device=dev)


# the projection sensors by the JAX package's sensor_kind
SENSORS = {"scan": scan_sensor, "depth": depth_sensor,
           "multiscan": multiscan_sensor}


def _in_scan_loop(k: int, n: int) -> bool:
    """Whether frame k of an n-frame run rounds as the JAX replay's scan
    loop.  The JAX program scans frames 0..n-2 with lax.scan and runs the
    last frame unrolled after it.  XLA:CPU emits the scan body's sensor
    offset (c * w - t) as a scalar loop, every component one FMA; a scan
    of one frame has its while loop removed, and the unrolled frames round
    as the per-frame program (scan_sensors._sensor_offsets)."""
    return n >= 3 and k < n - 1


def replay_frames(state: MapState, poses, scrolled, fence, *, cfg: MapConfig,
                  origin_blk, input_pointcloud: bool, use_fence: bool = True,
                  compact_cols=None, has_scrolls: bool = True, points=None,
                  pts_valid=None, sensor_data=None, sensor_kind=None,
                  inst_type=None, ray_count=None, mesh=None):
    """A planned run of K frames (the JAX package's replay_frames and its
    scan program, as a Python loop).

    poses: float32 [K, 9, 3] host rows per frame, as the JAX package packs
    them: pvt, canvas origin block and window offset (integers), the
    sensor rotation, the sensor origin, then two rows of sensor scalars
    (row 7: theta_min, theta_inc of the 2-D LiDAR).  scrolled: bool [K],
    whether the frame's canvas origin differs from the previous frame's.
    origin_blk: the canvas origin before the run (host ints).
    compact_cols: each frame's column bucket for its scroll (a list of K;
    None, or a None entry, moves every column).  The frames' data, exactly
    one pair of: points / pts_valid [K, N, 3] / [K, N] (the point-cloud
    model, transformed as fuse_raycast rounds it); sensor_data [K, ...]
    with sensor_kind "scan", "depth" or "multiscan" (each frame's ranges,
    depth image or ring image); inst_type / ray_count [K, X, Y, Z] int8 /
    int32 tensors on the state's device (precomputed observations, merged
    as given).  Any other mix raises ValueError.  mesh: as merge_frame's.

    Every frame runs merge_frame with its enter_shift; only the last emits
    its window outputs.  Returns (state', last outputs, changed_union
    [bx, by, bz] — every frame's changed_blk ORed, the union moved with
    each scroll — and per_frame: SCALAR_OUTPUTS as [K] int32 tensors on
    the state's device).  has_scrolls=False requires scrolled[k] False for
    every frame (ValueError otherwise), as the JAX package's guard does."""
    poses = np.asarray(poses, np.float32)
    scrolled = np.asarray(scrolled, bool)
    if not has_scrolls and scrolled.any():
        raise ValueError(
            "replay_frames(has_scrolls=False) requires scrolled[k] == False "
            "for every frame; got a scrolling frame. Pass has_scrolls=True "
            "(or plan per-run like VolumetricMapper).")
    pairs = {"points / pts_valid": (points, pts_valid),
             "sensor_data / sensor_kind": (sensor_data, sensor_kind),
             "inst_type / ray_count": (inst_type, ray_count)}
    given = [k for k, pair in pairs.items() if any(v is not None for v in pair)]
    if len(given) != 1 or any(v is None for v in pairs[given[0]]):
        raise ValueError(
            "replay_frames takes exactly one whole pair of points / "
            "pts_valid, sensor_data / sensor_kind and inst_type / ray_count; "
            f"got {given or 'none'}"
            + (" with half of the pair missing" if len(given) == 1 else ""))
    n = len(poses)
    if compact_cols is None:
        compact_cols = [None] * n
    dev = state.present.device
    prev = np.asarray(origin_blk, np.int64)
    changed_union = torch.zeros(cfg.canvas_blocks, dtype=torch.bool, device=dev)
    ys = {k: [] for k in SCALAR_OUTPUTS}
    out = None
    for k in range(n):
        pvt, origin, off = (poses[k, r].astype(np.int32) for r in range(3))
        enter_shift = None
        if scrolled[k]:
            state, enter_shift = scroll_step(
                state, origin, cfg=cfg, compact_cols=compact_cols[k],
                old_origin_blk=prev)
            changed_union = shift_block_mask(changed_union,
                                             origin.astype(np.int64) - prev)
            prev = origin.astype(np.int64)
        rot, sensor_origin = poses[k, 3:6], poses[k, 6]
        if inst_type is not None:
            inst, cnt = inst_type[k], ray_count[k]
        elif sensor_kind is None:
            inst, cnt = pointcloud_sensor(points[k], pts_valid[k], rot,
                                          sensor_origin, pvt, cfg=cfg,
                                          fused=True)
        else:
            inst, cnt = SENSORS[sensor_kind](sensor_data[k], rot,
                                             sensor_origin, poses[k, 7],
                                             poses[k, 8], pvt, cfg=cfg,
                                             replay=_in_scan_loop(k, n))
        state, out = merge_frame(
            state, inst, cnt, pvt, origin, off, fence, cfg=cfg,
            input_pointcloud=input_pointcloud, use_fence=use_fence,
            enter_shift=enter_shift, emit_outputs=k == n - 1, mesh=mesh)
        changed_union = changed_union | out["changed_blk"]
        for key in SCALAR_OUTPUTS:
            ys[key].append(out[key])
    per_frame = {
        key: (torch.stack(v).to(torch.int32)
              if isinstance(v[0], torch.Tensor)
              else torch.tensor(v, dtype=torch.int32, device=dev))
        for key, v in ys.items()}
    return state, out, changed_union, per_frame
