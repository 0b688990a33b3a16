"""Plain reference of the mapping engine's map cycle.

It takes the deployment's settings (a configuration file of mapbench)
and, frame by frame and from a fresh map, works out again:

  placement  the window pivot, the canvas origin with its hysteresis and
             motion-biased re-placement (`place`);
  scroll     the canvas move: outgoing present blocks into the archive (a
             dict keyed by global block, slots never freed, new keys
             beyond max_blocks dropped), the exposed region reset, entering
             blocks restored from the archive;
  merge      (`merge`, given the window observation that a sensor model of
             this folder made: reference/depth.py, reference/cloud.py)
             block allocation, the occupancy low-pass, an exact EDT of the
             whole canvas (reference/edt.py) with the limited-observation
             rule (a stored distance to a site outside the canvas is kept
             while it is shorter), frontiers;
  stream     the changed blocks of each frame, served to a host mirror by
             block column, at most k columns a tick in rotating order, the
             rest carried (and moved with the canvas) to later ticks.

A sensor module (mapbench/sensors/<kind>.py) drives one frame: `place`,
its model, `merge`.  Closest-site coordinates are GLOBAL voxel coordinates
here (INV where none), so no re-anchoring is needed.  Float arithmetic is
float32 in the order the published program takes it; `low=True` takes it
in bfloat16 instead (the benchmark's control).  Plain PyTorch and NumPy;
nothing of the engine is imported.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .edt import exact_edt

UNKNOWN, FREE, OCCUPIED, FRONTIER = 0, 1, 2, 3
EMPTY = 999_999
INV = 1 << 31          # no closest site (global coordinates stay far below)
VB = 8                 # voxels per block edge
MAX_HALO = 96
OCC_HIT, OCC_MISS = 250.0, 0.0
ALPHA_HIT, ALPHA_MISS = 0.8, 0.5   # the depth camera's low-pass weights
OCC_MAX, OCC_MIN = 254.0, 1.0


class Geometry:
    """Sizes derived from the deployment's settings."""

    def __init__(self, dep: dict):
        self.vw = float(dep["voxel_width"])
        self.local = tuple(int(round(s / self.vw)) for s in dep["local_size_m"])
        if dep["fast_mode"]:
            self.halo = VB
        else:
            self.halo = min(int(math.ceil(dep["cutoff_dist"] / self.vw)), MAX_HALO)
        slack = int(dep.get("canvas_slack_blocks", 0))
        self.cb = tuple((s + 2 * self.halo) // VB + 2 + slack for s in self.local)
        self.cs = tuple(b * VB for b in self.cb)
        self.bias = float(dep["scroll_bias"])
        ncols = self.cb[0] * self.cb[1]
        k = dep.get("stream_k_cols")
        self.k_cols = min(k or min(ncols, 64), ncols)
        self.max_loc_dist_sq = sum(s * s for s in self.local)

    def pivot(self, pos32: np.ndarray) -> np.ndarray:
        """Window pivot of a float32 position (float32 arithmetic)."""
        c = np.floor(np.asarray(pos32) / self.vw + 0.5).astype(np.int64)
        return (c - np.asarray(self.local) // 2).astype(np.int32)

    def fits(self, pvt, origin) -> bool:
        off = pvt - origin * VB
        return bool((off >= self.halo).all() and
                    (off + np.asarray(self.local) + self.halo
                     <= np.asarray(self.cs)).all())

    def place(self, pvt, motion) -> np.ndarray:
        """Canvas origin (blocks) for a pivot: centred, pushed toward the
        motion by the scroll bias, clipped so window and halo fit."""
        pvt = np.asarray(pvt, np.int64)
        cs = np.asarray(self.cs, np.int64)
        local = np.asarray(self.local, np.int64)
        centred = np.floor((pvt + local // 2 - cs // 2) / VB + 0.5).astype(np.int64)
        o_min = -(-(pvt + local + self.halo - cs) // VB)
        o_max = np.floor_divide(pvt - self.halo, VB)
        tgt = centred.copy()
        if motion is not None and self.bias != 0.5:
            for a in range(3):
                if motion[a] > 0:
                    tgt[a] = round(centred[a] + (o_max[a] - centred[a]) * (2 * self.bias - 1))
                elif motion[a] < 0:
                    tgt[a] = round(centred[a] + (o_min[a] - centred[a]) * (2 * self.bias - 1))
        return np.clip(tgt, o_min, o_max).astype(np.int64)


def _blocks_any(m: torch.Tensor) -> torch.Tensor:
    X, Y, Z = m.shape
    return m.reshape(X // VB, VB, Y // VB, VB, Z // VB, VB).any(5).any(3).any(1)


def _expand(b: torch.Tensor) -> torch.Tensor:
    for a in range(3):
        b = b.repeat_interleave(VB, dim=a)
    return b


def _shifted(t: torch.Tensor, shift, fill) -> torch.Tensor:
    """out[i] = t[i + shift] over the leading axes, `fill` where outside."""
    out = torch.full_like(t, fill)
    src, dst = [], []
    for s, n in zip(shift, t.shape):
        s = int(s)
        lo, hi = max(0, -s), min(n, n - s)
        if hi <= lo:
            return out
        dst.append(slice(lo, hi))
        src.append(slice(lo + s, hi + s))
    out[tuple(dst)] = t[tuple(src)]
    return out


class RefMapper:
    """The reference map: canvas fields, block archive, host mirror."""

    def __init__(self, dep: dict, device, low: bool = False):
        self.dep = dep
        self.g = Geometry(dep)
        self.dev = torch.device(device)
        self.low = low
        cs = self.g.cs
        d = self.dev
        self.occ = torch.zeros(cs, dtype=torch.uint8, device=d)
        self.typ = torch.zeros(cs, dtype=torch.int8, device=d)
        self.dist = torch.full(cs, EMPTY, dtype=torch.int64, device=d)
        self.coc = torch.full(cs + (3,), INV, dtype=torch.int64, device=d)
        self.present = torch.zeros(self.g.cb, dtype=torch.bool, device=d)
        self.origin = None            # canvas origin, blocks (host int64)
        self.last_pvt = None
        self.archive: dict = {}       # global block -> field arrays
        self.dropped = 0
        self.mirror: dict = {}
        self.carry = torch.zeros(self.g.cb, dtype=torch.bool, device=d)
        self.rot = 0
        self.frames = 0
        self.scrolls = 0
        self.last_out: dict = {}

    # -- blocks to and from the host ---------------------------------------
    def _block_fields(self, ids: torch.Tensor) -> dict:
        """{field: numpy [n, 8, 8, 8(, 3)]} of canvas blocks ids [n, 3]."""
        bx, by, bz = self.g.cb
        out = {}
        for name, t in (("occ_val", self.occ), ("vox_type", self.typ),
                        ("dist_sq", self.dist), ("coc", self.coc)):
            v = t.reshape((bx, VB, by, VB, bz, VB) + t.shape[3:])
            v = v.permute((0, 2, 4, 1, 3, 5) + tuple(range(6, v.dim())))
            out[name] = v[ids[:, 0], ids[:, 1], ids[:, 2]].cpu().numpy()
        return out

    def _put_blocks(self, ids: torch.Tensor, fields: dict):
        """Write block fields (numpy [n, 8, 8, 8(, 3)]) at canvas blocks
        ids [n, 3] and mark them present."""
        bx, by, bz = self.g.cb
        for name, t in (("occ_val", self.occ), ("vox_type", self.typ),
                        ("dist_sq", self.dist), ("coc", self.coc)):
            v = t.reshape((bx, VB, by, VB, bz, VB) + t.shape[3:])
            v = v.permute((0, 2, 4, 1, 3, 5) + tuple(range(6, v.dim())))
            v[ids[:, 0], ids[:, 1], ids[:, 2]] = torch.from_numpy(fields[name]).to(t.device)
        self.present[ids[:, 0], ids[:, 1], ids[:, 2]] = True

    def _store(self, store: dict, ids: torch.Tensor, origin):
        f = self._block_fields(ids)
        keys = ids.cpu().numpy() + np.asarray(origin)[None, :]
        for i, key in enumerate(map(tuple, keys.tolist())):
            store[key] = {n: f[n][i] for n in f}

    # -- scroll ------------------------------------------------------------
    def _scroll(self, new_origin):
        g = self.g
        old = self.origin if self.origin is not None else np.zeros(3, np.int64)
        shift = np.asarray(new_origin, np.int64) - old
        d = self.dev
        # outgoing present blocks, in linear block order, into the archive
        out_ax = [((torch.arange(n, device=d) - int(shift[a])) < 0)
                  | ((torch.arange(n, device=d) - int(shift[a])) >= n)
                  for a, n in enumerate(g.cb)]
        exits = (out_ax[0][:, None, None] | out_ax[1][None, :, None]
                 | out_ax[2][None, None, :]) & self.present
        ids = torch.nonzero(exits)            # row-major = linear block order
        if len(ids):
            f = self._block_fields(ids)
            keys = ids.cpu().numpy() + old[None, :]
            for i, key in enumerate(map(tuple, keys.tolist())):
                if key not in self.archive and len(self.archive) >= self.dep["max_blocks"]:
                    self.dropped += 1
                    continue
                self.archive[key] = {n: f[n][i] for n in f}
        # the shift: exposed voxels and blocks take their defaults
        sv = [int(s) * VB for s in shift]
        self.occ = _shifted(self.occ, sv, 0)
        self.typ = _shifted(self.typ, sv, UNKNOWN)
        self.dist = _shifted(self.dist, sv, EMPTY)
        self.coc = _shifted(self.coc, sv, INV)
        self.present = _shifted(self.present, shift, False)
        self.carry = _shifted(self.carry, shift, False)
        # entering blocks restored from the archive
        if self.archive:
            keys = np.asarray(list(self.archive), np.int64)
            rel = keys - np.asarray(new_origin, np.int64)[None, :]
            inside = ((rel >= 0) & (rel < np.asarray(g.cb))).all(1)
            pres = self.present.cpu().numpy()
            sel = [i for i in np.flatnonzero(inside) if not pres[tuple(rel[i])]]
            if sel:
                fields = {n: np.stack([self.archive[tuple(keys[i])][n] for i in sel])
                          for n in ("occ_val", "vox_type", "dist_sq", "coc")}
                self._put_blocks(torch.as_tensor(rel[sel], device=d), fields)
        self.origin = np.asarray(new_origin, np.int64)
        self.scrolls += 1
        return sv

    # -- occupancy low-pass ------------------------------------------------
    def _lowpass(self, old_occ, old_typ, val, alpha):
        dt = torch.bfloat16 if self.low else torch.float32
        prev = torch.where(old_typ != UNKNOWN, old_occ.to(dt), 0.0).to(dt)
        if torch.is_tensor(alpha):
            alpha = alpha.to(dt)
        new = alpha * val + (1.0 - alpha) * prev
        new = torch.clamp(new, OCC_MIN, OCC_MAX).to(torch.uint8)
        typ = torch.where(new > self.dep["occupancy_threshold"], OCCUPIED, FREE)
        return new, typ.to(torch.int8)

    # -- one map cycle -----------------------------------------------------
    def place(self, trans32):
        """Pivot, canvas origin (scrolling when it moves) and window box of
        a frame at sensor position trans32."""
        g = self.g
        pvt = g.pivot(trans32)
        motion = None if self.last_pvt is None else pvt - self.last_pvt
        self.last_pvt = pvt.copy()
        if self.origin is not None and g.fits(pvt, self.origin):
            origin = self.origin.copy()
        else:
            origin = g.place(pvt, motion)
        enter = None
        if self.origin is None or not np.array_equal(self.origin, origin):
            enter = self._scroll(origin)
        off = (pvt.astype(np.int64) - origin * VB).tolist()
        return pvt, origin, enter, off

    def merge(self, inst, ray_count, origin, enter, off):
        """Fuse a window observation (inst_type; with a point cloud its ray
        counts) into the map, then EDT, frontiers, changed blocks, stream."""
        g = self.g
        d = self.dev
        wb = tuple(slice(o, o + n) for o, n in zip(off, g.local))
        old_dist, old_typ_canvas = self.dist, self.typ
        # block allocation
        cov = torch.zeros(g.cs, dtype=torch.bool, device=d)
        cov[wb] = (inst != UNKNOWN) if ray_count is None else (ray_count != 0)
        present = self.present | _blocks_any(cov)
        pres_vox = _expand(present)
        pres_win = pres_vox[wb]
        # occupancy low-pass over the window
        o_occ, o_typ = self.occ[wb], self.typ[wb]
        if ray_count is None:
            hit = inst == OCCUPIED
            miss = (inst == FREE) & ~hit
            occ_h, typ_h = self._lowpass(o_occ, o_typ, OCC_HIT, ALPHA_HIT)
            occ_m, typ_m = self._lowpass(o_occ, o_typ, OCC_MISS, ALPHA_MISS)
        else:
            # a hit weighs 1; a miss by the rays through the voxel, 0.1 each
            hit = ray_count > 0
            miss = (ray_count < 0) & ~hit
            tenth = torch.tensor(float(np.float32(1) / np.float32(10)), device=d)
            pbty = torch.clamp((-ray_count).to(torch.float32) * tenth, max=1.0)
            occ_h, typ_h = self._lowpass(o_occ, o_typ, OCC_HIT, 1.0)
            occ_m, typ_m = self._lowpass(o_occ, o_typ, OCC_MISS, pbty)
        upd = pres_win & (hit | miss)
        n_occ = torch.where(upd, torch.where(hit, occ_h, occ_m), o_occ)
        n_typ = torch.where(upd, torch.where(hit, typ_h, typ_m), o_typ)
        glb_type = torch.where(pres_win, n_typ, UNKNOWN).to(torch.int8)
        occ = self.occ.clone()
        occ[wb] = n_occ
        typ = self.typ.clone()
        typ[wb] = n_typ
        win = torch.zeros(g.cs, dtype=torch.bool, device=d)
        win[wb] = True

        # exact EDT of the canvas, limited-observation rule, take rule
        e = exact_edt(typ == OCCUPIED, sum(g.cs))
        origin_vox = torch.as_tensor(origin * VB, device=d)
        new_d = torch.where(e["valid"], e["dist_sq"], EMPTY)
        new_c = torch.where(e["valid"][..., None], e["coc"] + origin_vox, INV)
        old_valid = self.coc[..., 0] != INV
        rel = self.coc - origin_vox
        cs_t = torch.as_tensor(g.cs, device=d)
        old_in = ((rel >= 0) & (rel < cs_t)).all(-1)
        keep = old_valid & ~old_in & (self.dist < new_d)
        dist_s = torch.where(keep, self.dist, new_d)
        coc_s = torch.where(keep[..., None], self.coc, new_c)
        obs = typ != UNKNOWN
        take = win & obs & pres_vox & (dist_s != EMPTY)
        if not self.dep["fast_mode"]:
            take = take | (obs & ~win)
        dist = torch.where(take, dist_s, self.dist)
        coc = torch.where(take[..., None], coc_s, self.coc)

        # frontiers: FREE window voxels with an UNKNOWN 6-neighbour
        sl = tuple(slice(o - 1, o + n + 1) for o, n in zip(off, g.local))
        unk = typ[sl] == UNKNOWN
        near = torch.zeros(g.local, dtype=torch.bool, device=d)
        X, Y, Z = g.local
        for a in range(3):
            for s in (0, 2):
                idx = [slice(1, X + 1), slice(1, Y + 1), slice(1, Z + 1)]
                idx[a] = slice(s, s + g.local[a])
                near |= unk[tuple(idx)]
        fnt = (glb_type == FREE) & near
        dist_win, coc_win = dist_s[wb], coc_s[wb]
        observed = glb_type != UNKNOWN
        pair_valid = dist_win != EMPTY
        vt_win = torch.where(fnt & observed & pair_valid, FRONTIER, n_typ).to(torch.int8)
        typ[wb] = vt_win

        # changed blocks: distance or type, occupancy in the window,
        # present blocks the canvas move brought in
        ch = _blocks_any((dist != old_dist) | (typ != old_typ_canvas))
        occ_ch = torch.zeros(g.cs, dtype=torch.bool, device=d)
        occ_ch[wb] = n_occ != o_occ
        changed = (ch | _blocks_any(occ_ch)) & present
        if enter is not None:
            entering = torch.zeros(g.cb, dtype=torch.bool, device=d)
            for a in range(3):
                s = enter[a] // VB
                bi = torch.arange(g.cb[a], device=d).reshape(
                    [-1 if i == a else 1 for i in range(3)])
                entering |= (bi >= g.cb[a] - s) if s > 0 else (bi < -s)
            changed = changed | (entering & present)

        self.occ, self.typ, self.dist, self.coc = occ, typ, dist, coc
        self.present = present
        self.origin = origin
        self.frames += 1
        self.last_out = {
            "edt": torch.where(observed, torch.where(
                pair_valid, torch.sqrt(dist_win.double()).float(),
                float(g.max_loc_dist_sq)), 0.0),
            "glb_type": torch.where(fnt, FRONTIER, glb_type).to(torch.int8),
            "dist_sq": torch.where(observed, dist_win, EMPTY),
            "coc": torch.where((observed & (coc_win[..., 0] != INV))[..., None],
                               coc_win, INV),
        }
        if (self.dep["display_glb_edt"] or self.dep["display_glb_ogm"]) and \
                self.frames % self.dep["vis_interval"] == 0:
            self._stream(changed)

    # -- streaming ---------------------------------------------------------
    def _stream(self, changed):
        g = self.g
        bx, by, bz = g.cb
        ncols = bx * by
        want = changed | self.carry
        col = want.any(2).reshape(-1).cpu().numpy()
        cols = np.flatnonzero(col)
        order = cols[np.argsort((cols - self.rot) % ncols, kind="stable")]
        served = order[:g.k_cols]
        self.rot = (self.rot + g.k_cols) % ncols
        sv = torch.zeros(ncols, dtype=torch.bool, device=self.dev)
        sv[torch.as_tensor(served, dtype=torch.long, device=self.dev)] = True
        sv = sv.reshape(bx, by, 1)
        self.carry = want & ~sv
        ids = torch.nonzero(want & sv)
        if len(ids):
            self._store(self.mirror, ids, self.origin)

    # -- results -----------------------------------------------------------
    def canvas(self) -> dict:
        return {"origin_blk": self.origin.copy(), "occ_val": self.occ,
                "vox_type": self.typ, "dist_sq": self.dist, "coc": self.coc,
                "present": self.present}
