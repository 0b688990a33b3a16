"""CPU mirror of streamed voxel blocks (numpy).

A copy of gie_mapping_tpu/runtime/host_mirror.py for the PyTorch port (the
JAX module imports its JAX map state).  Changed blocks are compacted on the
device (map_state.stream_extract) and copied into a host dict keyed by
global block coordinates; mirror blocks hold GLOBAL int32 cocs, converted at
ingest from the device's canvas-relative / block-relative int16 anchors.
A streamed tick's ingest unpacks only the rows it serves (the changed blocks
of valid columns), so its host work follows the blocks that changed, not the
rows handed over.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import numpy as np

from ..map_state import (COC_INVALID16, _dense_to_blocks, _rows3,
                         np_unpack_voxels)
from ..parallel.mesh import Sharded, gather, to_numpy
from ..utils.config import MapConfig
from ..utils.constants import EMPTY_VALUE, VB_WIDTH, VOX_OCCUPIED
from . import profiler

MIRROR_FIELDS = ("occ_val", "vox_type", "dist_sq", "coc")


def _coc_to_global(coc_rel, anchor_vox):
    """int16 relative cocs + int32 anchor -> int32 GLOBAL cocs (the mirror's
    public frame); the COC_INVALID16 sentinel passes through."""
    coc_rel = np.asarray(coc_rel)
    valid = coc_rel[..., :1] != COC_INVALID16
    return np.where(valid, coc_rel.astype(np.int32) + anchor_vox,
                    np.int32(COC_INVALID16))


def _np(t) -> np.ndarray:
    """A device tensor (a sharded field gathered), or an array, as a numpy
    array."""
    if isinstance(t, Sharded):
        return to_numpy(t)
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


def mirror_digest(blocks: dict) -> str:
    """sha256 over a mirror's blocks in sorted key order, every field (name,
    dtype, shape, bytes): two mirrors agree on it iff they are identical."""
    h = hashlib.sha256()
    for key in sorted(blocks):
        h.update(repr(tuple(int(k) for k in key)).encode())
        for name in MIRROR_FIELDS:
            a = np.ascontiguousarray(blocks[key][name])
            h.update(f"{name}|{a.dtype.str}|{a.shape}|".encode())
            h.update(a.tobytes())
    return h.hexdigest()


class HostMirror:
    """Global block dict fed by changed-block streaming."""

    def __init__(self, cfg: MapConfig):
        self.cfg = cfg
        self.blocks: Dict[Tuple[int, int, int], dict] = {}

    def __len__(self):
        return len(self.blocks)

    def digest(self) -> str:
        return mirror_digest(self.blocks)

    def ingest(self, changed_blk, origin_blk, state):
        """Pull the changed canvas blocks of the port's MapState to the
        host and update the mirror (synchronous)."""
        idx = np.argwhere(_np(changed_blk))
        if idx.size == 0:
            return 0
        origin = np.asarray(origin_blk, np.int32)
        fields = {}
        for name in MIRROR_FIELDS:
            # one batched gather of the changed blocks, then one copy
            bv = _dense_to_blocks(gather(getattr(state, name)),
                                  self.cfg.canvas_blocks)
            fields[name] = _np(bv[tuple(idx.T)])
        fields["coc"] = _coc_to_global(fields["coc"], origin[None, :] * 8)
        keys = idx + origin[None, :]
        for i, key in enumerate(map(tuple, keys)):
            self.blocks[key] = {name: fields[name][i] for name in fields}
        return len(keys)

    def ingest_rows(self, col_ids, col_valid, rows, blk_mask, origin_blk):
        """Merge pre-extracted packed block-column rows (stream_extract's
        outputs as numpy; rows uint32 [k * cbz, 512, 3], row k * cbz + j
        holding block j of column k): pure host bookkeeping, the device work
        and the copy happened earlier.  Only the served rows (blk_mask in a
        valid column) are gathered and unpacked."""
        with profiler.span("stream.ingest"):
            cb = self.cfg.canvas_blocks
            cbz = cb[2]
            col_valid = np.asarray(col_valid)
            sel = np.flatnonzero(
                (np.asarray(blk_mask) & col_valid[:, None]).reshape(-1))
            n = len(sel)
            profiler.count("stream.rows", int(col_valid.sum()) * cbz)
            profiler.count("stream.blocks", n)
            with profiler.span("stream.unpack"):
                if n == 0:
                    return 0
                occ, typ, dist, coc = np_unpack_voxels(np.asarray(rows)[sel])
            W = VB_WIDTH
            shp = (n, W, W, W)
            occ, typ, dist = occ.reshape(shp), typ.reshape(shp), dist.reshape(shp)
            origin = np.asarray(origin_blk, np.int32)
            # streamed rows carry canvas-relative cocs
            coc = _coc_to_global(coc.reshape(shp + (3,)), origin * 8)
            col = np.asarray(col_ids)[sel // cbz]
            keys = origin + np.stack([col // cb[1], col % cb[1], sel % cbz], -1)
            for i, key in enumerate(map(tuple, keys.tolist())):
                self.blocks[key] = {"occ_val": occ[i], "vox_type": typ[i],
                                    "dist_sq": dist[i], "coc": coc[i]}
        return n

    def ingest_archive(self, state):
        """Bulk-import every archived block of the port's MapState."""
        n = int(_np(state.n_arch))
        if n == 0:
            return 0
        keys = _np(state.arch_keys)[:n]
        rows = _rows3(_np(state.a_packed)[:n].view(np.uint32))
        occ, typ, dist, coc = np_unpack_voxels(rows)
        W = VB_WIDTH
        shp = (n, W, W, W)
        occ, typ, dist = occ.reshape(shp), typ.reshape(shp), dist.reshape(shp)
        coc = coc.reshape(shp + (3,))
        for i, key in enumerate(map(tuple, keys)):
            self.blocks[key] = {
                "occ_val": occ[i], "vox_type": typ[i], "dist_sq": dist[i],
                # archive rows anchor cocs to their own block origin
                "coc": _coc_to_global(coc[i], keys[i] * 8),
            }
        return n

    # -- consumers ------------------------------------------------------
    def occupied_cloud(self, voxel_width: float):
        """World positions of all occupied voxels in the mirror."""
        pts = []
        for key, blk in self.blocks.items():
            occ = np.argwhere(blk["vox_type"] == VOX_OCCUPIED)
            if occ.size:
                pts.append((np.asarray(key) * 8 + occ) * voxel_width)
        if not pts:
            return np.zeros((0, 3), np.float32)
        return np.concatenate(pts).astype(np.float32)

    def edt_cloud(self, voxel_width: float, z_slice: int | None = None):
        """(position, distance_m) of all voxels with a valid EDT value;
        z_slice (global voxel z) keeps one layer, None the full cloud."""
        pts, dists = [], []
        for key, blk in self.blocks.items():
            if z_slice is not None:
                kz = z_slice - key[2] * 8
                if not (0 <= kz < 8):
                    continue
            valid = np.argwhere(blk["dist_sq"] < EMPTY_VALUE)
            if z_slice is not None and valid.size:
                valid = valid[valid[:, 2] == z_slice - key[2] * 8]
            if valid.size:
                pts.append((np.asarray(key) * 8 + valid) * voxel_width)
                d = blk["dist_sq"][valid[:, 0], valid[:, 1], valid[:, 2]]
                dists.append(np.sqrt(d.astype(np.float64)) * voxel_width)
        if not pts:
            return np.zeros((0, 3), np.float32), np.zeros((0,), np.float32)
        return (
            np.concatenate(pts).astype(np.float32),
            np.concatenate(dists).astype(np.float32),
        )
